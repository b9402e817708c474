"""Loss functions: the matching (in-batch negative sampling) family in
`match.py`. Configs name them by dotted path (utils/str_parser.py:str2fn)."""
