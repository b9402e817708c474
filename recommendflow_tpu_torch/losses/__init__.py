"""Loss functions: the matching (in-batch negative sampling) family in
`match.py`, classification in `classify.py`, regression in `regression.py`
and the sample-weighted variants in `weighted.py`. Configs name them by
dotted path (utils/str_parser.py:str2fn)."""
