"""Small offline data-prep helpers (the counterpart of
`recommendflow_tpu/utils/dataprep.py`).

Host-side conveniences for offline sample-construction scripts, not the
training path: weighted negative sampling, DataFrame split/save helpers,
datetime formatting and text cleanup. pandas and psutil are imported only
inside the functions that take them, and sklearn not at all: the split is
written out, so the module imports in a minimal image.
"""
from __future__ import annotations

import datetime
import random
from typing import Any, Dict, List, Mapping, Optional, Sequence, Tuple, Union

# The reference's literal blacklist (utils/util.py:84), ASCII punctuation +
# full-width CJK punctuation, including the space character.
_ILLEGAL_CHARS = (
    """ !"#$%&'()*+,-./:;<=>?@[\\]^_`{|}~、:，。、【】“”：；（）《》‘’{}？！⑦()、%^>℃：.”“^-——=&#@￥?…！，"""
)
_ILLEGAL_SET = set(_ILLEGAL_CHARS)


def filter_illegal_chars(x: str) -> str:
    """Strip punctuation/whitespace noise from raw text features
    (parity: utils/util.py:83-87; set-membership scan instead of the
    reference's len(blacklist) sequential str.replace passes)."""
    return "".join(c for c in x if c not in _ILLEGAL_SET)


def sample_neg_app(app_neg_weight: Mapping[Any, float],
                   pos_app_list: Sequence[Any],
                   neg_sample_nums: int,
                   seed: Optional[int] = None) -> List[Any]:
    """Weighted offline negative sampling: draw
    ``len(pos_app_list) * neg_sample_nums`` items from the candidate pool,
    weighted by ``app_neg_weight``, excluding the user's own positives
    (parity: utils/util.py:90-101; adds an optional seed for reproducible
    sample construction)."""
    pos_set = set(pos_app_list)
    names: List[Any] = []
    weights: List[float] = []
    for k, v in app_neg_weight.items():
        if k not in pos_set:
            names.append(k)
            weights.append(v)
    if not names:
        raise ValueError("sample_neg_app: every candidate is a positive — "
                         "no negatives to sample from")
    rng = random.Random(seed) if seed is not None else random
    return rng.choices(names, weights=weights,
                       k=len(pos_app_list) * neg_sample_nums)


def get_datetime(add_day: int = 0, fmt: str = "%Y.%m.%d-%H:%M:%S") -> str:
    """Now + ``add_day`` days, formatted (parity: utils/util.py:104-147)."""
    return (datetime.datetime.today()
            + datetime.timedelta(days=add_day)).strftime(fmt)


def get_delta_seconds(start_time: str, end_time: str,
                      fmt: str = "%Y.%m.%d-%H:%M:%S") -> float:
    """Absolute seconds between two formatted timestamps
    (parity: utils/util.py:150-158)."""
    delta = (datetime.datetime.strptime(start_time, fmt)
             - datetime.datetime.strptime(end_time, fmt))
    return abs(delta.total_seconds())


def dump_csv(df, path: str, sep: str = "\t", index: bool = False,
             header: Union[bool, List[str]] = True, show: int = 0) -> None:
    """Save a DataFrame with a row-count/columns summary print
    (parity: utils/util.py:160-168)."""
    df.to_csv(path, index=index, sep=sep, header=header)
    print(f"saved {path}: {len(df)} rows, columns={list(df.columns)}")
    if show > 0:
        print(df.sample(min(show, len(df))))


def save_text(contents: Union[Any, List[Any]], path: str) -> None:
    """Write one item (or each list item) per line
    (parity: utils/util.py:264-281)."""
    if not isinstance(contents, list):
        contents = [contents]
    with open(path, "w") as f:
        for line in contents:
            f.write(str(line) + "\n")
    print(f"text file saved to {path}")


def split_and_shuffle(df, test_size: float,
                      shuffle_mode: Optional[str] = "all",
                      seed: Optional[int] = None) -> Tuple[Any, Any]:
    """Train/valid DataFrame split (parity: utils/util.py:332-348).

    shuffle_mode: ``None``/``""`` = ordered tail split; ``"all"`` = global
    shuffle then split; ``"in_day"`` = per-``dayno`` stratified shuffle+split
    (each day contributes its own tail to valid), so the valid set covers
    every day. Implemented without sklearn: an ordered split takes the last
    ``ceil(n * test_size)`` rows, matching train_test_split's ceil rounding.
    """
    import numpy as np

    def _split(frame, do_shuffle: bool):
        n = len(frame)
        n_test = int(np.ceil(n * test_size)) if 0 < test_size < 1 \
            else int(test_size)
        if do_shuffle:
            order = np.random.RandomState(seed).permutation(n)
            frame = frame.iloc[order]
        return frame.iloc[:n - n_test], frame.iloc[n - n_test:]

    if not shuffle_mode:
        return _split(df, False)
    if shuffle_mode == "all":
        return _split(df, True)
    if shuffle_mode == "in_day":
        if "dayno" not in df.columns:
            raise AssertionError("in_day mode requires a 'dayno' column")
        import pandas as pd
        train_list, test_list = [], []
        for dayno in sorted(df["dayno"].unique()):
            tr, te = _split(df[df["dayno"] == dayno], True)
            train_list.append(tr)
            test_list.append(te)
        return pd.concat(train_list), pd.concat(test_list)
    raise ValueError(f"unsupported shuffle_mode {shuffle_mode!r}")


def df2str(df) -> str:
    """Box-drawing table rendering of a DataFrame (parity:
    utils/util.py:286-325 get_dataframe_line_str/df2str), sharing the box
    renderer in utils/tables.py; floats are shown at 5 decimals and a
    'count' column as ints, as the reference does."""
    from recommendflow_tpu_torch.utils.tables import format_table

    def _cell(col: str, v: Any) -> Any:
        if col == "count":
            return int(v)
        if isinstance(v, float):
            return f"{v:.5f}"
        return v

    cols = list(df.columns)
    rows = []
    # itertuples, not to_dict("index"): the latter raises on duplicate
    # indices (e.g. concat output with overlapping RangeIndexes)
    for tup in df.itertuples(index=True, name=None):
        rows.append([str(tup[0])]
                    + [_cell(c, v) for c, v in zip(cols, tup[1:])])
    return format_table(rows, headers=["INDEX"] + cols)


def mem_percentage() -> str:
    """Host RAM utilisation as a percent string (parity: utils/util.py:
    328-329 ``men_percentage`` [sic]); /proc fallback when psutil is
    absent."""
    try:
        import psutil
        return f"{psutil.virtual_memory().percent:.2f}%"
    except ImportError:
        meminfo: Dict[str, int] = {}
        with open("/proc/meminfo") as f:
            for line in f:
                parts = line.split()
                meminfo[parts[0].rstrip(":")] = int(parts[1])
        used = meminfo["MemTotal"] - meminfo.get("MemAvailable",
                                                 meminfo["MemFree"])
        return f"{100.0 * used / meminfo['MemTotal']:.2f}%"
