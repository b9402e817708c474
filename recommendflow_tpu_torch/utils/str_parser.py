"""String-DSL parsers for configs and CLIs.

Capability parity with the reference's utils/str_parser.py:9-144 (str2bool,
str2list, str2dict, str2scale, str2dayno day-range DSL, loss-by-name lookup),
re-implemented framework-free (no TF types; tensors are numpy/torch upstream).
"""
from __future__ import annotations

import datetime
import importlib
import os
from typing import Any, Callable, Dict, List, Union


def str2bool(s: str) -> bool:
    return str(s).strip().lower() == "true"


def str2debug(s: str) -> bool:
    return str(s).strip().lower() in ("test", "debug")


def _coerce(trans_type: Union[type, str, Callable], value: str) -> Any:
    """Coerce a string to a python value by name or callable."""
    named: Dict[str, Callable] = {
        "str": str,
        "int": int,
        "float": float,
        "set": lambda x: set(x),
        "list": list,
        "bool": str2bool,
        "dict": lambda x: {
            kv.strip().split("=")[0]: "=".join(kv.strip().split("=")[1:])
            for kv in x.strip().split(";")
        },
    }
    if isinstance(trans_type, str):
        key = trans_type.lower()
        if key not in named:
            raise ValueError(f"unsupported trans_type '{trans_type}'")
        return named[key](value)
    return trans_type(value)


def str2list(s: str, sep: str = ",", trans_type: Union[type, str] = str) -> List[Any]:
    """'a, b,c' -> ['a','b','c']; empty items dropped."""
    return [_coerce(trans_type, i.strip()) for i in str(s).split(sep) if i.strip()]


def str2dict(s: str, trans_type: Union[type, str] = str) -> Dict[str, Any]:
    """'a=1;b=2' -> {'a':'1','b':'2'} (values coerced by trans_type)."""
    out: Dict[str, Any] = {}
    for part in str(s).strip().split(";"):
        if not part.strip():
            continue
        key, value = part.strip().split("=", 1)
        out[key.strip()] = _coerce(trans_type, value.strip())
    return out


def str2scale(s: str) -> Callable[[float], bool]:
    """Interval-constraint parser: '[-0.01, inf)' -> predicate(x).

    Used by the model-promotion gate (reference model_utils.py:27-52 semantics).
    """
    left, right = str(s).strip().split(",")
    left, right = left.strip(), right.strip()
    lsym, rsym = left[0], right[-1]
    lo, hi = float(left[1:]), float(right[:-1])
    if lsym not in "[(" or rsym not in "])":
        raise ValueError(f"bad interval syntax: '{s}'")
    lo_ok = (lambda x: lo <= x) if lsym == "[" else (lambda x: lo < x)
    hi_ok = (lambda x: x <= hi) if rsym == "]" else (lambda x: x < hi)
    return lambda x: lo_ok(x) and hi_ok(x)


def _parse_day(s: str) -> datetime.datetime:
    return datetime.datetime.strptime(s, "%Y%m%d")


def str2dayno(x: str, mode: str = "patten") -> Union[str, List[str]]:
    """Day-range DSL -> list of YYYYMMDD strings or a brace-glob pattern.

    Grammar (parity with reference utils/str_parser.py:70-117):
      - '[20221126~20221128)'  interval, '['/'(' closed/open ends (default closed)
      - '20221128'             single day
      - 'YYYYMMDD+x'/'-x'      x+1 days including the base day
      - 'YYYYMMDD+:x'/'-:x'    x days excluding the base day
    """
    x = str(x).strip()
    if "~" in x:
        left, right = x.split("~")
        lsym = left[0] if left[0] in "[(" else "["
        rsym = right[-1] if right[-1] in "])" else "]"
        lo = _parse_day(left.lstrip("[("))
        hi = _parse_day(right.rstrip("])"))
        days = [(lo + datetime.timedelta(days=i)).strftime("%Y%m%d")
                for i in range((hi - lo).days + 1)]
        if lsym == "(":
            days = days[1:]
        if rsym == ")":
            days = days[:-1]
    elif "+:" in x or "-:" in x:
        op = "+:" if "+:" in x else "-:"
        sign = 1 if op == "+:" else -1
        base, n = x.split(op)
        base, n = _parse_day(base), int(n)
        days = [(base + datetime.timedelta(days=sign * i)).strftime("%Y%m%d")
                for i in range(1, n + 1)]
    elif ("+" in x or "-" in x) and len(x) > 8:
        op = "+" if "+" in x else "-"
        sign = 1 if op == "+" else -1
        base, n = x.split(op)
        base, n = _parse_day(base), int(n)
        days = [(base + datetime.timedelta(days=sign * i)).strftime("%Y%m%d")
                for i in range(n + 1)]
    elif len(x) == 8:
        days = [x]
    else:
        raise ValueError(f"unknown dayno expression '{x}'")

    if not days:
        raise ValueError(f"dayno expression '{x}' resolves to zero days")
    if mode == "list":
        return sorted(days)
    if mode == "patten":
        if len(days) == 1:
            return days[0]     # '20221128{}' is a literal to bash/hadoop
        prefix = os.path.commonprefix(days)
        return prefix + "{" + ",".join(d[len(prefix):] for d in sorted(days)) + "}"
    raise ValueError(f"unknown mode '{mode}'")


def abbreviate(name: str) -> str:
    """'cosent_loss' -> 'cl' — abbreviation alias used by loss-name lookup."""
    return "".join(part[0] for part in name.split("_") if part)


def str2fn(dotted: str, default_module: str = "recommendflow_tpu_torch.losses.match"):
    """Resolve 'pkg.module.fn_name' (or bare 'fn_name'/abbreviation) to a callable.

    Parity with reference str2loss (utils/str_parser.py:124-144): supports full
    dotted paths, bare names resolved against a default module, and
    first-letter abbreviations ('cosent' -> cosent_loss via 'cl'? no —
    abbreviation maps 'bnscl' -> batch_neg_sample_ce_loss). Also accepts the
    reference's legacy 'backend.losses.*'/'backend.lossess.*' prefixes, mapped
    onto our loss modules.
    """
    dotted = str(dotted).strip()
    legacy = {
        "backend.losses.match_losses": "recommendflow_tpu_torch.losses.match",
        "backend.lossess.match_losses": "recommendflow_tpu_torch.losses.match",
        "backend.losses.classify_losses": "recommendflow_tpu_torch.losses.classify",
        "backend.lossess.classify_losses": "recommendflow_tpu_torch.losses.classify",
    }
    if "." in dotted:
        module_name, fn_name = dotted.rsplit(".", 1)
        module_name = legacy.get(module_name, module_name)
        # configs name the reference package's modules: resolve them here
        if module_name.startswith("recommendflow_tpu."):
            module_name = "recommendflow_tpu_torch." + module_name[
                len("recommendflow_tpu."):]
    else:
        module_name, fn_name = default_module, dotted
    module = importlib.import_module(module_name)
    # only callables DEFINED in the module: dir() also lists imported
    # modules/constants ('np', 'MASK', ...) that a config typo could
    # silently resolve to
    public = [n for n in dir(module) if not n.startswith("_")
              and callable(getattr(module, n))
              and getattr(getattr(module, n), "__module__", None)
              == module.__name__]
    abbrevs = {abbreviate(n): n for n in public}
    if callable(getattr(module, fn_name, None)):
        return getattr(module, fn_name)
    if fn_name in abbrevs:
        return getattr(module, abbrevs[fn_name])
    # allow 'cosent' to match 'cosent_loss'
    suffixed = [n for n in public if n == fn_name + "_loss"]
    if suffixed:
        return getattr(module, suffixed[0])
    raise AttributeError(
        f"cannot resolve '{dotted}' in {module_name}; available: {sorted(public)}")


# keep the reference name as an alias
str2loss = str2fn
