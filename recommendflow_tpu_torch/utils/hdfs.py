"""HDFS shell wrappers with retries (the counterpart of
`recommendflow_tpu/utils/hdfs.py`).

Every operation shells out to the `hadoop fs` CLI; a missing binary raises
a clear `HdfsError`, so local-filesystem workflows are never blocked. A
failed call is retried up to 3 times with a backoff of 1 s, then 2 s.
"""
from __future__ import annotations

import os
import subprocess
import tempfile
import time
from typing import List, Optional

from recommendflow_tpu_torch.utils.logger import get_logger

log = get_logger("recflow.hdfs")
RETRIES = 3


class HdfsError(RuntimeError):
    pass


def _run(args: List[str], retries: int = RETRIES) -> str:
    cmd = ["hadoop", "fs"] + args
    last = None
    for attempt in range(retries):
        try:
            out = subprocess.run(cmd, capture_output=True, text=True,
                                 timeout=300)
            if out.returncode == 0:
                return out.stdout
            last = out.stderr.strip()
        except FileNotFoundError as e:
            raise HdfsError(
                "hadoop CLI not found — HDFS paths need a hadoop client on "
                "PATH (utils/env_util.py parity: source your hadoop env first)"
            ) from e
        except subprocess.TimeoutExpired:
            last = "timeout"
        log.warning("hdfs %s failed (attempt %d/%d): %s",
                    " ".join(args[:2]), attempt + 1, retries, last)
        if attempt + 1 < retries:        # no dead sleep after the LAST try
            time.sleep(2 ** attempt)
    raise HdfsError(f"hadoop fs {' '.join(args)} failed after {retries} tries: {last}")


def ls(path: str) -> List[str]:
    out = _run(["-ls", path])
    paths = []
    for line in out.splitlines():
        parts = line.split()
        if len(parts) >= 8 and parts[-1].startswith(("hdfs://", "/")):
            paths.append(parts[-1])
    return paths


def exists(path: str) -> bool:
    try:
        _run(["-test", "-e", path], retries=1)
        return True
    except HdfsError:
        return False


def get(src: str, dst: str):
    os.makedirs(os.path.dirname(os.path.abspath(dst)) or ".", exist_ok=True)
    _run(["-get", "-f", src, dst])


def put(src: str, dst: str):
    _run(["-put", "-f", src, dst])


def mkdir(path: str):
    _run(["-mkdir", "-p", path])


def rm(path: str, recursive: bool = False):
    _run(["-rm", "-r", path] if recursive else ["-rm", path])


def cp(src: str, dst: str):
    _run(["-cp", "-f", src, dst])


def touch(path: str):
    _run(["-touchz", path])


def stage_local(pattern: str, cache_dir: Optional[str] = None) -> List[str]:
    """Download HDFS files matching a pattern into a dated local cache and
    return local paths (read_csv cache parity: utils/util.py:210-261). The
    cache defaults to `recflow_hdfs_cache` under the temporary root
    (TMPDIR)."""
    if cache_dir is None:
        cache_dir = os.path.join(tempfile.gettempdir(), "recflow_hdfs_cache")
    if not pattern.startswith("hdfs://"):
        raise ValueError("stage_local expects an hdfs:// pattern")
    files = ls(pattern)
    day = time.strftime("%Y%m%d")
    out = []
    for f in files:
        # flattening '/' to '_' would collide a/b_c with a_b/c — key by a
        # content-free digest of the full path plus the basename for
        # readability
        import hashlib
        digest = hashlib.md5(f.encode("utf-8")).hexdigest()[:12]
        key = f"{digest}_{os.path.basename(f)}"
        local = os.path.join(cache_dir, day, key)
        if not os.path.exists(local):
            get(f, local)
        out.append(local)
    return out
