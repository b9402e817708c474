"""The port's host tools against their JAX counterparts on the CPU, module by
module: version.py, config/json_config.py, cli/make_records.py (byte-equal
record files), cli/show_records.py (equal stdout), utils/dataprep.py
(tests/test_dataprep.py case by case, both packages given the same inputs
and seeds) and utils/hdfs.py (the `hadoop fs` calls stubbed: no cluster,
no network)."""
import csv
import glob
import json
import os
import subprocess

import numpy as np
import pandas as pd
import pytest

import _torch_parity as tp

from recommendflow_tpu.utils import dataprep as jprep
from recommendflow_tpu.utils import hdfs as jhdfs
from recommendflow_tpu_torch.utils import dataprep as tprep
from recommendflow_tpu_torch.utils import hdfs as thdfs


def test_version_matches():
    import recommendflow_tpu
    import recommendflow_tpu_torch
    from recommendflow_tpu.version import __version__ as jv
    from recommendflow_tpu_torch.version import __version__ as tv
    assert tv == jv == "0.1.0"
    assert recommendflow_tpu_torch.__version__ == recommendflow_tpu.__version__


# ------------------------------------------------------------- json config
CONF_JSON = {
    "lr": 0.1, "#lr_old": 0.5,
    "nested": {"a": 1, "#b": 2, "deep": {"#x": 3, "y": [4, {"#z": 5, "w": 6}]}},
    "list": [{"#gone": 1, "kept": 2}, [{"#in": 0, "out": 1}]],
    "#section": {"never": "seen"}, "name": "demo",
}


def test_json_config_loads_as_jax(tmp_path, capsys):
    from recommendflow_tpu.config import json_config as jjc
    from recommendflow_tpu_torch.config import json_config as tjc
    path = tmp_path / "c.json"
    path.write_text(json.dumps(CONF_JSON))
    got, want = tjc.load_config(str(path)), jjc.load_config(str(path))
    assert got == want == {
        "lr": 0.1, "nested": {"a": 1, "deep": {"y": [4, {"w": 6}]}},
        "list": [{"kept": 2}, [{"out": 1}]], "name": "demo"}
    assert tjc._strip_deleted(CONF_JSON) == jjc._strip_deleted(CONF_JSON)
    jjc.print_conf(want, title="Demo")
    jout = capsys.readouterr().out
    tjc.print_conf(got, title="Demo")
    assert capsys.readouterr().out == jout and "nested.deep.y" in jout


def test_json_config_reexports_the_ports_loaders(tmp_path):
    from recommendflow_tpu.config import json_config as jjc
    from recommendflow_tpu_torch.config import json_config as tjc
    from recommendflow_tpu_torch.config.features import load_slot_map
    from recommendflow_tpu_torch.encoder.tokenizer import load_vocab
    assert tjc.load_slot_map is load_slot_map and tjc.load_vocab is load_vocab
    vocab = tmp_path / "vocab.txt"
    vocab.write_text("[PAD]\n[UNK]\nhello\nworld\n")
    assert tjc.load_vocab(str(vocab)) == jjc.load_vocab(str(vocab))
    slots = tmp_path / "slots.txt"
    slots.write_text("# name:type:slot\nuser_id:StringType:1\n"
                     "item_id:LongType:2\nctr:DoubleType:7\n")
    assert tjc.load_slot_map(str(slots)) == jjc.load_slot_map(str(slots))


# ------------------------------------------------------- the records CLIs
def _files(d):
    return sorted(glob.glob(os.path.join(str(d), "*.rfb")))


def _same_bytes(a_dir, b_dir):
    a, b = _files(a_dir), _files(b_dir)
    assert [os.path.basename(p) for p in a] == \
        [os.path.basename(p) for p in b] and a
    for x, y in zip(a, b):
        assert open(x, "rb").read() == open(y, "rb").read(), x


@pytest.mark.parametrize("form", ["flag", "positional"])
def test_make_records_synthetic_writes_the_same_bytes(form, tmp_path, capsys):
    from recommendflow_tpu.cli import make_records as jcli
    from recommendflow_tpu_torch.cli import make_records as tcli

    def args(out):
        tail = ["--out", str(out)] if form == "flag" else [str(out)]
        return [tp.DEMO_CONF, *tail, "--synthetic", "300", "--num_files",
                "3", "--seed", "4"]
    jcli.main(args(tmp_path / "out_j"))
    jout = capsys.readouterr().out
    tcli.main(args(tmp_path / "out_t"))
    tout = capsys.readouterr().out
    _same_bytes(tmp_path / "out_j", tmp_path / "out_t")
    assert tout.replace("out_t", "out_j") == jout and "rows" in jout


def _write_csvs(conf_path, d, rows=40):
    from recommendflow_tpu_torch.config import Configuration
    from recommendflow_tpu_torch.data.writer import columns_for
    names = [c.name for c in columns_for(Configuration(conf_path))]
    rng = np.random.RandomState(2)
    os.makedirs(d)
    for part in range(2):
        with open(os.path.join(d, f"part{part}.csv"), "w", newline="") as f:
            w = csv.DictWriter(f, fieldnames=names)
            w.writeheader()
            for _ in range(rows):
                w.writerow({n: str(rng.randint(0, 50)) for n in names})
    return os.path.join(d, "*.csv")


@pytest.mark.parametrize("conf", [tp.DEMO_CONF,
                                  f"{tp.ROOT}/conf/demo_ranking.yaml"],
                         ids=["demo_recall", "demo_ranking"])
def test_make_records_csv_writes_the_same_bytes(conf, tmp_path, capsys):
    from recommendflow_tpu.cli import make_records as jcli
    from recommendflow_tpu_torch.cli import make_records as tcli
    src = _write_csvs(conf, str(tmp_path / "csv"))
    jcli.main([conf, src, str(tmp_path / "out_j"), "--num_procs", "1"])
    jout = capsys.readouterr().out
    tcli.main([conf, src, str(tmp_path / "out_t"), "--num_procs", "1"])
    tout = capsys.readouterr().out
    _same_bytes(tmp_path / "out_j", tmp_path / "out_t")
    assert tout.replace("out_t", "out_j") == jout


def test_make_records_refuses_as_jax(tmp_path, capsys):
    from recommendflow_tpu.cli import make_records as jcli
    from recommendflow_tpu_torch.cli import make_records as tcli
    for argv in ([tp.DEMO_CONF, "--synthetic", "10"], [tp.DEMO_CONF]):
        for cli in (jcli, tcli):
            with pytest.raises(SystemExit) as e:
                cli.main(argv)
            assert e.value.code == 2
        err = capsys.readouterr().err
        assert err.count("output directory required") == 2


@pytest.mark.parametrize("conf,rows,bs", [
    (tp.DEMO_CONF, "4", "8"), (f"{tp.ROOT}/conf/demo_ranking.yaml", "2", "5"),
    (f"{tp.ROOT}/conf/demo_text_recall.yaml", "3", "4")],
    ids=["demo_recall", "demo_ranking", "demo_text_recall"])
def test_show_records_prints_as_jax(conf, rows, bs, tmp_path, capsys,
                                    monkeypatch):
    from recommendflow_tpu.cli import show_records as jcli
    from recommendflow_tpu_torch.cli import show_records as tcli
    from recommendflow_tpu_torch.config import Configuration
    from recommendflow_tpu_torch.data.synthetic import generate_records
    monkeypatch.chdir(tp.ROOT)          # text_recall names its vocab from here
    generate_records(Configuration(conf), str(tmp_path / "r"), num_rows=30,
                     num_files=2, seed=1)
    argv = [conf, str(tmp_path / "r"), "--rows", rows, "--batch_size", bs]
    jcli.main(argv)
    jout = capsys.readouterr().out
    tcli.main(argv)
    assert capsys.readouterr().out == jout and "Encoded batch" in jout
    for cli in (jcli, tcli):
        with pytest.raises(SystemExit, match="no record files"):
            cli.main([conf, str(tmp_path / "none" / "*.rfb")])


# ---------------------------------------------------------------- dataprep
def test_filter_illegal_chars_matches():
    for s in ("a b,c。d！e", "纯中文保留", "", "x—y…z￥", "  tab\tkept"):
        assert tprep.filter_illegal_chars(s) == jprep.filter_illegal_chars(s)
    assert tprep._ILLEGAL_CHARS == jprep._ILLEGAL_CHARS


@pytest.mark.parametrize("seed", [0, 7, 123])
def test_sample_neg_app_draws_as_jax(seed):
    weights = {"a": 1.0, "b": 1.0, "c": 1000.0, "pos": 5.0, 3: 2.0}
    got = tprep.sample_neg_app(weights, ["pos", "pos2"], 3, seed=seed)
    assert got == jprep.sample_neg_app(weights, ["pos", "pos2"], 3, seed=seed)
    assert len(got) == 6 and "pos" not in got


def test_sample_neg_app_all_positive_raises_as_jax():
    for mod in (jprep, tprep):
        with pytest.raises(ValueError, match="every candidate"):
            mod.sample_neg_app({"a": 1.0}, ["a"], 2)


def test_datetime_helpers_match():
    for add in (0, 1, -3):
        assert tprep.get_datetime(add, "%Y%m%d") == \
            jprep.get_datetime(add, "%Y%m%d")
    for a, b in (("2026.01.01-00:00:10", "2026.01.01-00:00:00"),
                 ("2026.01.01-00:00:00", "2026.01.01-00:01:00")):
        assert tprep.get_delta_seconds(a, b) == jprep.get_delta_seconds(a, b)
    assert tprep.get_delta_seconds("20260101", "20260103", fmt="%Y%m%d") == \
        jprep.get_delta_seconds("20260101", "20260103", fmt="%Y%m%d")


def test_dump_csv_and_save_text_match(tmp_path, capsys):
    df = pd.DataFrame({"x": [1, 2, 3], "y": ["a", "b", "c"]})
    for mod in (jprep, tprep):
        d = tmp_path / mod.__name__.split(".")[0]
        d.mkdir()
        mod.dump_csv(df, str(d / "out.csv"), show=0)
        mod.save_text(["l1", 2], str(d / "a.txt"))
        mod.save_text("solo", str(d / "b.txt"))
    out = capsys.readouterr().out
    for name in ("out.csv", "a.txt", "b.txt"):
        assert (tmp_path / "recommendflow_tpu" / name).read_bytes() == \
            (tmp_path / "recommendflow_tpu_torch" / name).read_bytes()
    lines = out.replace("recommendflow_tpu_torch", "recommendflow_tpu")
    lines = lines.splitlines()
    assert lines[:3] == lines[3:] and "3 rows" in lines[0]


@pytest.mark.parametrize("mode,size,seed", [
    (None, 0.2, 0), ("", 7, None), ("all", 0.2, 0), ("all", 0.35, 5),
    ("in_day", 0.2, 0), ("in_day", 0.1, 3)])
def test_split_and_shuffle_matches(mode, size, seed):
    df = pd.DataFrame({"v": np.arange(100),
                       "dayno": [20260101] * 50 + [20260102] * 50})
    (jt, jv), (tt, tv) = (jprep.split_and_shuffle(df, size, mode, seed),
                          tprep.split_and_shuffle(df, size, mode, seed))
    pd.testing.assert_frame_equal(tt, jt)
    pd.testing.assert_frame_equal(tv, jv)


def test_split_and_shuffle_refuses_as_jax():
    df = pd.DataFrame({"v": np.arange(10), "dayno": [1] * 10})
    for mod in (jprep, tprep):
        with pytest.raises(ValueError, match="bogus"):
            mod.split_and_shuffle(df, 0.2, shuffle_mode="bogus")
        with pytest.raises(AssertionError, match="dayno"):
            mod.split_and_shuffle(df.drop(columns=["dayno"]), 0.2,
                                  shuffle_mode="in_day")


@pytest.mark.parametrize("frame", ["counts", "duplicate_index", "mixed"])
def test_df2str_matches(frame):
    if frame == "counts":
        df = pd.DataFrame({"count": [3.0, 5.0], "score": [0.123456, 1.0]},
                          index=["q1", "q2"])
    elif frame == "duplicate_index":
        a = pd.DataFrame({"x": [1.0, 2.0]})
        df = pd.concat([a, a])
    else:
        df = pd.DataFrame({"name": ["a", "bb"], "n": [1, 2],
                           "f": [0.5, 2.25]})
    assert tprep.df2str(df) == jprep.df2str(df)


def test_mem_percentage_both_ways(monkeypatch):
    """psutil's reading where psutil imports, /proc/meminfo where it does
    not: the same string from both packages each way."""
    import builtins
    import io
    fake = "MemTotal: 1000 kB\nMemFree: 100 kB\nMemAvailable: 400 kB\n"
    real_open, real_import = builtins.open, builtins.__import__

    def fake_open(path, *a, **k):
        if path == "/proc/meminfo":
            return io.StringIO(fake)
        return real_open(path, *a, **k)

    def no_psutil(name, *a, **k):
        if name == "psutil":
            raise ImportError("no psutil")
        return real_import(name, *a, **k)
    monkeypatch.setattr(builtins, "open", fake_open)
    monkeypatch.setattr(builtins, "__import__", no_psutil)
    assert tprep.mem_percentage() == jprep.mem_percentage() == "60.00%"


# -------------------------------------------------------------------- hdfs
class _Hadoop:
    """A scripted `hadoop fs`: each call takes the next outcome (rc,
    stdout, stderr), or raises what the outcome names."""

    def __init__(self, outcomes):
        self.outcomes, self.calls, self.sleeps = list(outcomes), [], []

    def run(self, cmd, capture_output, text, timeout):
        self.calls.append((list(cmd), capture_output, text, timeout))
        out = self.outcomes.pop(0)
        if out == "missing":
            raise FileNotFoundError("hadoop")
        if out == "timeout":
            raise subprocess.TimeoutExpired(cmd, timeout)
        rc, stdout, stderr = out
        return subprocess.CompletedProcess(cmd, rc, stdout, stderr)


def _both(monkeypatch, outcomes, call):
    """call(module) under a scripted hadoop for each package: [(result or
    the error's type and text, the calls, the sleeps)]."""
    seen = []
    for mod in (jhdfs, thdfs):
        h = _Hadoop(outcomes)
        monkeypatch.setattr(mod.subprocess, "run", h.run)
        monkeypatch.setattr(mod.time, "sleep", h.sleeps.append)
        try:
            res = call(mod)
        except Exception as e:        # noqa: BLE001
            res = (type(e).__name__, str(e))
        seen.append((res, h.calls, h.sleeps))
        monkeypatch.undo()
    return seen


LS = ("Found 2 items\n"
      "-rw-r--r--   3 u g  10 2026-01-01 00:00 hdfs://nn/data/a.csv\n"
      "drwxr-xr-x   - u g   0 2026-01-01 00:00 /data/sub\n"
      "bad line\n")
SCRIPTS = {
    "ls": ([(0, LS, "")], lambda m: m.ls("hdfs://nn/data")),
    "ls_retried": ([(1, "", "busy"), "timeout", (0, LS, "")],
                   lambda m: m.ls("/data")),
    "ls_fails": ([(1, "", "e1"), (1, "", "e2"), (1, "", "e3")],
                 lambda m: m.ls("/data")),
    "missing_cli": (["missing"], lambda m: m.put("a", "b")),
    "exists": ([(0, "", "")], lambda m: m.exists("/x")),
    "not_exists": ([(1, "", "no")], lambda m: m.exists("/x")),
    "mkdir": ([(0, "", "")], lambda m: m.mkdir("/d")),
    "rm": ([(0, "", "")], lambda m: m.rm("/d/f")),
    "rm_r": ([(0, "", "")], lambda m: m.rm("/d", recursive=True)),
    "cp": ([(0, "", "")], lambda m: m.cp("/a", "/b")),
    "touch": ([(0, "", "")], lambda m: m.touch("/t")),
    "put": ([(0, "", "")], lambda m: m.put("local.txt", "/remote")),
}


@pytest.mark.parametrize("name", list(SCRIPTS))
def test_hdfs_calls_and_retries_match(name, monkeypatch):
    outcomes, call = SCRIPTS[name]
    (jres, jcalls, jsleeps), (tres, tcalls, tsleeps) = _both(
        monkeypatch, outcomes, call)
    assert tres == jres and tcalls == jcalls and tsleeps == jsleeps
    assert all(c[0][:2] == ["hadoop", "fs"] for c in tcalls)
    if name == "ls_fails":
        assert tres[0] == "HdfsError" and len(tcalls) == 3
        assert tsleeps == [1, 2]
    if name == "missing_cli":
        assert tres[0] == "HdfsError"


def test_hdfs_get_makes_the_directory(monkeypatch, tmp_path):
    dst = tmp_path / "{}" / "sub" / "f.csv"
    seen = []
    for mod, tag in ((jhdfs, "jax"), (thdfs, "port")):
        h = _Hadoop([(0, "", "")])
        monkeypatch.setattr(mod.subprocess, "run", h.run)
        mod.get("hdfs://nn/f.csv", str(dst).format(tag))
        assert os.path.isdir(os.path.dirname(str(dst).format(tag)))
        seen.append([c[0][:4] for c in h.calls])
        monkeypatch.undo()
    assert seen[0] == seen[1] == [["hadoop", "fs", "-get", "-f"]]


def test_stage_local_caches_as_jax(monkeypatch, tmp_path):
    """The same cache paths (day directory, digest of the full path plus
    the basename); a file already cached is not fetched again."""
    ls = ("-rw-r--r--   3 u g 10 2026-01-01 00:00 hdfs://nn/a/b_c.csv\n"
          "-rw-r--r--   3 u g 10 2026-01-01 00:00 hdfs://nn/a_b/c.csv\n")
    got = []
    for mod, tag in ((jhdfs, "jax"), (thdfs, "port")):
        cache = str(tmp_path / tag)
        fetched = []
        monkeypatch.setattr(mod.time, "strftime", lambda fmt: "20260101")
        monkeypatch.setattr(mod, "ls", lambda pattern: [
            line.split()[-1] for line in ls.splitlines()])

        def get(src, dst, fetched=fetched):
            fetched.append(src)
            os.makedirs(os.path.dirname(dst), exist_ok=True)
            open(dst, "w").close()
        monkeypatch.setattr(mod, "get", get)
        first = mod.stage_local("hdfs://nn/*", cache_dir=cache)
        again = mod.stage_local("hdfs://nn/*", cache_dir=cache)
        assert first == again and len(fetched) == 2
        got.append([os.path.relpath(p, cache) for p in first])
        with pytest.raises(ValueError, match="hdfs://"):
            mod.stage_local("/local/*", cache_dir=cache)
        monkeypatch.undo()
    assert got[0] == got[1] and len(set(got[0])) == 2
    assert all(p.startswith("20260101" + os.sep) for p in got[0])


def test_stage_local_caches_under_the_temporary_root(monkeypatch, tmp_path):
    """Without a cache_dir the port's cache lies under TMPDIR, so two
    checkouts with their own temporary roots share no cache."""
    monkeypatch.setattr(thdfs.tempfile, "tempdir", str(tmp_path))
    monkeypatch.setattr(thdfs.time, "strftime", lambda fmt: "20260101")
    monkeypatch.setattr(thdfs, "ls", lambda pattern: ["hdfs://nn/a.csv"])
    monkeypatch.setattr(thdfs, "get", lambda src, dst: None)
    (got,) = thdfs.stage_local("hdfs://nn/*")
    assert got.startswith(os.path.join(str(tmp_path), "recflow_hdfs_cache",
                                       "20260101") + os.sep)
