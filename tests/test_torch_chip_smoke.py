"""chip_smoke.py's contract where there is no card: it exits non-zero and
prints no result, alone in a directory as well, and its CPU rehearsal drives
every phase at toy sizes through the plain versions."""
import json
import os
import shutil
import subprocess
import sys

import _torch_parity as tp

SCRIPT = os.path.join(tp.ROOT, "chip_smoke.py")


def _run(args, cwd):
    env = dict(os.environ, OMP_NUM_THREADS="1", CUDA_VISIBLE_DEVICES="")
    return subprocess.run([sys.executable, *args], cwd=cwd, env=env,
                          capture_output=True, text=True, timeout=600)


def _has_result(stdout):
    return '"ok": true' in stdout or '"kernels"' in stdout


def test_no_card_no_result(tmp_path):
    r = _run([SCRIPT], tp.ROOT)
    assert r.returncode != 0 and not _has_result(r.stdout)
    lone = tmp_path / "chip_smoke.py"
    shutil.copy(SCRIPT, lone)
    r = _run([str(lone)], str(tmp_path))
    assert r.returncode != 0 and not _has_result(r.stdout)


def test_cpu_rehearsal_drives_every_phase(tmp_path):
    r = _run([SCRIPT, "--cpu-rehearsal"], str(tmp_path))
    assert r.returncode == 3, r.stderr[-3000:]
    assert not _has_result(r.stdout)
    phases = {}
    for line in r.stdout.splitlines():
        if line.startswith('{"phase"'):
            rec = json.loads(line)
            phases[rec["phase"]] = rec
    assert sorted(phases) == ["cli", "kernel1", "kernel2", "slice"]
    assert phases["kernel1"]["bitwise_equal"] is True
    assert max(phases["kernel2"]["max_abs_err"].values()) <= 1e-4
    assert phases["slice"]["top100_score_err"] <= 1e-5
    assert phases["cli"]["predict_vs_model"] <= 1e-5
