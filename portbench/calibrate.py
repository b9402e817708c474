"""Readings that set a cell's limits and rate, on the card. Not run by the
benchmark's own runs.

    python3 portbench/calibrate.py --workload W --seeds 1,2,3 [--control] [--fault F]
        the numbers that decide `correct`, per seed, of the program (with
        fault F planted, if given) against the float32 reference, and with
        --control of the reference computed in TF32 in the program's place.
        Training needs no window; a serving cell runs `--seconds` of its
        closed loop and compares the sampled answers.

One JSON object a line on standard output.
"""
from __future__ import annotations

import argparse
import gc
import json
import os
import sys

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
if ROOT not in sys.path:
    sys.path.insert(0, ROOT)
os.environ.setdefault("USE_FLAX", "0")


def readings(cell, seed, device, fault, control, seconds):
    import contextlib

    import torch

    from portbench.harness.faults import planted
    from portbench.harness.paths import control_answers, make_path
    path = make_path(cell, device, seed)
    with planted(fault) if fault else contextlib.nullcontext():
        path.setup()
        if path.kind == "serve":
            path.window(seconds, False)
    program = path.answers if path.kind == "serve" else path.program
    path.free()
    ref = path.reference("float32")
    row = {"seed": seed, "fault": fault, "program": path.numbers(program, ref)}
    if path.kind == "train":
        row["loss"] = [program["loss"], ref["loss"]]
        leaves = path.leaf_gaps(program, ref)
        row["worst"] = {n: sorted(((v[n], k) for k, v in leaves.items()),
                                  reverse=True)[:6] for n in ("grad", "change")}
    if control:
        if path.kind == "serve":
            ctl = control_answers(path, path.reference("tf32"))
            row["control"] = path.numbers(ctl, path.reference("float32", ctl))
        else:
            ctl = path.reference("tf32")
            row["control"] = path.numbers(ctl, ref)
            row["control_loss"] = ctl["loss"]
    del path
    gc.collect()
    torch.cuda.empty_cache()
    return row


def main() -> int:
    p = argparse.ArgumentParser()
    p.add_argument("--workload", required=True)
    p.add_argument("--seeds", required=True)
    p.add_argument("--fault", default=None)
    p.add_argument("--control", action="store_true")
    p.add_argument("--seconds", type=float, default=4.0)
    a = p.parse_args()
    import torch

    from portbench.harness.cell import Cell
    if not torch.cuda.is_available():
        print("calibrate: no CUDA card", file=sys.stderr)
        return 3
    cell = Cell(a.workload, root=ROOT)
    dev = torch.device("cuda", 0)
    seeds = [int(s) for s in a.seeds.split(",")]
    for s in seeds:
        print(json.dumps(readings(cell, s, dev, a.fault, a.control, a.seconds)),
              flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
