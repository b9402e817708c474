"""A training cell on a mesh, in memory, run as `run.py` runs a cell
(`run_cell.launch`: rank 0 starts the other ranks with this command and
its arguments), with the look for a card left out:

    python3 -m portbench.tests.rank_cell --workload dcn_criteo-train_zipf \\
        --chips 2 --seed 7 --seconds 1 [--trace 1] [--small 1] \\
        [--device cpu] [--fault half_batch] [--fail-rank 1 [--fail-at window]] \
        [--share-tables 1] [--keep-dropout 1]

`--small 1` cuts the cell to `small.mesh_cell`'s sizes; `--device cpu`
runs the ranks on the CPU over gloo. `--fault` plants one of
`harness/faults.py`'s faults in every rank; `--fail-rank k` makes rank k
raise in set-up, or with `--fail-at window` kill itself (SIGKILL) as its
window opens. `--share-tables 1` has the configuration's module build
each table that the ranks shard at one rank's share of its rows, as a
module for tables too large for one card would. The model runs without
dropout (`small.mesh_cell`); `--keep-dropout 1` keeps the configuration's.
Run from the root of a checkout.
"""
from __future__ import annotations

import time

STARTED = time.monotonic()

import argparse  # noqa: E402
import contextlib  # noqa: E402
import os  # noqa: E402
import signal  # noqa: E402
import sys  # noqa: E402


def parse(argv):
    p = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    p.add_argument("--workload", default="dcn_criteo-train_zipf")
    p.add_argument("--chips", type=int, required=True)
    p.add_argument("--seed", type=int, required=True)
    p.add_argument("--seconds", type=float, required=True)
    p.add_argument("--trace", type=int, choices=(0, 1), default=0)
    p.add_argument("--small", type=int, choices=(0, 1), default=1)
    p.add_argument("--shard-tables", type=int, choices=(0, 1), default=1)
    p.add_argument("--device", choices=("cpu", "cuda"), default="cpu")
    p.add_argument("--fault", default=None)
    p.add_argument("--fail-rank", type=int, default=None)
    p.add_argument("--fail-at", choices=("setup", "window"), default="setup")
    p.add_argument("--share-tables", type=int, choices=(0, 1), default=0)
    p.add_argument("--keep-dropout", type=int, choices=(0, 1), default=0)
    return p.parse_args(argv)


def main(argv=None) -> int:
    argv = list(sys.argv[1:] if argv is None else argv)
    args = parse(argv)
    import torch
    from portbench.harness import ranks
    from portbench.harness.faults import planted
    from portbench.harness.paths import MeshFitPath
    from portbench.harness.run_cell import launch
    from portbench.tests.small import mesh_cell
    if args.device == "cpu":
        torch.set_num_threads(1)
    cell = mesh_cell(args.workload, args.chips, bool(args.shard_tables),
                     bool(args.small), dropout=None if args.keep_dropout else 0.0)
    mine = ranks.from_env()
    if args.share_tables:
        build = cell.config_module.build_model

        def build_shares(config, device, seed):
            """Each table of 8192 stored rows or more that the ranks divide
            (the program's rule) at one rank's share of its rows."""
            model = build(config, device, seed)
            for name, p in model.named_parameters():
                if "table_dim" in name and p.shape[0] >= 8192 \
                        and p.shape[0] % args.chips == 0:
                    p.data = p.data[:p.shape[0] // args.chips].clone()
            return model
        cell.config_module.build_model = build_shares
    if args.fail_rank is not None and (mine["rank"] if mine else 0) == args.fail_rank:
        if args.fail_at == "setup":
            def fail(self):
                raise RuntimeError(f"rank {args.fail_rank} fails in set-up, as asked")
            MeshFitPath.setup = fail
        else:
            def die(self, seconds, trace):
                print(f"rank {args.fail_rank} is killed in its window, as asked",
                      file=sys.stderr, flush=True)
                os.kill(os.getpid(), signal.SIGKILL)
            MeshFitPath.window = die
    fault = planted(args.fault) if args.fault else contextlib.nullcontext()
    with fault:
        return launch(cell, args.seed, args.seconds, bool(args.trace), STARTED,
                      [sys.executable, "-m", "portbench.tests.rank_cell"] + argv,
                      device_type=args.device)


if __name__ == "__main__":
    sys.exit(main())
