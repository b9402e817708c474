"""The benchmark of recommendflow_tpu_torch on NVIDIA cards.

    python3 portbench/run.py --workload <cell> --seed <n> --seconds <s> --trace <0|1>

Run from the root of a checkout. The cell, its configuration, traffic,
limits and metrics are found by name from BENCHMARK.json and the files
under portbench/. Prints the checks on standard error and, as the last line
of standard output, one JSON object: correct, attempted, failed, metrics
(--trace 0: the cell's end-to-end metrics; --trace 1: its per-layer
metrics), device, breakdown (--trace 1), power_limit and checks.

A cell on several cards (its `chips`), or one whose configuration says
`shard_tables`, runs on a mesh: this process is rank 0 and starts ranks
1..N-1 as its children with the same arguments, one process a card over
NCCL (`portbench/harness/ranks.py`); only rank 0 prints. A rank that fails
ends every rank, and rank 0 exits 1 with no result.

Exits 3, printing no result, without a card or with fewer cards than the
cell asks for; 4 if JAX or the JAX package was loaded (by any rank); 5 if
the program (recommendflow_tpu_torch) is not in the checkout; any other
failure raises (exit 1).
"""
from __future__ import annotations

import time

STARTED = time.monotonic()

import argparse  # noqa: E402
import os  # noqa: E402
import sys  # noqa: E402

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
if ROOT not in sys.path:
    sys.path.insert(0, ROOT)
# keep libraries from loading JAX on their own, and every compiler cache of
# the run inside the checkout, at fixed paths
os.environ.setdefault("USE_FLAX", "0")
os.environ.setdefault("USE_JAX", "0")
_CACHE = os.path.join(ROOT, "portbench", ".cache")
os.environ.setdefault("TRITON_CACHE_DIR", os.path.join(_CACHE, "triton"))
os.environ.setdefault("TORCHINDUCTOR_CACHE_DIR", os.path.join(_CACHE, "inductor"))


def parse(argv=None) -> argparse.Namespace:
    p = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    p.add_argument("--workload", required=True)
    p.add_argument("--seed", type=int, required=True)
    p.add_argument("--seconds", type=float, required=True)
    p.add_argument("--trace", type=int, choices=(0, 1), default=0)
    return p.parse_args(argv)


def main(argv=None) -> int:
    args = parse(argv)
    try:
        import recommendflow_tpu_torch as program
    except ImportError as e:
        print(f"portbench: the program is not in this checkout ({e})", file=sys.stderr)
        return 5
    if not os.path.abspath(program.__file__).startswith(ROOT + os.sep):
        print(f"portbench: the program at {program.__file__} is not this "
              f"checkout's", file=sys.stderr)
        return 5
    import torch
    from portbench.harness.cell import Cell
    cell = Cell(args.workload, root=ROOT)
    if not torch.cuda.is_available() or torch.cuda.device_count() < cell.chips:
        print(f"portbench: {args.workload} needs {cell.chips} CUDA card(s); "
              f"found {torch.cuda.device_count() if torch.cuda.is_available() else 0}",
              file=sys.stderr)
        return 3
    from portbench.harness.run_cell import launch
    return launch(cell, args.seed, args.seconds, bool(args.trace), STARTED,
                  [sys.executable, os.path.abspath(__file__)] +
                  list(sys.argv[1:] if argv is None else argv))


if __name__ == "__main__":
    sys.exit(main())
