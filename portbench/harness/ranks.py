"""A cell on a mesh: one process per card ("rank"), one process group.

A cell runs on a mesh where its `chips` is over 1, or where its
configuration says `shard_tables` (a world of one: the mesh path on one
card). Then:

  * `start`: rank 0, the process that `run.py` runs in, makes a fresh
    rendezvous directory and starts ranks 1..N-1 as its children: the same
    command with the same arguments, the rank in their environment
    (`PORTBENCH_RANK`, `PORTBENCH_WORLD`, `PORTBENCH_INIT`). Their standard
    output goes to rank 0's standard error: only rank 0 prints a result;
  * `Children`: rank 0 polls its children. One that exits other than 0
    before rank 0 has their numbers ends the run at once: the others are
    killed and rank 0 exits 1 with no result (`os._exit`: its main thread
    may be waiting in a collective). A child that finds rank 0 gone exits;
  * `Group`: each rank joins the group through the program's own
    `init_distributed` (NCCL on cards, each rank on `cuda:{rank}`; gloo on
    the CPU) with a short timeout, makes its mesh with `make_mesh`, and
    opens a host-side gloo group beside it for the harness's own
    agreements: where the window closes, the barrier before it and the
    numbers after it. No rank waits in NCCL for a rank that has stopped.
"""
from __future__ import annotations

import datetime
import os
import shutil
import subprocess
import sys
import tempfile
import threading
import time
from typing import Any, Dict, List, Mapping, Optional, Sequence

import torch

ENV_RANK, ENV_WORLD, ENV_INIT = "PORTBENCH_RANK", "PORTBENCH_WORLD", "PORTBENCH_INIT"
# a collective that waits longer than this ends the run (set-up's longest
# wait between ranks is a kernel build, tens of seconds in a first run)
GROUP_TIMEOUT_S = 180.0
POLL_S = 0.1


def on_mesh(cell) -> bool:
    return cell.chips > 1 or "shard_tables" in cell.config


class Children:
    """Ranks 1..N-1 started by rank 0 (module docstring)."""

    def __init__(self, procs: Sequence[subprocess.Popen], rendezvous: str,
                 log=lambda s: print(s, file=sys.stderr, flush=True)):
        self.procs = list(procs)
        self.rendezvous = rendezvous
        self.log = log
        self.armed = True
        self._done = threading.Event()
        self._thread = threading.Thread(target=self._watch, daemon=True)
        self._thread.start()

    def _watch(self) -> None:
        while not self._done.wait(POLL_S):
            if not self.armed:
                continue
            for k, p in enumerate(self.procs, start=1):
                rc = p.poll()
                if rc is not None and rc != 0 and self.armed:
                    self.log(f"portbench: rank {k} exited with {rc}; "
                             f"ending the run")
                    self.kill()
                    os._exit(1)

    def disarm(self) -> None:
        """Rank 0 has every rank's numbers: the children exit on their own."""
        self.armed = False

    def join(self, timeout: float = 60.0) -> List[Optional[int]]:
        """Each child's exit code, after waiting up to `timeout` seconds for
        all of them; one still running is killed (and reads None)."""
        end = time.monotonic() + timeout
        codes: List[Optional[int]] = []
        for p in self.procs:
            try:
                codes.append(p.wait(max(end - time.monotonic(), 0.0)))
            except subprocess.TimeoutExpired:
                codes.append(None)
        self.stop()
        return codes

    def kill(self) -> None:
        for p in self.procs:
            if p.poll() is None:
                p.kill()
        for p in self.procs:
            p.wait()
        shutil.rmtree(self.rendezvous, ignore_errors=True)

    def stop(self) -> None:
        """Stop watching, end every child still running and wait for it."""
        self._done.set()
        self.armed = False
        self.kill()


def start(world: int, command: Sequence[str],
          log=lambda s: print(s, file=sys.stderr, flush=True)
          ) -> tuple:
    """Rank 0: (init method, Children) for ranks 1..world-1 of `command`."""
    rendezvous = tempfile.mkdtemp(prefix="portbench_ranks_")
    init = "file://" + os.path.join(rendezvous, "store")
    procs = []
    for k in range(1, world):
        env = dict(os.environ, **{ENV_RANK: str(k), ENV_WORLD: str(world),
                                  ENV_INIT: init})
        procs.append(subprocess.Popen(list(command), env=env,
                                      stdout=sys.stderr.fileno(),
                                      stdin=subprocess.DEVNULL))
    return init, Children(procs, rendezvous, log)


def from_env() -> Optional[Dict[str, Any]]:
    """A child rank's {rank, world, init}, or None in rank 0."""
    if ENV_RANK not in os.environ:
        return None
    return {"rank": int(os.environ[ENV_RANK]),
            "world": int(os.environ[ENV_WORLD]), "init": os.environ[ENV_INIT]}


def watch_parent() -> None:
    """A child: exit as soon as rank 0 is gone."""
    parent = os.getppid()

    def poll():
        while True:
            time.sleep(POLL_S * 5)
            if os.getppid() != parent:
                os._exit(1)
    threading.Thread(target=poll, daemon=True).start()


class Group:
    """This rank's membership: `rank`, `world`, its `device`, the program's
    `mesh` and the harness's host-side gloo group (module docstring)."""

    def __init__(self, rank: int, world: int, init: str, device_type: str):
        import torch.distributed as dist
        from recommendflow_tpu_torch.parallel.distributed import init_distributed
        from recommendflow_tpu_torch.parallel.mesh import make_mesh
        self.rank, self.world = int(rank), int(world)
        want = f"cuda:{self.rank}" if device_type == "cuda" else "cpu"
        self.device = init_distributed(self.rank, self.world, init, device=want,
                                       timeout_s=GROUP_TIMEOUT_S)
        self.mesh = make_mesh()
        self.host = dist.new_group(
            backend="gloo", timeout=datetime.timedelta(seconds=GROUP_TIMEOUT_S))

    def agree(self, flag: bool) -> bool:
        """Rank 0's `flag`, on every rank."""
        import torch.distributed as dist
        t = torch.tensor([1 if flag else 0], dtype=torch.int64)
        dist.broadcast(t, 0, group=self.host)
        return bool(t.item())

    def barrier(self) -> None:
        import torch.distributed as dist
        dist.barrier(group=self.host)

    def gather(self, obj: Mapping) -> Optional[List[Mapping]]:
        """Every rank's `obj` in rank order, on rank 0 (None elsewhere)."""
        import torch.distributed as dist
        out = [None] * self.world if self.rank == 0 else None
        dist.gather_object(obj, out, dst=0, group=self.host)
        return out

    def close(self) -> None:
        import torch.distributed as dist
        if dist.is_initialized():
            dist.destroy_process_group()
