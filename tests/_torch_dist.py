"""A pool of CPU worker processes joined in one gloo process group, for the
port's multi-process tests (the JAX references run in the pytest process).

`Pool(world, tmp_dir)` spawns `world` processes once (a spawn costs a few
seconds: a test module keeps one pool per world size); each joins the group
through `file://` under `tmp_dir`, so concurrent pools never share a port.
`pool.run(fn, *args)` calls the module-level function `fn(rank, world,
*args)` in every worker and returns the results in rank order. Every wait
has a timeout: a worker that raised, or a collective that one rank skipped,
ends the pool (its processes are killed) and raises here, so a hang costs
one test its timeout, never the suite; the next `run` starts a fresh pool.
"""
import multiprocessing as mp
import os
import queue
import traceback

TIMEOUT_S = 120


def _worker(rank, world, init_file, tasks, results):
    import torch
    torch.set_num_threads(1)
    from recommendflow_tpu_torch.parallel.distributed import init_distributed
    init_distributed(rank, world, "file://" + init_file, device="cpu",
                     timeout_s=TIMEOUT_S)
    while True:
        task = tasks.get()
        if task is None:
            break
        fn, args = task
        try:
            results.put((rank, "ok", fn(rank, world, *args)))
        except BaseException:                     # noqa: BLE001
            results.put((rank, "error", traceback.format_exc()))
    import torch.distributed as dist
    dist.destroy_process_group()


class Pool:
    def __init__(self, world, tmp_dir):
        self.world, self.tmp_dir, self.starts = world, str(tmp_dir), 0
        self._start()

    def _start(self):
        world = self.world
        ctx = mp.get_context("spawn")
        self.results = ctx.Queue()
        self.tasks = [ctx.Queue() for _ in range(world)]
        init_file = os.path.join(self.tmp_dir, f"init_{world}_{self.starts}")
        self.starts += 1
        self.procs = [ctx.Process(target=_worker, daemon=True, args=(
            r, world, init_file, self.tasks[r], self.results))
            for r in range(world)]
        for p in self.procs:
            p.start()
        self.alive = True

    def run(self, fn, *args, timeout=TIMEOUT_S):
        if not self.alive:
            self._start()
        for q in self.tasks:
            q.put((fn, args))
        out = [None] * self.world
        errors = []
        for _ in range(self.world):
            try:
                rank, status, value = self.results.get(timeout=timeout)
            except queue.Empty:
                self.close(kill=True)
                raise TimeoutError(f"{fn.__name__}: a worker did not answer "
                                   f"within {timeout} s") from None
            if status == "error":
                errors.append(f"rank {rank}:\n{value}")
            out[rank] = value
        if errors:
            self.close(kill=True)
            raise RuntimeError("\n".join(errors))
        return out

    def close(self, kill=False):
        if not self.alive:
            return
        self.alive = False
        if not kill:
            for q in self.tasks:
                q.put(None)
            for p in self.procs:
                p.join(timeout=20)
        for p in self.procs:
            if p.is_alive():
                p.kill()
                p.join(timeout=5)


def make_pool(request, tmp_path_factory, world):
    """A module-scoped pool (use from a fixture)."""
    pool = Pool(world, tmp_path_factory.mktemp(f"gloo{world}"))
    request.addfinalizer(pool.close)
    return pool

