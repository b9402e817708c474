"""Where the time of the serving slice goes, on one card.

    python -m recommendflow_tpu_torch.tools.profile_slice [--batches 64]

At the full width of conf/bench_recall.yaml (random weights from a seed):

  * predict: host batch preparation (synthetic_batch) timed alone; then the
    device path over pre-built batches, under torch.profiler: wall time per
    batch, device-busy time per batch (union of the kernels' intervals),
    the device's idle share, and device time by kernel;
  * search: one 4096-query FlatSearcher(metric="cos") search of the eval
    corpus built from the predicted rows, profiled the same way.

The profiler lists only some launches of the port's own kernels (they
come from a ctypes library with its own CUDA runtime, which the profiler
does not fully trace). Each launch it missed (the wrapper's launch count minus
the launches it listed) is counted at the kernel's median time alone on
the same shapes (CUDA events, calls queued behind a sleep so host overhead
stays out); one stream runs everything, so nothing overlaps.

Prints one JSON line per part. Needs a card.
"""
from __future__ import annotations

import argparse
import json
import os
import time

import numpy as np
import torch

ROOT = os.path.dirname(os.path.dirname(os.path.dirname(os.path.abspath(__file__))))


def median_ms(fn, reps: int = 20) -> float:
    """Median device time of fn() alone, from CUDA events."""
    fn()
    torch.cuda.synchronize()
    ev = [torch.cuda.Event(enable_timing=True) for _ in range(reps + 1)]
    torch.cuda._sleep(200_000_000)
    ev[0].record()
    for i in range(reps):
        fn()
        ev[i + 1].record()
    torch.cuda.synchronize()
    return sorted(ev[i].elapsed_time(ev[i + 1]) for i in range(reps))[reps // 2]


def _device_stats(prof, wall_s: float, ours, top: int = 12):
    """Busy time (union of the profiled device intervals, plus the time
    alone of each launch of the port's kernels the profiler missed;
    `ours` = {name: (kernel symbol, launches, ms alone)}), idle share and
    the top device-time entries by name."""
    spans, names = [], []
    for e in prof.events():
        if e.device_type == torch.autograd.DeviceType.CUDA:
            spans.append((e.time_range.start, e.time_range.end))
            names.append(e.name)
    spans.sort()
    busy_us, cur_s, cur_e = 0.0, None, None
    for s, e in spans:
        if cur_e is None or s > cur_e:
            if cur_e is not None:
                busy_us += cur_e - cur_s
            cur_s, cur_e = s, e
        else:
            cur_e = max(cur_e, e)
    if cur_e is not None:
        busy_us += cur_e - cur_s
    by_name, missed = [], {}
    for name, (symbol, launches, alone_ms) in ours.items():
        seen = sum(symbol in n for n in names)
        n_missed = max(launches - seen, 0)
        missed[name] = {"launches": launches, "listed": seen,
                        "ms_alone": alone_ms}
        busy_us += n_missed * alone_ms * 1e3
        by_name.append((name + " (all launches x time alone)",
                        launches * alone_ms, launches))
    for a in prof.key_averages():
        if getattr(a, "device_type", None) != torch.autograd.DeviceType.CUDA:
            continue               # host ops: their kernels are listed apart
        if any(symbol in a.key for symbol, _, _ in ours.values()):
            continue               # listed above from the launch count
        t = getattr(a, "self_device_time_total", None)
        if t is None:
            t = getattr(a, "self_cuda_time_total", 0.0)
        if t > 0:
            by_name.append((a.key[:80], t / 1e3, a.count))
    by_name.sort(key=lambda x: -x[1])
    return {"wall_ms": wall_s * 1e3, "device_busy_ms": busy_us / 1e3,
            "idle_share": 1.0 - busy_us / 1e3 / (wall_s * 1e3),
            "device_events": len(spans), "port_kernels": missed,
            "top_ms": [{"name": n, "ms": t, "calls": c}
                       for n, t, c in by_name[:top]]}


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description="profile the serving slice")
    ap.add_argument("--batches", type=int, default=64)
    ap.add_argument("--corpus_batches", type=int, default=1024,
                    help="batches of 1024 predicted for the eval corpus")
    args = ap.parse_args(argv)
    if not torch.cuda.is_available():
        raise SystemExit("profile_slice needs a CUDA device")
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    from torch.profiler import ProfilerActivity, profile

    from recommendflow_tpu_torch.config import Configuration
    from recommendflow_tpu_torch.data.synthetic import synthetic_batch
    from recommendflow_tpu_torch.models.base import build_network
    from recommendflow_tpu_torch.ops.cuda import embedding_bag as k1
    from recommendflow_tpu_torch.ops.cuda import grouped_topk as k2
    from recommendflow_tpu_torch.ops.embedding import fused_group_ids
    from recommendflow_tpu_torch.retrieval._kernels import _GROUP
    from recommendflow_tpu_torch.retrieval.eval import build_eval_corpus
    from recommendflow_tpu_torch.retrieval.flat import FlatSearcher
    from recommendflow_tpu_torch.train.trainer import predict

    dev = torch.device("cuda:0")
    conf = Configuration(os.path.join(ROOT, "conf", "bench_recall.yaml"))
    model, _ = build_network(conf.networks["class"],
                             {"conf": conf, "device": dev, "seed": 0})
    t0 = time.perf_counter()
    batches = [synthetic_batch(model.schema, 1024, seed=i)
               for i in range(args.batches)]
    host_batch_ms = (time.perf_counter() - t0) / args.batches * 1e3
    predict(model, batches[:4], dev)                  # warm-up
    # kernel 1 alone at this batch's shapes: one launch per dim group
    fused = fused_group_ids(model.schema, {
        k: torch.from_numpy(v).to(dev) for k, v in batches[0].items()})
    tables = model.embedder.tables()
    k1_alone = sum(median_ms(lambda d=d, ids=ids: k1.launch_gather_rows(
        tables[f"dim{d}"].view(-1, d), ids.reshape(-1).contiguous(),
        check_ids=False)) for d, ids in fused.items()) / len(fused)
    torch.cuda.synchronize()
    k1.gather_rows.launches = 0
    acts = [ProfilerActivity.CPU, ProfilerActivity.CUDA]
    with profile(activities=acts) as prof:
        t0 = time.perf_counter()
        predict(model, batches, dev)
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
    stats = _device_stats(prof, wall, {"gather_rows": (
        "gather_rows_kernel", k1.gather_rows.launches, k1_alone)})
    stats.update(per_batch_wall_ms=wall / args.batches * 1e3,
                 per_batch_device_ms=stats["device_busy_ms"] / args.batches)
    print(json.dumps({"part": "predict", "card": torch.cuda.get_device_name(0),
                      "host_batch_ms": host_batch_ms, **stats}), flush=True)

    out = predict(model, (synthetic_batch(model.schema, 1024, seed=i)
                          for i in range(args.corpus_batches)), dev)
    corpus, labels, pos = build_eval_corpus(out["user"], out["ad"], out["label"])
    qv = np.ascontiguousarray(out["user"][pos][:4096])
    searcher = FlatSearcher(128, metric="cos", device=dev).train(corpus)
    searcher.search(qv, topk=100)                     # warm-up
    q = torch.nn.functional.normalize(torch.from_numpy(qv).to(dev), dim=1)
    k2_alone = median_ms(lambda: k2.launch_grouped_score_max(
        q, searcher._vecs, None, group=_GROUP, num_items=searcher.num_items),
        reps=5)
    torch.cuda.synchronize()
    k2.grouped_score_max.launches = 0
    with profile(activities=acts) as prof:
        t0 = time.perf_counter()
        searcher.search(qv, topk=100)
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
    stats = _device_stats(prof, wall, {"grouped_score_max": (
        "grouped_score_max_kernel", k2.grouped_score_max.launches, k2_alone)})
    stats.update(corpus_items=searcher.num_items,
                 n_pad=int(searcher._vecs.shape[0]), queries=len(qv))
    print(json.dumps({"part": "search", **stats}), flush=True)
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
