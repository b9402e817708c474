"""Where the time of the serving, training and encoder slices goes, on one
card.

    python -m recommendflow_tpu_torch.tools.profile_slice [--batches 64]
        [--train_steps 10] [--encode_batches 16]

At the full width of conf/bench_recall.yaml (random weights from a seed):

  * predict: host batch preparation (synthetic_batch) timed alone; then the
    device path over pre-built batches, under torch.profiler: wall time per
    batch, device-busy time per batch (union of the kernels' intervals),
    the device's idle share, and device time by kernel;
  * search: one 4096-query FlatSearcher(metric="cos") search of the eval
    corpus built from the predicted rows, profiled the same way;
  * train/<mode>: Trainer.train_step over pre-built batches of 1024 for the
    split path with strategy "dense", with "sparse_set", and for
    table_update="dense" (the config's dropout), profiled the same way per
    step, with the host's waits on the card in one step counted by CUDA's
    sync debug mode (file:line of each);
  * encode: BERT-Base (random weights from a seed, written as a HuggingFace
    checkpoint and loaded by TextEncoderService.from_pretrained) encoding
    batches of 256 synthetic texts at max_len 64 through the service's
    batch loop (tokenize, copy, forward, copy back), profiled the same way
    per batch.

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
        # user annotations (e.g. Optimizer.step) span kernels and the gaps
        # between them: they are not device work of their own
        if e.device_type == torch.autograd.DeviceType.CUDA \
                and not getattr(e, "is_user_annotation", False):
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
        if getattr(a, "device_type", None) != torch.autograd.DeviceType.CUDA \
                or getattr(a, "is_user_annotation", False):
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


class LaunchRecorder:
    """Records the arguments of every launch of the port's table-path
    kernels while installed (clones, so a recorded in-place launch can be
    replayed), then times each recorded launch alone."""

    KERNELS = {   # name -> (module attribute of the launch function, symbol)
        "gather_rows": ("embedding_bag", "launch_gather_rows",
                        "gather_rows_kernel"),
        "scatter_add_rows": ("embedding_bag", "launch_scatter_add_rows",
                             "scatter_add_rows_kernel"),
        "rowwise_adagrad_update": ("table_update",
                                   "launch_rowwise_adagrad_update",
                                   "rowwise_adagrad_kernel"),
        "sparse_adagrad_apply": ("sparse_apply", "launch_sparse_adagrad_apply",
                                 "sparse_adagrad_kernel"),
        "flash_attention": ("flash_attention", "launch_flash_attention",
                            "flash_attention_kernel"),
    }

    def __init__(self):
        import importlib
        self.calls = {name: [] for name in self.KERNELS}
        self._saved = []
        for name, (mod, fn, _) in self.KERNELS.items():
            module = importlib.import_module(
                f"recommendflow_tpu_torch.ops.cuda.{mod}")
            orig = getattr(module, fn)
            self._saved.append((module, fn, orig))

            def wrapped(*a, _orig=orig, _name=name, **kw):
                clone = lambda x: x.clone() if isinstance(x, torch.Tensor) else x  # noqa: E731
                self.calls[_name].append(
                    (_orig, [clone(x) for x in a],
                     {k: clone(v) for k, v in kw.items()}))
                return _orig(*a, **kw)
            setattr(module, fn, wrapped)

    def remove(self):
        for module, fn, orig in self._saved:
            setattr(module, fn, orig)

    def alone_ms(self):
        """name -> (symbol, mean ms alone over the recorded launches)."""
        out = {}
        for name, calls in self.calls.items():
            if calls:
                # no id range check (a host read) inside a timed call
                extra = {"check_ids": False} if name == "gather_rows" else {}
                ms = [median_ms(
                    lambda c=c: c[0](*c[1], **{**c[2], **extra}), reps=10)
                    for c in calls]
                out[name] = (self.KERNELS[name][2], sum(ms) / len(ms))
        return out


def count_syncs(fn):
    """Run fn() with CUDA's sync debug mode on: the operations that made the
    host wait for the card, as {first line of torch's warning: count}."""
    import warnings
    with warnings.catch_warnings(record=True) as caught:
        warnings.simplefilter("always")
        torch.cuda.set_sync_debug_mode("warn")
        try:
            fn()
        finally:
            torch.cuda.set_sync_debug_mode("default")
    out = {}
    for w in caught:
        if "synchroniz" in str(w.message):
            key = f"{os.path.basename(w.filename)}:{w.lineno}"
            out[key] = out.get(key, 0) + 1
    return out


def profile_training(model, dev, steps: int, batch: int = 1024,
                     modes=(("split", "dense"), ("split", "sparse_set"),
                            ("dense", "dense"))):
    """Per (table_update, split_strategy) mode: wall and device time per
    step over `steps` steps of `batch` rows under torch.profiler, idle
    share, the port's kernels' launches and device time by kernel. Returns
    the modes' stats."""
    from torch.profiler import ProfilerActivity, profile

    from recommendflow_tpu_torch.data.synthetic import synthetic_batch
    from recommendflow_tpu_torch.ops.cuda import (embedding_bag, sparse_apply,
                                                  table_update)
    from recommendflow_tpu_torch.train.trainer import Trainer
    counters = {"gather_rows": embedding_bag.gather_rows,
                "scatter_add_rows": embedding_bag.scatter_add_rows,
                "rowwise_adagrad_update": table_update.rowwise_adagrad_update,
                "sparse_adagrad_apply": sparse_apply.sparse_adagrad_apply}
    batches = [synthetic_batch(model.schema, batch, seed=50_000 + i)
               for i in range(steps + 2)]
    state, out = None, []
    for mode, strategy in modes:
        trainer = Trainer(model, table_update=mode, split_strategy=strategy,
                          device=dev)
        if state is None:
            state = trainer.init_state(batches[0])
        else:
            trainer.plan(batches[0])
        on_dev = [trainer._put(b) for b in batches]
        trainer.train_step(state, on_dev[0])               # warm-up
        syncs = count_syncs(lambda: trainer.train_step(state, on_dev[0]))
        rec = LaunchRecorder()
        trainer.train_step(state, on_dev[1])               # record one step
        rec.remove()
        alone = rec.alone_ms()
        del rec
        torch.cuda.synchronize()
        torch.cuda.empty_cache()
        torch.cuda.reset_peak_memory_stats()
        for fn in counters.values():
            fn.launches = 0
        with profile(activities=[ProfilerActivity.CPU,
                                 ProfilerActivity.CUDA]) as prof:
            t0 = time.perf_counter()
            for b in on_dev[2:]:
                trainer.train_step(state, b)
            torch.cuda.synchronize()
            wall = time.perf_counter() - t0
        ours = {name: (sym, counters[name].launches, ms)
                for name, (sym, ms) in alone.items()}
        stats = _device_stats(prof, wall, ours)
        stats.update(mode=f"{mode}/{strategy}" if mode == "split" else mode,
                     steps=steps, per_step_wall_ms=wall / steps * 1e3,
                     per_step_device_ms=stats["device_busy_ms"] / steps,
                     launches_per_step={n: counters[n].launches / steps
                                        for n in counters},
                     host_syncs_per_step=syncs,
                     peak_mem_gb=torch.cuda.max_memory_allocated() / 1e9)
        out.append(stats)
        del on_dev
    return out


def profile_encode(service, texts, batches: int):
    """Encode `batches` batches of `texts` through service._encode_raw (the
    path of TextEncoderService.encode below its cache and whitening) under
    torch.profiler: wall and device time per batch, idle share, texts per
    second and device time by kernel. flash_attention's launches the
    profiler missed count at the kernel's time alone on one recorded
    batch's operands."""
    from torch.profiler import ProfilerActivity, profile

    from recommendflow_tpu_torch.ops.cuda import flash_attention as k_fa
    bs = service.batch_size
    chunk = list(texts[:batches * bs])
    service._encode_raw(chunk[:bs])                      # warm-up
    rec = LaunchRecorder()
    service._encode_raw(chunk[:bs])                      # record one batch
    rec.remove()
    alone = rec.alone_ms()
    del rec
    torch.cuda.synchronize()
    k_fa.flash_attention.launches = 0
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        service._encode_raw(chunk)
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
    symbol, ms = alone["flash_attention"]
    stats = _device_stats(prof, wall, {"flash_attention": (
        symbol, k_fa.flash_attention.launches, ms)})
    n_batches = -(-len(chunk) // bs)
    stats.update(batches=n_batches, batch_size=bs,
                 per_batch_wall_ms=wall / n_batches * 1e3,
                 per_batch_device_ms=stats["device_busy_ms"] / n_batches,
                 texts_per_s=len(chunk) / wall,
                 flash_attention_launches_per_batch=(
                     k_fa.flash_attention.launches / n_batches))
    return stats


def profile_encoder(dev, batches: int):
    """One JSON line: profile_encode at BERT-Base width."""
    import tempfile

    from recommendflow_tpu_torch.encoder import TextEncoderService
    from recommendflow_tpu_torch.encoder.synthetic import (BERT_BASE,
                                                           make_texts,
                                                           write_bert_files)
    with tempfile.TemporaryDirectory() as tmp:
        service = TextEncoderService.from_pretrained(
            *write_bert_files(tmp, BERT_BASE, seed=0), max_len=64, device=dev)
    stats = profile_encode(service, make_texts(batches * 256, seed=1), batches)
    print(json.dumps({"part": "encode", **stats}), flush=True)


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description="profile the serving and "
                                 "training slices")
    ap.add_argument("--batches", type=int, default=64)
    ap.add_argument("--train_steps", type=int, default=10)
    ap.add_argument("--corpus_batches", type=int, default=1024,
                    help="batches of 1024 predicted for the eval corpus")
    ap.add_argument("--encode_batches", type=int, default=16,
                    help="batches of 256 texts encoded at BERT-Base width")
    args = ap.parse_args(argv)
    if not torch.cuda.is_available():
        raise SystemExit("profile_slice needs a CUDA device")
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    from torch.profiler import ProfilerActivity, profile

    from recommendflow_tpu_torch.config import Configuration
    from recommendflow_tpu_torch.data.synthetic import synthetic_batch
    from recommendflow_tpu_torch.models.base import build_network
    from recommendflow_tpu_torch.ops.cuda import embedding_bag as k_rows
    from recommendflow_tpu_torch.ops.cuda import grouped_topk as k_scan
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
    # gather_rows alone at this batch's shapes: one launch per dim group
    fused = fused_group_ids(model.schema, {
        k: torch.from_numpy(v).to(dev) for k, v in batches[0].items()})
    tables = model.embedder.tables()
    rows_alone = sum(median_ms(lambda d=d, ids=ids: k_rows.launch_gather_rows(
        tables[f"dim{d}"].view(-1, d), ids.reshape(-1).contiguous(),
        check_ids=False)) for d, ids in fused.items()) / len(fused)
    torch.cuda.synchronize()
    k_rows.gather_rows.launches = 0
    acts = [ProfilerActivity.CPU, ProfilerActivity.CUDA]
    with profile(activities=acts) as prof:
        t0 = time.perf_counter()
        predict(model, batches, dev)
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
    stats = _device_stats(prof, wall, {"gather_rows": (
        "gather_rows_kernel", k_rows.gather_rows.launches, rows_alone)})
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
    scan_alone = median_ms(lambda: k_scan.launch_grouped_score_max(
        q, searcher._vecs, None, group=_GROUP, num_items=searcher.num_items),
        reps=5)
    torch.cuda.synchronize()
    k_scan.grouped_score_max.launches = 0
    with profile(activities=acts) as prof:
        t0 = time.perf_counter()
        searcher.search(qv, topk=100)
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
    stats = _device_stats(prof, wall, {"grouped_score_max": (
        "grouped_score_max_kernel", k_scan.grouped_score_max.launches, scan_alone)})
    stats.update(corpus_items=searcher.num_items,
                 n_pad=int(searcher._vecs.shape[0]), queries=len(qv))
    print(json.dumps({"part": "search", **stats}), flush=True)
    del searcher, out, corpus
    torch.cuda.empty_cache()
    for stats in profile_training(model, dev, args.train_steps):
        print(json.dumps({"part": f"train/{stats['mode']}", **stats}),
              flush=True)
    del model
    torch.cuda.empty_cache()
    profile_encoder(dev, args.encode_batches)
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
