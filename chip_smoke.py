#!/usr/bin/env python3
"""Smoke test of recommendflow_tpu_torch on one NVIDIA card.

    python3 chip_smoke.py            # all phases, one card

Phases, each printing one JSON line; any failure exits non-zero:

  1. build     nvcc-builds every kernel of csrc/ (one process per source,
               started together) and reports build time and ptxas usage;
  2. kernel1   gather_rows against its plain version on the bench_recall
               dim-64 table (770 MB bf16) at one batch's 87,040 ids: bitwise;
  3. kernel2   grouped_score_max against its plain version at Q = 4096,
               N_pad = 1,048,576, D = 128: f32 ip, bf16 corpus, f32 l2;
               max abs diff <= 1e-4 (f32 sums in another order);
  4. slice     Dssm at the full width of conf/bench_recall.yaml (random
               weights from a seed): predict 1,048,576 synthetic rows at batch
               1024, build the eval corpus, search 4096 user vectors with
               FlatSearcher(metric="cos") at topk [10, 100]; the top-100 must
               agree with a plain matmul + topk (scores within 1e-5, indices
               equal except among scores within 1e-5); both kernels' launch
               counts over this run must be > 0;
  5. cli       cli/evaluate and cli/predict on a few thousand
               conf/demo_recall.yaml records written by the port, the second
               with weights carried through an interop .npz;
  6. times     median of >= 20 CUDA-event timings of each kernel, its plain
               version and one PyTorch library call, at the phase-2/3 shapes,
               beside the least time the card could take.

Then the kernels' JSON line, the card's name and power limit, and the last
line {"ok": true, "device": {...}}. With no CUDA device it exits non-zero and
prints no result. `--cpu-rehearsal` runs every phase at toy sizes on the CPU
through the plain versions (no times, no result, exit code 3).
"""
from __future__ import annotations

import argparse
import json
import math
import os
import subprocess
import sys
import tempfile
import time

ROOT = os.path.dirname(os.path.abspath(__file__))
BENCH_CONF = os.path.join(ROOT, "conf", "bench_recall.yaml")
DEMO_CONF = os.path.join(ROOT, "conf", "demo_recall.yaml")
PHASES = ("build", "kernel1", "kernel2", "slice", "cli", "times")

# published peaks (NVIDIA data sheets, dense, at the full power limit):
# memory bytes/s and FP32 flop/s outside the tensor cores
PEAKS = {"PCIe": (2.0e12, 51.2e12), "NVL": (3.9e12, 60.0e12),
         "SXM": (3.35e12, 67.0e12)}

KERNEL_META = {
    "gather_rows": dict(
        route="cuda", source="recommendflow_tpu_torch/csrc/embedding_bag.cu",
        replaces="recommendflow_tpu/ops/pallas/embedding_bag.py:112"),
    "grouped_score_max": dict(
        route="cuda", source="recommendflow_tpu_torch/csrc/grouped_topk.cu",
        replaces="recommendflow_tpu/ops/pallas/grouped_topk.py:67"),
}


def emit(obj) -> None:
    print(json.dumps(obj), flush=True)


def require(cond: bool, msg: str) -> None:
    if not cond:
        raise RuntimeError(msg)


def card_peaks(name: str):
    for key in ("PCIe", "NVL"):
        if key in name:
            return PEAKS[key]
    return PEAKS["SXM"]


def nvidia_smi() -> str:
    return subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        check=True, capture_output=True, text=True, timeout=60
    ).stdout.strip().splitlines()[0]


class Timer:
    """Device time of single calls from CUDA events. The calls are queued
    behind a sleep kernel, so host launch overhead does not enter the
    measured gaps."""

    def __init__(self, torch, reps: int):
        self.torch, self.reps = torch, reps

    def median_ms(self, fn) -> float:
        torch = self.torch
        fn(0)                                   # warm-up (and lazy load)
        torch.cuda.synchronize()
        ev = [torch.cuda.Event(enable_timing=True) for _ in range(self.reps + 1)]
        torch.cuda._sleep(200_000_000)
        ev[0].record()
        for i in range(self.reps):
            fn(i)
            ev[i + 1].record()
        torch.cuda.synchronize()
        t = sorted(ev[i].elapsed_time(ev[i + 1]) for i in range(self.reps))
        return t[len(t) // 2]


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--phases", default=",".join(PHASES),
                    help=f"comma list of {PHASES} (default: all)")
    ap.add_argument("--cpu-rehearsal", action="store_true",
                    help="toy sizes on the CPU through the plain versions")
    args = ap.parse_args(argv)
    phases = [p for p in args.phases.split(",") if p]
    require(all(p in PHASES for p in phases), f"unknown phase in {phases}")
    rehearse = args.cpu_rehearsal

    import numpy as np
    import torch

    if not rehearse and not torch.cuda.is_available():
        print("chip_smoke: no CUDA device visible", file=sys.stderr)
        return 2
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False

    from recommendflow_tpu_torch.config import Configuration
    from recommendflow_tpu_torch.data.schema import compile_schema
    from recommendflow_tpu_torch.data.synthetic import (generate_records,
                                                        synthetic_batch)
    from recommendflow_tpu_torch.interop import (jax_from_variables,
                                                 save_variables_npz)
    from recommendflow_tpu_torch.models.base import build_network
    from recommendflow_tpu_torch.ops.cuda import KERNELS, _build
    from recommendflow_tpu_torch.ops.cuda import embedding_bag as k1
    from recommendflow_tpu_torch.ops.cuda import grouped_topk as k2
    from recommendflow_tpu_torch.ops.embedding import fused_group_ids
    from recommendflow_tpu_torch.retrieval.eval import (
        batch_compute_recall_score, build_eval_corpus)
    from recommendflow_tpu_torch.retrieval.flat import FlatSearcher
    from recommendflow_tpu_torch.train.trainer import predict

    dev = torch.device("cpu" if rehearse else "cuda:0")
    # toy sizes for the rehearsal; full sizes on the card
    S = dict(batch=1024, n_batches=1024, q=4096, n_pad=1 << 20, d=128,
             search_q=4096, cli_rows=4000, reps=20) if not rehearse else \
        dict(batch=64, n_batches=8, q=64, n_pad=1 << 13, d=128, search_q=64,
             cli_rows=400, reps=2)
    sync = torch.cuda.synchronize if not rehearse else (lambda: None)
    card = nvidia_smi() if not rehearse else "cpu rehearsal"
    kind = torch.cuda.get_device_name(0) if not rehearse else "cpu"
    bw, flops = card_peaks(kind)
    gen = torch.Generator(device=dev).manual_seed(0)
    t_start = time.perf_counter()

    def log(phase, **kw):
        emit({"phase": phase, **kw, "t": round(time.perf_counter() - t_start, 3)})

    # ---------------------------------------------------------- 1. build
    if "build" in phases and not rehearse:
        t0 = time.perf_counter()
        secs = _build.build(KERNELS)
        ptxas = {n: [ln.strip() for ln in _build.BUILD_LOGS.get(n, "").splitlines()
                     if "Used" in ln or "spill" in ln] for n in KERNELS}
        log("build", wall_s=time.perf_counter() - t0, per_kernel_s=secs,
            ptxas=ptxas)

    # ------------------------------------------------- shared inputs (2, 6)
    bench_conf = Configuration(BENCH_CONF)
    schema = compile_schema(bench_conf.features)
    group64 = schema.groups[64]
    rows64 = group64.total_rows if not rehearse else 4096
    rows64 = -(-rows64 // 1024) * 1024
    table64 = torch.randn((rows64, 64), generator=gen, device=dev
                          ).to(torch.bfloat16)

    def ids_for(seed):
        b = synthetic_batch(schema, S["batch"], seed=seed)
        ids = fused_group_ids(schema, {k: torch.from_numpy(v) for k, v in
                                       b.items()})[64].reshape(-1)
        return (ids % rows64).to(torch.int32).to(dev)

    k1_err = None
    if "kernel1" in phases or "times" in phases:
        ids0 = ids_for(10_000)
        got = k1.gather_rows(table64, ids0)
        ref = k1.gather_rows_plain(table64, ids0)
        sync()
        same = bool(torch.equal(got.view(torch.int16), ref.view(torch.int16)))
        require(same, "kernel1: gather_rows differs from its plain version")
        k1_err = float((got.float() - ref.float()).abs().max())
        log("kernel1", table_mb=table64.numel() * 2 / 1e6, ids=ids0.numel(),
            bitwise_equal=same, max_abs_err=k1_err)

    # ------------------------------------------------------------- 2/3 k2
    q = torch.nn.functional.normalize(
        torch.randn((S["q"], S["d"]), generator=gen, device=dev), dim=1)
    corpus = torch.nn.functional.normalize(
        torch.randn((S["n_pad"], S["d"]), generator=gen, device=dev), dim=1)
    num_items = S["n_pad"] - 1000          # a masked, partial tail group
    G = 16
    k2_err = None
    if "kernel2" in phases or "times" in phases:
        scale = torch.rand((S["n_pad"], 1), generator=gen, device=dev) + 0.5
        variants = {
            "f32_ip": (corpus, None),
            "bf16_ip": (corpus.to(torch.bfloat16), None),
            "f32_l2": (corpus * scale, ((corpus * scale) ** 2).sum(1)),
        }
        errs = {}
        for name, (v, sqn) in variants.items():
            got = k2.grouped_score_max(q, v, sqn, group=G, num_items=num_items)
            ref = k2.grouped_score_max_plain(q, v, sqn, group=G,
                                             num_items=num_items)
            sync()
            require(tuple(got.shape) == (S["q"], S["n_pad"] // G),
                    f"kernel2 {name}: shape {tuple(got.shape)}")
            errs[name] = float((got - ref).abs().max())
            require(errs[name] <= 1e-4, f"kernel2 {name}: max abs diff "
                    f"{errs[name]} > 1e-4")
            del got, ref
        del variants, scale
        k2_err = max(errs.values())
        log("kernel2", q=S["q"], n_pad=S["n_pad"], d=S["d"], group=G,
            num_items=num_items, max_abs_err=errs, tolerance=1e-4)

    # ----------------------------------------------------------- 4. slice
    launches = {"gather_rows": 0, "grouped_score_max": 0}
    if "slice" in phases:
        model, _ = build_network(bench_conf.networks["class"],
                                 {"conf": bench_conf, "device": dev, "seed": 0})
        k1.gather_rows.launches = 0
        k2.grouped_score_max.launches = 0
        sync()
        t0 = time.perf_counter()
        out = predict(model, (synthetic_batch(model.schema, S["batch"], seed=i)
                              for i in range(S["n_batches"])), dev)
        sync()
        predict_s = time.perf_counter() - t0
        n_rows = S["batch"] * S["n_batches"]
        require(out["user"].shape == (n_rows, 128) and out["ad"].shape ==
                (n_rows, 128), f"predict shapes {out['user'].shape}")
        require(bool(np.isfinite(out["user"]).all() and
                     np.isfinite(out["ad"]).all()), "non-finite embeddings")
        norms = np.linalg.norm(out["user"], axis=1)
        require(bool(np.allclose(norms, 1.0, atol=1e-4)), "user vectors not unit")
        t0 = time.perf_counter()
        corpus_np, labels, pos = build_eval_corpus(out["user"], out["ad"],
                                                   out["label"])
        corpus_s = time.perf_counter() - t0
        qv = out["user"][pos][:S["search_q"]]
        lab = labels[:S["search_q"]]
        searcher = FlatSearcher(128, metric="cos", device=dev).train(corpus_np)
        n_pad = int(searcher._vecs.shape[0])
        sync()
        t0 = time.perf_counter()
        metrics = batch_compute_recall_score(searcher, qv, lab, [10, 100])
        sync()
        first_search_s = time.perf_counter() - t0
        launches = {"gather_rows": k1.gather_rows.launches,
                    "grouped_score_max": k2.grouped_score_max.launches}
        require(all(v > 0 for v in launches.values()) or rehearse,
                f"a kernel was not launched on the main path: {launches}")
        require(all(math.isfinite(v) for v in metrics.values()),
                f"non-finite metrics {metrics}")
        # the top-100 against a plain exact search
        _, s_got, i_got = searcher.search(qv, topk=100)
        qn = torch.nn.functional.normalize(torch.from_numpy(qv).to(dev), dim=1)
        cn = searcher._vecs[:searcher.num_items]
        exact = qn @ cn.T
        s_ref, i_ref = torch.topk(exact, 100, dim=1)
        s_ref, i_ref = s_ref.cpu().numpy(), i_ref.cpu().numpy()
        s_of_got = torch.gather(exact, 1, torch.from_numpy(i_got).to(dev)
                                ).cpu().numpy()
        del exact
        score_err = float(np.abs(s_got - s_ref).max())
        tie_err = float(np.abs(s_of_got - s_ref).max())
        idx_match = float((i_got == i_ref).mean())
        require(score_err <= 1e-5, f"top-100 scores differ by {score_err}")
        require(tie_err <= 1e-5, f"top-100 indices differ beyond ties "
                f"({tie_err})")
        require(all(len(set(r)) == 100 for r in i_got), "duplicate indices")
        searcher_times = []
        for _ in range(3):
            sync()
            t0 = time.perf_counter()
            searcher.search(qv, topk=100)
            sync()
            searcher_times.append(time.perf_counter() - t0)
        log("slice", rows=n_rows, batch=S["batch"],
            predict_ms_per_batch=predict_s / S["n_batches"] * 1e3,
            eval_corpus_s=corpus_s, corpus_items=searcher.num_items,
            n_pad=n_pad, queries=len(qv),
            first_search_s=first_search_s,
            search_ms_per_4096=sorted(searcher_times)[1] * 1e3
            * 4096 / len(qv), metrics=metrics, top100_score_err=score_err,
            top100_tie_err=tie_err, top100_index_match=idx_match,
            launches=launches, peak_mem_gb=(torch.cuda.max_memory_allocated()
                                            / 1e9 if not rehearse else None))
        del out, model, searcher, cn, qn
        if not rehearse:
            torch.cuda.empty_cache()

    # ------------------------------------------------------------- 5. cli
    if "cli" in phases:
        from recommendflow_tpu_torch.cli import evaluate as eval_cli
        from recommendflow_tpu_torch.cli import predict as pred_cli
        demo = Configuration(DEMO_CONF)
        with tempfile.TemporaryDirectory() as tmp:
            generate_records(demo, os.path.join(tmp, "rec"),
                             num_rows=S["cli_rows"], num_files=2)
            data = os.path.join(tmp, "rec", "*.rfb")
            metrics = eval_cli.main([DEMO_CONF, "--data", data, "--device",
                                     str(dev), "--topk", "5,10,50"])
            require(bool(metrics) and all(math.isfinite(v)
                                          for v in metrics.values()),
                    f"evaluate CLI metrics {metrics}")
            # weights through the interop file: predict must equal the model
            model, _ = build_network(demo.networks["class"],
                                     {"conf": demo, "device": dev, "seed": 7})
            ckpt = save_variables_npz(os.path.join(tmp, "vars.npz"),
                                      jax_from_variables(model.state_dict()))
            outs = pred_cli.main([DEMO_CONF, "--data", data, "--checkpoint",
                                  ckpt, "--out", os.path.join(tmp, "p.npz"),
                                  "--device", str(dev)])
            from recommendflow_tpu_torch.data.pipeline import make_dataset
            ds, _ = make_dataset(demo, data, 2048, shuffle=False,
                                 drop_remainder=False)
            direct = predict(model, ds, dev)
            n = S["cli_rows"]
            require(outs["user"].shape == (n, 128), f"{outs['user'].shape}")
            diff = max(float(np.abs(outs[k] - direct[k]).max())
                       for k in ("user", "ad"))
            require(diff <= 1e-5, f"predict CLI vs direct model: {diff}")
        log("cli", rows=n, evaluate_metrics=metrics, predict_vs_model=diff)

    # ----------------------------------------------------------- 6. times
    kernels = []
    if "times" in phases and not rehearse:
        timer = Timer(torch, S["reps"])
        ids_reps = [ids_for(20_000 + i) for i in range(S["reps"])]
        n_ids = ids_reps[0].numel()
        uniq = torch.unique(ids_reps[0]).numel()
        k1_bytes = uniq * 128 + n_ids * 128 + n_ids * 4
        k1_ms = timer.median_ms(lambda i: k1.launch_gather_rows(
            table64, ids_reps[i], check_ids=False))
        k1_plain = timer.median_ms(lambda i: k1.gather_rows_plain(
            table64, ids_reps[i]))
        k1_lib = timer.median_ms(lambda i: torch.index_select(
            table64, 0, ids_reps[i]))
        kernels.append(dict(
            name="gather_rows", **KERNEL_META["gather_rows"],
            launches=launches["gather_rows"], max_abs_err=k1_err, ms=k1_ms,
            plain_ms=k1_plain, bound_ms=k1_bytes / bw * 1e3,
            bound_by="bytes", library_ms=k1_lib))
        del ids_reps

        nq, n_pad, d = S["q"], S["n_pad"], S["d"]
        k2_ops = 2.0 * nq * num_items * d
        k2_bytes = 4 * (nq * d + n_pad * d + nq * (n_pad // G))
        k2_ms = timer.median_ms(lambda i: k2.launch_grouped_score_max(
            q, corpus, None, group=G, num_items=num_items))
        k2_plain = timer.median_ms(lambda i: k2.grouped_score_max_plain(
            q, corpus, None, group=G, num_items=num_items))
        k2_lib = timer.median_ms(lambda i: torch.matmul(q, corpus.T).view(
            nq, n_pad // G, G).amax(dim=-1))
        kernels.append(dict(
            name="grouped_score_max", **KERNEL_META["grouped_score_max"],
            launches=launches["grouped_score_max"], max_abs_err=k2_err,
            ms=k2_ms, plain_ms=k2_plain,
            bound_ms=max(k2_ops / flops, k2_bytes / bw) * 1e3,
            bound_by="operations" if k2_ops / flops >= k2_bytes / bw
            else "bytes", library_ms=k2_lib))
        log("times", card=card, peaks={"bytes_per_s": bw, "fp32_flops": flops},
            k1={"ids": n_ids, "unique_rows": uniq, "bytes": k1_bytes},
            k2={"q": nq, "n_pad": n_pad, "d": d, "flops": k2_ops,
                "bytes": k2_bytes}, reps=S["reps"])

    if rehearse:
        print("chip_smoke: CPU rehearsal done (no result without a card)")
        return 3
    if phases != list(PHASES):
        print(f"chip_smoke: partial run {phases} (no result)")
        return 4
    emit({"kernels": kernels})
    print(card, flush=True)
    emit({"ok": True, "device": {"platform": "gpu", "kind": kind,
                                 "count": torch.cuda.device_count()}})
    return 0


if __name__ == "__main__":
    sys.exit(main())
