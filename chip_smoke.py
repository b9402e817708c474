#!/usr/bin/env python3
"""Smoke test of recommendflow_tpu_torch on one NVIDIA card.

    python3 chip_smoke.py            # all phases, one card

Phases, each printing one JSON line; any failure exits non-zero:

  1. build                  nvcc-builds every kernel of csrc/ (one process per
                            source, started together) and reports build time
                            and ptxas usage (registers, spills), and the
                            HGMMA (wgmma) count in grouped_topk's SASS;
  2. gather_rows            against its plain version, bitwise, at every
                            shape the main paths launch it at: the
                            bench_recall dim-64 table (770 MB bf16, 128-byte
                            rows) at one batch's 87,040 ids, the
                            bench_ranking dim-32 table (2.5 GB bf16, 64-byte
                            rows) at one batch of 2048's 106,496 ids, uniform
                            and Zipf(1.2), and both tables in their stored
                            layout (512-byte rows) at those ids' stored rows
                            (the trainer's split gather);
  3. grouped_score_max      against its plain version at Q = 4096,
                            N_pad = 1,048,576, D = 128: f32 ip and l2 (FP32
                            SIMT kernel), the bf16 corpus and the uint8 form
                            on the SQ8 codes of the same corpus (queries
                            q ⊙ scale, ip and l2) on bf16 tensor cores; max
                            abs diff <= 1e-4 (f32 sums in another order;
                            both sides round the queries of a bf16 or uint8
                            corpus to bf16, and those products are exact);
  4. scatter_add_rows       one batch's stored-row gradients (87,040 rows of
                            the [1,505,024, 256] bf16 table, duplicates summed)
                            into a zero table: bitwise;
  5. rowwise_adagrad_update that table gradient applied to the table: p
                            bitwise (the same f32 operations in the same
                            order, one rounding), acc within rtol 1e-6 (the
                            mean is summed in another order), untouched rows
                            bitwise;
  6. sparse_adagrad_apply   the same step from the compacted f32 sums: the
                            same tolerances;
  7. flash_attention        against its plain version, f32 and bf16: at the
                            encoder's shape [256, 12, 64, 64] (q, k, v the
                            strided split_heads views of [B, L, H*D], key
                            masks from the token lengths of 256 texts), and
                            at Lq = 77, Lk = 200 for D in {8, 16, 32, 64,
                            128, 256} (online 64-key steps; past 128 the
                            head dim in 128-wide chunks) with a batch row whose
                            keys are all masked, at Lq = 130, Lk = 33 and
                            Lq = 77, Lk = 128 (one-pass tiles), and at
                            [4, 12, 64, 64] with leading, middle and
                            trailing holes in the mask; f32 within 1e-5
                            absolute (exps and sums in another order), bf16
                            within 2^-6 * max|v| (p rounded to bf16 before
                            P.V, <= 2^-8 relative each, plus both outputs'
                            final rounding, <= 2^-8 of |out| <= max|v| each);
                            one head of 256 dims over the encoder's batch
                            timed beside its bytes bound and SDPA;
  8. slice                  Dssm at the full width of conf/bench_recall.yaml
                            (random weights from a seed): predict 1,048,576
                            synthetic rows at batch 1024, build the eval
                            corpus, search 4096 user vectors with
                            FlatSearcher(metric="cos") at topk [10, 100]; the
                            top-100 must agree with a plain matmul + topk
                            (scores within 1e-5, indices equal except among
                            scores within 1e-5); gather_rows and
                            grouped_score_max must have launched;
  9. train                  Trainer.fit on the same model (the config's
                            dropout, batches of 1024): split path with
                            strategy "dense", then "sparse_set", then
                            table_update="dense", ending with the recall
                            evaluation; finite losses, every kernel of the
                            path launched; then one more step per split
                            strategy whose table update is redone through
                            the plain versions on the same row gradients
                            (both under torch's deterministic algorithms, so
                            the duplicate sums add in one order: p bitwise,
                            acc within rtol 1e-6, untouched rows bitwise);
 10. ranking                Dcn at the full width of conf/bench_ranking.yaml
                            (26 hashed features x 2 branches in one dim-32
                            bf16 group of 39,000,052 rows stored as [R/8,
                            256], 2.5 GB; 13 numeric; cross 3, deep 512-256-
                            128, the config's dropout 0.2; random weights
                            from seed 0), batches of 2048 from
                            synthetic_batch: scores of 131,072 rows finite
                            and in (0, 1), gather_rows launched; then
                            Trainer.fit with the split planner ("auto"),
                            then "dense", then "sparse_set" (20 steps each
                            after 3 warm-up steps), then 20 "auto" steps on
                            Zipf(1.2) ids, each run ending with val_auc on
                            16 held-out batches: finite losses, val_auc in
                            [0, 1], kernels 1-4 launched; 256 rows' logits
                            within 1e-4 of the same weights on the CPU;
                            one more step per strategy on uniform and Zipf
                            ids redone through the plain versions (as in 9);
                            one predict batch's embed pass and one split-
                            path gather under CUDA's sync debug mode
                            ("error"): the host never waits on the card in
                            either (the ids were checked on the host);
                            both strategies' split_table_update timed at the
                            bench_recall (770 MB, 87,040 ids) and
                            bench_ranking (2.5 GB, 106,496 ids) shapes and at
                            half the ranking ids, the planner's cost model
                            fitted to them, and its choice at bench_ranking
                            the faster strategy; 10 steps per strategy
                            under torch.profiler (device idle share);
 11. ranking_zoo            DeepFm, XDeepFm, Cold, Mmoe, Essm and Escm2 (dr
                            and ips) at conf/demo_ranking.yaml's widths: three
                            split steps ("dense", "dense", "sparse_set":
                            kernels 1-4 launched) with finite losses, and the
                            eval outputs within 1e-5 of the same weights on
                            the CPU;
 12. sq_search              benchmarks/bench_quantized_search.py's own
                            configuration: 10,000,000 x 128 items (a
                            1024-cluster Gaussian mixture, seed 0), 2048
                            queries (corpus rows + 0.15 noise, seed 7), k 100,
                            ip, through EncoderSearcher (array mode) with
                            index_param "Flat" (the ground truth), "SQ8" and
                            "SQbf16" (SqSearcher's defaults, so the
                            hierarchical tournament runs): the uint8 form of
                            grouped_score_max launched once per query block
                            for SQ8, the bf16 form for SQbf16 (each counted
                            on its own search), the f32 form for Flat; for 256 queries each top-100 against a
                            plain f64 scan on the card (Flat: over the
                            corpus; SQ: the tournament's function, the 100
                            best groups by bf16(q ⊙ scale)·codes, their items
                            rescored by q·x̂): scores within SEARCH_RTOL of
                            their magnitude, and an id in one top-100 but not
                            the other only at the boundary (its score, or its
                            group's maximum, within that tolerance of the
                            100th); build s, search ms, qps and recall@100
                            against Flat;
 13. ann                    the first 1,048,576 rows (the same generator's
                            first chunk, queries drawn as the bench draws
                            them at that size) through index_factory's
                            "IVF4096" (nprobe 32), "PQ16" and "IVF4096,PQ16"
                            (nprobe 32): recall@100 against Flat, build s,
                            search ms; IVF at nprobe = nlist and IVF-PQ at
                            full probe against plain f64 scans of what they
                            score (the vectors; the bf16 lookup tables plus
                            q·c, the overflow pool decoded in f32), PQ
                            against a plain scan of its bf16 decode, for 256
                            queries with the same rules;
 14. encode                 BERT-Base (google-research/bert's bert_config.json,
                            vocab 21,128 as the Chinese release) written as
                            random HF-named pytorch_model.bin, bert_config.json
                            and a generated vocab.txt, loaded by
                            TextEncoderService.from_pretrained (max_len 64,
                            batch 256, pooling cls, whitening, f32 with
                            allow_tf32 off); encode 16,384 generated texts
                            (5-64 tokens, some truncated): vectors finite and
                            unit-norm, the cache returns the same rows,
                            flash_attention launched 12 x the batches; the
                            model's vectors of 8 texts on the card against
                            the same files loaded on the CPU (the port's
                            plain path) within 1e-4 absolute (f32 sums of up
                            to 3072 terms in another order through 12
                            layers, vectors of LayerNorm scale ~1);
 15. serve                  EncodeServer + make_server on 127.0.0.1:0 with
                            that service: /health, concurrent and single
                            /encode requests of new texts through
                            RemoteEncoderClient (no local fallback), encoded
                            on the card (flash_attention launched); the
                            served vectors bitwise equal to a direct encode
                            of the same texts by the service (the JSON round
                            trip of f32 is exact, and each request gets its
                            own rows);
 16. text_search            EncoderSearcher(items=the 16,384 encoded vectors,
                            index_param="SQ8", measurement="cos") searched
                            with the service's own encode of the same texts:
                            item i in the top-10 of query i for every i (an
                            item-block scan below _HIER_MIN_ITEMS, as the JAX
                            package runs it at this size);
 17. cli                    cli/evaluate and cli/predict on a few thousand
                            conf/demo_recall.yaml records written by the
                            port, the second with weights carried through an
                            interop .npz; then cli/train --train_mode test
                            and cli/predict on the checkpoint it saved;
                            cli/train --monitor val_auc, cli/evaluate (auc)
                            and cli/predict on conf/demo_ranking.yaml
                            records (Dnn); cli/encode at its own widths
                            (--model_dim 256
                            --num_layers 4 --whitening) with --weights saved
                            by TextEncoderService.save: equal to that
                            service's encode within 1e-6 (the same batches;
                            the whitening read back from its file);
 18. times                  median of >= 20 CUDA-event timings of each kernel,
                            its plain version and one PyTorch library call
                            where one computes the same function, at the
                            phase 2-7 shapes and kernels 1-4 also at the
                            bench_ranking shape (gather_rows at every phase-2
                            shape, each also as the mean of 20 calls between
                            two events, beside its bound, its share of the
                            bound, index_select and its launches at that row
                            width; the uint8 form on phase 3's
                            SQ8 codes, the bf16 form on its bf16 corpus),
                            beside the least time the card could take (the
                            bf16 and uint8 forms at the bf16 tensor-core
                            rate: their products are bf16 x bf16); encode
                            ms per batch of 256, texts/s
                            and the device's idle share (torch.profiler),
                            and /encode request latency; the timing's own
                            floor (two events alone, an empty kernel).

Then the kernels' JSON line, the card's name and power limit, and the last
line {"ok": true, "device": {...}}. With no CUDA device it exits non-zero and
prints no result. `--cpu-rehearsal` runs every phase at toy sizes on the CPU
through the plain versions (no times, no result, exit code 3).
"""
from __future__ import annotations

import argparse
import copy
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
RANK_CONF = os.path.join(ROOT, "conf", "bench_ranking.yaml")
DEMO_RANK_CONF = os.path.join(ROOT, "conf", "demo_ranking.yaml")
# the ranking models of the zoo phase, at the demo config's widths
ZOO = {"DeepFm": ("recommendflow_tpu.models.ranking.deepfm.DeepFm", {}),
       "XDeepFm": ("recommendflow_tpu.models.ranking.deepfm.XDeepFm", {}),
       "Cold": ("recommendflow_tpu.models.preranking.cold.Cold", {}),
       "Mmoe": ("recommendflow_tpu.models.ranking.mmoe.Mmoe", {}),
       "Essm": ("recommendflow_tpu.models.ranking.essm.Essm", {}),
       "Escm2-dr": ("recommendflow_tpu.models.reranking.escm2.Escm2",
                    {"counterfactual": "dr"}),
       "Escm2-ips": ("recommendflow_tpu.models.reranking.escm2.Escm2",
                     {"counterfactual": "ips"})}
PHASES = ("build", "gather_rows", "grouped_score_max", "scatter_add_rows",
          "rowwise_adagrad_update", "sparse_adagrad_apply", "flash_attention",
          "slice", "train", "ranking", "ranking_zoo", "sq_search", "ann",
          "encode", "serve", "text_search", "cli", "times")
TABLE_PHASES = ("scatter_add_rows", "rowwise_adagrad_update",
                "sparse_adagrad_apply")
ENCODER_PHASES = ("flash_attention", "encode", "serve", "text_search", "cli",
                  "times")
QUANT_PHASES = ("sq_search", "ann")

# published peaks (NVIDIA data sheets, dense, at the full power limit):
# memory bytes/s, FP32 flop/s outside the tensor cores, bf16 tensor-core
# flop/s
PEAKS = {"PCIe": (2.0e12, 51.2e12, 756e12), "NVL": (3.9e12, 60.0e12, 835e12),
         "SXM": (3.35e12, 67.0e12, 989e12)}

KERNEL_META = {
    "gather_rows": dict(
        route="cuda", source="recommendflow_tpu_torch/csrc/embedding_bag.cu",
        replaces="recommendflow_tpu/ops/pallas/embedding_bag.py:112"),
    "grouped_score_max": dict(
        route="cuda", source="recommendflow_tpu_torch/csrc/grouped_topk.cu",
        replaces="recommendflow_tpu/ops/pallas/grouped_topk.py:67"),
    "scatter_add_rows": dict(
        route="cuda", source="recommendflow_tpu_torch/csrc/embedding_bag.cu",
        replaces="recommendflow_tpu/ops/pallas/embedding_bag.py:229"),
    "rowwise_adagrad_update": dict(
        route="cuda", source="recommendflow_tpu_torch/csrc/table_update.cu",
        replaces="recommendflow_tpu/ops/pallas/table_update.py:56"),
    "sparse_adagrad_apply": dict(
        route="cuda", source="recommendflow_tpu_torch/csrc/sparse_apply.cu",
        replaces="recommendflow_tpu/ops/pallas/sparse_apply.py:92"),
    "flash_attention": dict(
        route="cuda", source="recommendflow_tpu_torch/csrc/flash_attention.cu",
        replaces="recommendflow_tpu/ops/pallas/flash_attention.py:73"),
    "grouped_score_max_uint8": dict(
        route="cuda", source="recommendflow_tpu_torch/csrc/grouped_topk.cu",
        replaces="recommendflow_tpu/ops/pallas/grouped_topk.py:50-56"),
    "grouped_score_max_bf16": dict(
        route="cuda", source="recommendflow_tpu_torch/csrc/grouped_topk.cu",
        replaces="recommendflow_tpu/ops/pallas/grouped_topk.py:84-87"),
}
# the path each kernel's launches are counted on
KERNEL_PATH = {"gather_rows": "slice", "grouped_score_max": "slice",
               "scatter_add_rows": "train", "rowwise_adagrad_update": "train",
               "sparse_adagrad_apply": "train", "flash_attention": "encode",
               "grouped_score_max_uint8": "sq_search",
               "grouped_score_max_bf16": "sq_search_bf16"}
FA_F32_TOL = 1e-5
FA_BF16_TOL = 2.0 ** -6        # times max|v|
ENCODE_CPU_TOL = 1e-4
# ranking logits and outputs on the card against the CPU (f32 products, TF32
# off, summed in another order): Dcn's logits at bench_ranking width (first
# layer 1677 wide), the zoo's outputs at demo width
RANK_CPU_TOL = 1e-4
ZOO_CPU_TOL = 1e-5
CLI_TOL = 1e-6
LR = 0.03   # the table learning rate of the bench config (default_table_lr)
# f32 search scores against an f64 scan: sums of 128 products in f32 carry
# up to ~1e-6 of their magnitude (8.5e-7 measured on the quantized-search
# corpus, scores 90-200); within 4e-6 of max(1, |score|) is a match
SEARCH_RTOL = 4e-6
SCAN_REPS = 5   # timed calls of the ~56 ms plain and library scans
K = 100


def make_corpus(np, n: int, dim: int, seed: int = 0):
    """benchmarks/bench_quantized_search.py's clustered corpus: a 1024-centre
    Gaussian mixture (centres N(0, 1), noise 0.35), made in 1M-row chunks."""
    rng = np.random.default_rng(seed)
    centers = rng.standard_normal((1024, dim), np.float32)
    out = np.empty((n, dim), np.float32)
    for s in range(0, n, 1 << 20):
        e = min(n, s + (1 << 20))
        cid = rng.integers(0, len(centers), e - s)
        out[s:e] = centers[cid] + 0.35 * rng.standard_normal(
            (e - s, dim), np.float32)
    return out


def bench_queries(np, corpus, q: int):
    """The bench's queries: corpus rows drawn by default_rng(7), plus 0.15
    Gaussian noise."""
    rng = np.random.default_rng(7)
    qidx = rng.integers(0, len(corpus), q)
    return corpus[qidx] + 0.15 * rng.standard_normal(
        (q, corpus.shape[1]), np.float32)


def recall_at_k(got, gt) -> float:
    k = gt.shape[1]
    return sum(len(set(got[i, :k]) & set(gt[i])) for i in range(len(gt))) \
        / (len(gt) * k)


def merge_topk(torch, best, scores, start: int, k: int):
    """Fold one item block's scores [Q, b] (item ids from `start`) into the
    running (top scores, ids)."""
    s, i = torch.topk(scores, min(k, scores.shape[1]), dim=1)
    i = i + start
    if best is not None:
        s, p = torch.topk(torch.cat([best[0], s], 1), k, dim=1)
        i = torch.gather(torch.cat([best[1], i], 1), 1, p)
    return s, i


def check_topk(torch, what, got_s, got_i, ref_s, ref_i, score_of, group_near=None):
    """A searcher's top-k (f32) against a plain f64 reference: each returned
    score the true score of its id (score_of(ids [Q, n]) -> f64) within
    SEARCH_RTOL of its magnitude; an id in one top-k but not the other only
    at the boundary (its score within the tolerance of the k-th, or, with
    group_near(row, ids), its group's maximum within the tolerance of the
    k-th group's: the groups tie); and, in rows with no such swap, the
    scores within the tolerance of the reference's, position by position."""
    got_s = torch.as_tensor(got_s, dtype=torch.float64, device=ref_s.device)
    got_i = torch.as_tensor(got_i, device=ref_i.device).long()
    tol = SEARCH_RTOL * ref_s.abs().clamp(min=1.0)
    own_err = float(((got_s - score_of(got_i)).abs() / tol).max()) * SEARCH_RTOL
    kth = ref_s[:, -1]
    gi, ri = got_i.cpu().numpy(), ref_i.cpu().numpy()
    swapped = torch.zeros(len(gi), dtype=torch.bool, device=ref_s.device)
    differ = 0
    for r in range(len(gi)):
        odd = set(gi[r].tolist()) ^ set(ri[r].tolist())
        if not odd:
            continue
        ids = torch.tensor(sorted(odd), device=ref_s.device)
        s = score_of(ids[None, :].expand(len(gi), -1))[r]
        near = (s - kth[r]).abs() <= tol[r, -1]
        if group_near is not None:
            near |= group_near(r, ids)
        require(bool(near.all()), f"{what}: row {r} ids {sorted(odd)[:5]} "
                f"differ away from the boundary")
        swapped[r] = True
        differ += len(odd) // 2
    keep = ~swapped
    score_err = float(((got_s - ref_s).abs() / tol)[keep].max()) * SEARCH_RTOL \
        if bool(keep.any()) else 0.0
    require(score_err <= SEARCH_RTOL and own_err <= SEARCH_RTOL,
            f"{what}: top-{ref_s.shape[1]} scores off by {score_err} / "
            f"{own_err} (relative) > {SEARCH_RTOL}")
    return {"score_rel_err": score_err, "own_score_rel_err": own_err,
            "boundary_swaps": differ, "rows_with_swaps": int(swapped.sum()),
            "index_match": float((gi == ri).mean())}


def emit(obj) -> None:
    print(json.dumps(obj), flush=True)


def require(cond: bool, msg: str) -> None:
    if not cond:
        raise RuntimeError(msg)


def ulps(torch, a, b) -> float:
    """Largest |a - b| of two f32 or bf16 tensors in units of their type's
    spacing at max(|a|, |b|): a difference of one rounding is <= 1 however
    close to zero the values are."""
    if a.numel() == 0:
        return 0.0
    bits = 7 if a.dtype == torch.bfloat16 else 23
    a32, b32 = a.float(), b.float()
    mag = torch.maximum(a32.abs(), b32.abs()).clamp(min=2.0 ** -126)
    spacing = torch.exp2(torch.floor(torch.log2(mag)) - bits)
    return float(((a32 - b32).abs() / spacing).max())


def rel_err(x, ref) -> float:
    return float(((x - ref).abs() / ref.abs().clamp(min=1e-30)).max()) \
        if x.numel() else 0.0


def check_table_update(torch, what, p, acc, p_ref, acc_ref, p0, acc0, touched):
    """A table update against its reference: p bitwise, acc within rtol
    1e-6, untouched rows (touched: bool [R]) bitwise as they were."""
    err = {"p_ulps": ulps(torch, p, p_ref),
           "p_max_abs_err": float((p.float() - p_ref.float()).abs().max()),
           "acc_rel_err": rel_err(acc, acc_ref),
           "touched_rows": int(touched.sum())}
    keep = ~touched
    same = bool(torch.equal(p[keep].view(torch.int16 if p.dtype == torch.bfloat16
                                         else torch.int32),
                            p0[keep].view(torch.int16 if p.dtype == torch.bfloat16
                                          else torch.int32))
                and torch.equal(acc[keep], acc0[keep]))
    err["untouched_bitwise"] = same
    require(err["p_ulps"] == 0, f"{what}: p differs by {err['p_ulps']} ulps")
    require(err["acc_rel_err"] <= 1e-6, f"{what}: acc rel err "
            f"{err['acc_rel_err']}")
    require(same, f"{what}: an untouched row changed")
    return err


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

    def median_ms(self, fn, reps: int = 0) -> float:
        """The median of `reps` calls (default: the timer's own), each
        between two events."""
        torch = self.torch
        reps = reps or self.reps
        fn(0)                                   # warm-up (and lazy load)
        torch.cuda.synchronize()
        ev = [torch.cuda.Event(enable_timing=True) for _ in range(reps + 1)]
        torch.cuda._sleep(200_000_000)
        ev[0].record()
        for i in range(reps):
            fn(i)
            ev[i + 1].record()
        torch.cuda.synchronize()
        t = sorted(ev[i].elapsed_time(ev[i + 1]) for i in range(reps))
        return t[len(t) // 2]

    def batched_ms(self, fn) -> float:
        """The mean of the timer's reps calls between two events: no event
        recorded between the calls (two events alone take ~3 us on the
        H100)."""
        torch = self.torch
        fn(0)
        torch.cuda.synchronize()
        start, end = (torch.cuda.Event(enable_timing=True) for _ in range(2))
        torch.cuda._sleep(200_000_000)
        start.record()
        for i in range(self.reps):
            fn(i)
        end.record()
        torch.cuda.synchronize()
        return start.elapsed_time(end) / self.reps


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
    from recommendflow_tpu_torch.ops.cuda import embedding_bag as k_rows
    from recommendflow_tpu_torch.ops.cuda import grouped_topk as k_scan
    from recommendflow_tpu_torch.ops.cuda import sparse_apply as k_sparse
    from recommendflow_tpu_torch.ops.cuda import table_update as k_dense
    from recommendflow_tpu_torch.ops.cuda import flash_attention as k_fa
    from recommendflow_tpu_torch.ops.attention import split_heads
    from recommendflow_tpu_torch.encoder import TextEncoderService, Tokenizer
    from recommendflow_tpu_torch.encoder import synthetic as enc_syn
    from recommendflow_tpu_torch.ops.embedding import (fused_group_ids,
                                                       physical_ids)
    from recommendflow_tpu_torch.retrieval.eval import (
        batch_compute_recall_score, build_eval_corpus)
    from recommendflow_tpu_torch.retrieval.flat import FlatSearcher
    from recommendflow_tpu_torch.retrieval import EncoderSearcher, _kernels
    from recommendflow_tpu_torch.train.optimizers import (init_accumulator,
                                                          split_table_update)
    from recommendflow_tpu_torch.train.trainer import (Trainer, plan_strategy,
                                                       predict, split_costs,
                                                       table_params, to_device)

    dev = torch.device("cpu" if rehearse else "cuda:0")
    # toy sizes for the rehearsal; full sizes on the card
    S = dict(batch=1024, n_batches=1024, q=4096, n_pad=1 << 20, d=128,
             search_q=4096, cli_rows=4000, reps=20, wide_q=2048,
             wide_n=1 << 16) if not rehearse else \
        dict(batch=64, n_batches=8, q=64, n_pad=1 << 13, d=128, search_q=64,
             cli_rows=400, reps=2, wide_q=16, wide_n=1024)
    # the encoder path: BERT-Base on the card, a two-layer toy of it here
    E = dict(config=enc_syn.BERT_BASE, texts=16384, batch=256, serve_clients=8,
             serve_texts=32, latency_reps=10, cli_texts=2048) if not rehearse \
        else dict(config=dict(enc_syn.BERT_BASE, hidden_size=64,
                              num_hidden_layers=2, num_attention_heads=4,
                              intermediate_size=128),
                  texts=512, batch=64, serve_clients=4, serve_texts=8,
                  latency_reps=2, cli_texts=128)
    sync = torch.cuda.synchronize if not rehearse else (lambda: None)
    card = nvidia_smi() if not rehearse else "cpu rehearsal"
    kind = torch.cuda.get_device_name(0) if not rehearse else "cpu"
    bw, flops, bf16_tc = card_peaks(kind)
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
        # the bf16 and uint8 forms of grouped_score_max run on tensor cores:
        # wgmma is HGMMA in the SASS (cuobjdump ships with nvcc)
        cuobjdump = os.path.join(os.path.dirname(_build.nvcc_path()),
                                 "cuobjdump")
        require(os.path.exists(cuobjdump), f"no cuobjdump beside nvcc "
                f"({cuobjdump}): the HGMMA check cannot run")
        dump = subprocess.run(
            [cuobjdump, "-sass", _build.library_path("grouped_topk")],
            check=True, capture_output=True, text=True, timeout=300).stdout
        hgmma = [ln.strip() for ln in dump.splitlines() if "HGMMA" in ln]
        require(bool(hgmma), "grouped_topk: no HGMMA (wgmma) in its SASS")
        sass = {"grouped_topk_hgmma": len(hgmma), "first": hgmma[0]}
        log("build", wall_s=time.perf_counter() - t0, per_kernel_s=secs,
            ptxas=ptxas, sass=sass)

    # --------------------------------------------- shared inputs (2-6, 12)
    bench_conf = Configuration(BENCH_CONF)
    schema = compile_schema(bench_conf.features)
    group64 = schema.groups[64]
    rows64 = group64.total_rows if not rehearse else 4096
    rows64 = -(-rows64 // 1024) * 1024
    table64 = torch.randn((rows64, 64), generator=gen, device=dev
                          ).to(torch.bfloat16)
    # the same table in its stored layout [R/4, 256]: 512-byte rows
    stored = table64.view(-1, 256)
    R = stored.shape[0]

    def ids_for(seed, sch=schema, dim=64, rows=rows64, batch=S["batch"],
                zipf=0.0):
        """One synthetic batch's logical ids of the dim group (fused)."""
        b = synthetic_batch(sch, batch, seed=seed, zipf=zipf)
        ids = fused_group_ids(sch, {k: torch.from_numpy(v) for k, v in
                                    b.items()})[dim].reshape(-1)
        return (ids % rows).to(torch.int32).to(dev)

    def update_inputs(seed, **shape):
        """One batch's table-update inputs (at the main-path shape unless
        `shape` gives ids_for another): the stored rows its ids touch, f32
        row gradients, the sorted duplicate sums (uid, summed, n_valid) and
        a bool [R] of the touched rows."""
        per = 256 // shape.get("dim", 64)
        n_stored = shape.get("rows", rows64) // per
        sid = ids_for(seed, **shape) // per
        g = torch.randn((sid.numel(), 256), generator=gen, device=dev) * 0.01
        s_, order = torch.sort(sid, stable=True)
        summed, uid, _, n_valid = k_rows.segment_row_grads(s_, g[order],
                                                           num_rows=n_stored)
        touched = torch.zeros(n_stored, dtype=torch.bool, device=dev)
        touched[sid.long()] = True
        return dict(uid=uid, summed=summed, n_valid=n_valid, touched=touched,
                    n_ids=sid.numel())

    # the bench_ranking shape: the dim-32 group of 39,000,052 logical rows
    # stored bf16 as [R/8, 256], batches of 2048
    rk_schema = compile_schema(Configuration(RANK_CONF).features)
    rank = dict(sch=rk_schema, dim=32, batch=2048 if not rehearse else 64,
                rows=-(-rk_schema.groups[32].total_rows // 1024) * 1024
                if not rehearse else 8192)

    def ranking_table():
        return torch.randn((rank["rows"], 32), generator=gen, device=dev
                           ).to(torch.bfloat16)

    def gather_cases(table32, seed, n=1):
        """Kernel 1's shapes on the main paths, each (table, [ids] x n):
        serving (logical rows) and the trainer's split gather (stored rows)
        of both bench tables, and ranking serving on Zipf(1.2) ids."""
        rec = [ids_for(seed + i) for i in range(n)]
        rk = [ids_for(seed + i, **rank) for i in range(n)]
        return {"recall_serving": (table64, rec),
                "recall_split": (stored, [i // 4 for i in rec]),
                "ranking_serving": (table32, rk),
                "ranking_serving_zipf1.2": (table32, [ids_for(
                    seed + 500 + i, zipf=1.2, **rank) for i in range(n)]),
                "ranking_split": (table32.view(-1, 256),
                                  [i // 8 for i in rk])}

    errs = {}
    if "gather_rows" in phases or "times" in phases:
        table32 = ranking_table()
        held = {}
        for name, (table_, (ids_,)) in gather_cases(table32, 10_000).items():
            got = k_rows.gather_rows(table_, ids_)
            ref = k_rows.gather_rows_plain(table_, ids_)
            sync()
            same = bool(torch.equal(got.view(torch.int16),
                                    ref.view(torch.int16)))
            require(same, f"gather_rows differs from its plain version at "
                    f"{name}")
            held[name] = {"table": list(table_.shape), "ids": ids_.numel(),
                          "max_abs_err": float((got.float() - ref.float()
                                                ).abs().max())}
        errs["gather_rows"] = max(h["max_abs_err"] for h in held.values())
        del table32, got, ref
        log("gather_rows", shapes=held, bitwise_equal=True,
            max_abs_err=errs["gather_rows"])

    q = torch.nn.functional.normalize(
        torch.randn((S["q"], S["d"]), generator=gen, device=dev), dim=1)
    corpus = torch.nn.functional.normalize(
        torch.randn((S["n_pad"], S["d"]), generator=gen, device=dev), dim=1)
    num_items = S["n_pad"] - 1000          # a masked, partial tail group
    G = 16
    codes_u = qs_u = None
    if "grouped_score_max" in phases or "times" in phases:
        scale = torch.rand((S["n_pad"], 1), generator=gen, device=dev) + 0.5
        # the uint8 form on the SQ8 codes of the same corpus (SqSearcher's
        # per-dim affine encode), queries q ⊙ scale as SQ8 search hands them
        vmin_u = corpus.amin(0)
        scale_u = (corpus.amax(0) - vmin_u) / 255.0
        codes_u = torch.clamp(torch.round((corpus - vmin_u) / scale_u), 0,
                              255).to(torch.uint8)
        qs_u = q * scale_u
        xsq_u = ((vmin_u + scale_u * codes_u.float()) ** 2).sum(1)
        variants = {
            "f32_ip": (q, corpus, None),
            "bf16_ip": (q, corpus.to(torch.bfloat16), None),
            "f32_l2": (q, corpus * scale, ((corpus * scale) ** 2).sum(1)),
            "u8_ip": (qs_u, codes_u, None),
            "u8_l2": (qs_u, codes_u, xsq_u),
        }
        by_variant = {}
        for name, (qv_, v, sqn) in variants.items():
            got = k_scan.grouped_score_max(qv_, v, sqn, group=G,
                                           num_items=num_items)
            ref = k_scan.grouped_score_max_plain(qv_, v, sqn, group=G,
                                                 num_items=num_items)
            sync()
            require(tuple(got.shape) == (S["q"], S["n_pad"] // G),
                    f"grouped_score_max {name}: shape {tuple(got.shape)}")
            by_variant[name] = float((got - ref).abs().max())
            require(by_variant[name] <= 1e-4, f"grouped_score_max {name}: max "
                    f"abs diff {by_variant[name]} > 1e-4")
            del got, ref
        del variants, scale, xsq_u
        # the tensor-core forms past the resident query tile (D above
        # 256-320 at 256 queries a block): each ring stage carries the query
        # rows' K-block beside the items. Scores of std ~2 keep the f32 sums
        # of 1536 exact products inside the same atol 1e-4.
        wide, wq, wn = {}, S["wide_q"], S["wide_n"]
        for wd in (512, 1536):
            wv = torch.randn((wn, wd), generator=gen, device=dev)
            wc = torch.randint(0, 256, (wn, wd), generator=gen, device=dev,
                               dtype=torch.uint8)
            for name, v in ((f"bf16_d{wd}", wv.to(torch.bfloat16)),
                            (f"u8_d{wd}", wc)):
                wqs = torch.randn((wq, wd), generator=gen, device=dev)
                wqs *= 2.0 / (wd * float(v.float().pow(2).mean())) ** 0.5
                got = k_scan.grouped_score_max(wqs, v, None, group=G,
                                               num_items=wn - 5)
                ref = k_scan.grouped_score_max_plain(wqs, v, None, group=G,
                                                     num_items=wn - 5)
                sync()
                err = float((got - ref).abs().max())
                require(err <= 1e-4, f"grouped_score_max {name}: max abs diff "
                        f"{err} > 1e-4")
                by_variant[name] = err
                # device time of the streamed form beside its bound (not on
                # a main path; the kernels line times the main-path shape)
                wide[name] = {
                    "ms": Timer(torch, 5).median_ms(
                        lambda i: k_scan.launch_grouped_score_max(
                            wqs, v, None, group=G, num_items=wn - 5))
                    if not rehearse else None,
                    "bound_ms": 2.0 * wq * (wn - 5) * wd / bf16_tc * 1e3}
                del got, ref
            del wv, wc
        errs["grouped_score_max"] = max(by_variant["f32_ip"],
                                        by_variant["f32_l2"])
        errs["grouped_score_max_bf16"] = by_variant["bf16_ip"]
        errs["grouped_score_max_uint8"] = max(by_variant["u8_ip"],
                                              by_variant["u8_l2"])
        log("grouped_score_max", q=S["q"], n_pad=S["n_pad"], d=S["d"], group=G,
            num_items=num_items, max_abs_err=by_variant, tolerance=1e-4,
            wide_rows={"q": wq, "n_pad": wn, "times": wide})

    upd = None
    if any(p in phases for p in TABLE_PHASES) or "times" in phases:
        upd = update_inputs(10_001)
        acc0 = torch.rand((R, 1), generator=gen, device=dev) + 0.1
        u, sm, nv, touched = (upd["uid"], upd["summed"], upd["n_valid"],
                              upd["touched"])
        gd = torch.zeros_like(stored)
        gd_ref = torch.zeros_like(stored)
        k_rows.scatter_add_rows(u, sm, gd, nv)
        k_rows.scatter_add_rows_plain(u, sm, gd_ref, nv)
        sync()
        same = bool(torch.equal(gd.view(torch.int16), gd_ref.view(torch.int16)))
        require(same, "scatter_add_rows differs from its plain version")
        errs["scatter_add_rows"] = float((gd.float() - gd_ref.float()).abs().max())
        log("scatter_add_rows", table=list(stored.shape), ids=upd["n_ids"],
            unique_rows=int(nv), bitwise_equal=same,
            max_abs_err=errs["scatter_add_rows"])
        del gd_ref

        p_k, a_k = stored.clone(), acc0.clone()
        p_r, a_r = stored.clone(), acc0.clone()
        k_dense.rowwise_adagrad_update(p_k, a_k, gd, lr=LR)
        k_dense.rowwise_adagrad_update_plain(p_r, a_r, gd, lr=LR)
        sync()
        err = check_table_update(torch, "rowwise_adagrad_update", p_k, a_k,
                                 p_r, a_r, stored, acc0, touched)
        errs["rowwise_adagrad_update"] = err["p_max_abs_err"]
        log("rowwise_adagrad_update", **err)

        p_k.copy_(stored), a_k.copy_(acc0)
        p_r.copy_(stored), a_r.copy_(acc0)
        k_sparse.sparse_adagrad_apply(p_k, a_k, u, sm, nv, lr=LR)
        k_sparse.sparse_adagrad_apply_plain(p_r, a_r, u, sm, nv, lr=LR)
        sync()
        err = check_table_update(torch, "sparse_adagrad_apply", p_k, a_k,
                                 p_r, a_r, stored, acc0, touched)
        errs["sparse_adagrad_apply"] = err["p_max_abs_err"]
        log("sparse_adagrad_apply", **err)
        del p_k, a_k, p_r, a_r

    # ----------------------------------------- encoder inputs (7, 14-17)
    cfg = E["config"]
    heads, layers = cfg["num_attention_heads"], cfg["num_hidden_layers"]
    head_dim = cfg["hidden_size"] // heads
    enc_tmp = tempfile.TemporaryDirectory(prefix="chip_smoke_bert_")
    bert_files = None
    texts = tokenizer = fa_mask = None
    if any(p in phases for p in ENCODER_PHASES):
        vocab = enc_syn.make_vocab(cfg["vocab_size"], seed=0)
        tokenizer = Tokenizer({t: i for i, t in enumerate(vocab)})
        texts = enc_syn.make_texts(E["texts"], seed=0)
        # the key mask of one batch: [256, 64] from the texts' token counts
        fa_mask = torch.from_numpy(
            tokenizer.encode_batch(texts[:E["batch"]], 64)[0] > 0).to(dev)

    def path_qkv(dtype):
        """q, k, v at the encoder's attention shape, as split_heads hands
        them over: [B, H, L, D] views of [B, L, H*D] projections."""
        return [split_heads(torch.randn(
            (E["batch"], 64, heads * head_dim), generator=gen, device=dev
        ).to(dtype), heads) for _ in range(3)]

    if "flash_attention" in phases:
        cases = []
        for dtype in (torch.float32, torch.bfloat16):
            cases.append(("path", *path_qkv(dtype), fa_mask))
            for b, lq, lk, d in [(3, 77, 200, 8), (3, 77, 200, 16),
                                 (3, 77, 200, 32), (3, 77, 200, 64),
                                 (3, 77, 200, 128), (2, 130, 33, 64),
                                 (3, 77, 128, 64), (3, 77, 200, 256)]:
                qkv = [torch.randn((b, 2, n, d), generator=gen, device=dev
                                   ).to(dtype) for n in (lq, lk, lk)]
                m = torch.rand((b, lk), generator=gen, device=dev) < 0.7
                m[:, 1] = True
                m[0] = False                  # a row with every key masked
                cases.append((f"b{b}_lq{lq}_lk{lk}_d{d}", *qkv, m))
            # the one-pass tile at the encoder's head shape, with leading,
            # middle and trailing holes in the key mask
            qkv = [torch.randn((4, 12, 64, 64), generator=gen, device=dev
                               ).to(dtype) for _ in range(3)]
            m = torch.ones((4, 64), dtype=torch.bool, device=dev)
            m[0, :20] = False
            m[1, 20:40] = False
            m[2, 40:] = False
            m[3] = False
            cases.append(("b4_lq64_lk64_d64_holes", *qkv, m))
        by_case = {}
        for name, q_, k_, v_, m_ in cases:
            got = k_fa.flash_attention(q_, k_, v_, m_)
            ref = k_fa.flash_attention_plain(q_, k_, v_, m_)
            sync()
            require(got.shape == q_.shape and got.dtype == q_.dtype,
                    f"flash_attention {name}: {got.dtype} {tuple(got.shape)}")
            err = float((got.float() - ref.float()).abs().max())
            tol = FA_F32_TOL if q_.dtype == torch.float32 else \
                FA_BF16_TOL * float(v_.float().abs().max())
            key = f"{str(q_.dtype).split('.')[-1]}/{name}"
            by_case[key] = {"max_abs_err": err, "tolerance": tol}
            require(err <= tol, f"flash_attention {key}: max abs diff {err} "
                    f"> {tol}")
        del cases, got, ref
        errs["flash_attention"] = max(c["max_abs_err"] for k, c in
                                      by_case.items() if k.startswith("float32"))
        # head dims past 128 (128-wide chunks): one head of 256 dims over
        # the encoder's batch, f32, its time beside its bytes bound (not on
        # a main path; the kernels line times the encoder's shape)
        wq, wk, wv = [torch.randn((E["batch"], 1, 64, 256), generator=gen,
                                  device=dev) for _ in range(3)]
        wide = {"shape": [E["batch"], 1, 64, 256],
                "bound_ms": 4 * 4 * wq.numel() / bw * 1e3,
                "ms": Timer(torch, 5).median_ms(
                    lambda i: k_fa.launch_flash_attention(wq, wk, wv, fa_mask))
                if not rehearse else None,
                "library_ms": Timer(torch, 5).median_ms(
                    lambda i: torch.nn.functional.scaled_dot_product_attention(
                        wq, wk, wv, attn_mask=fa_mask[:, None, None, :]))
                if not rehearse else None}
        del wq, wk, wv
        log("flash_attention", path_shape=[E["batch"], heads, 64, head_dim],
            path_valid_keys=int(fa_mask.sum()), cases=by_case, wide_head=wide)

    svc = emb = None

    def encoder_service():
        """The encode path's service: BERT-Base from the written files."""
        nonlocal svc, bert_files
        if svc is None:
            bert_files = enc_syn.write_bert_files(enc_tmp.name, cfg, seed=0)
            svc = TextEncoderService.from_pretrained(
                *bert_files, max_len=64, batch_size=E["batch"],
                use_whitening=True, device=dev)
        return svc

    def check_split_step(model, state, batch, strategy, tag):
        """One more split step whose table update is redone through the
        plain versions on the same row gradients. Both run under torch's
        deterministic algorithms: the duplicate sums' index_add_ then adds
        in one order on both sides instead of by float atomics."""
        trainer = Trainer(model, table_update="split", split_strategy=strategy,
                          device=dev, seed=0)
        trainer.plan(batch)
        tables = table_params(model)
        _, _, phys, rows = trainer._forward_backward(trainer._put(batch))
        before = {d: (tables[d].detach().clone(),
                      state.table_acc[f"dim{d}"].clone()) for d in phys}
        out = {}
        torch.use_deterministic_algorithms(True, warn_only=True)
        try:
            trainer._apply_table_updates(state, phys, rows)
            for d in phys:
                p, acc = tables[d].detach(), state.table_acc[f"dim{d}"]
                p_k, acc_k = p.clone(), acc.clone()
                p0, acc0 = before[d]
                p.copy_(p0), acc.copy_(acc0)
                s_, order = torch.sort(phys[d], stable=True)
                summed, uid, _, n_valid = k_rows.segment_row_grads(
                    s_, rows[d].grad[order].float(), num_rows=p.shape[0])
                if strategy == "dense":
                    gd = torch.zeros_like(p)
                    k_rows.scatter_add_rows_plain(uid, summed, gd, n_valid)
                    k_dense.rowwise_adagrad_update_plain(
                        p, acc, gd, lr=trainer.table_lr)
                    del gd
                else:
                    k_sparse.sparse_adagrad_apply_plain(
                        p, acc, uid, summed, n_valid, lr=trainer.table_lr)
                sync()
                touched = torch.zeros(p.shape[0], dtype=torch.bool, device=dev)
                touched[phys[d].long()] = True
                out[f"{tag}/dim{d}"] = check_table_update(
                    torch, f"train step ({tag}, dim{d})", p_k, acc_k, p, acc,
                    p0, acc0, touched)
                del p_k, acc_k, p0, acc0
        finally:
            torch.use_deterministic_algorithms(False)
        return out

    # ----------------------------------------------------------- 8. slice
    counters = {"gather_rows": k_rows.gather_rows,
                "grouped_score_max": k_scan.grouped_score_max,
                "scatter_add_rows": k_rows.scatter_add_rows,
                "rowwise_adagrad_update": k_dense.rowwise_adagrad_update,
                "sparse_adagrad_apply": k_sparse.sparse_adagrad_apply,
                "flash_attention": k_fa.flash_attention}

    by_dtype = k_scan.grouped_score_max.launches_by_dtype
    by_row_bytes = k_rows.gather_rows.launches_by_row_bytes

    def reset_counts():
        for fn in counters.values():
            fn.launches = 0
        for form in by_dtype:
            by_dtype[form] = 0
        by_row_bytes.clear()

    def read_counts():
        """Launches by kernel, the uint8 and bf16 forms of grouped_score_max
        apart (they are counted in grouped_score_max's total as well), and
        gather_rows' launches by row width in bytes."""
        return {**{name: fn.launches for name, fn in counters.items()},
                "grouped_score_max_uint8": by_dtype["uint8"],
                "grouped_score_max_bf16": by_dtype["bfloat16"],
                "gather_rows_by_row_bytes": dict(by_row_bytes)}

    launches = {"slice": {}, "train": {}, "ranking": {}, "sq_search": {},
                "sq_search_bf16": {}, "encode": {}}
    model = None
    if "slice" in phases or "train" in phases:
        model, _ = build_network(bench_conf.networks["class"],
                                 {"conf": bench_conf, "device": dev, "seed": 0})
    if "slice" in phases:
        reset_counts()
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
        launches["slice"] = read_counts()
        require(all(launches["slice"][k] > 0 for k in
                    ("gather_rows", "grouped_score_max")) or rehearse,
                f"a kernel was not launched on the serving path: "
                f"{launches['slice']}")
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
            launches=launches["slice"],
            peak_mem_gb=(torch.cuda.max_memory_allocated() / 1e9
                         if not rehearse else None))
        del out, searcher, cn, qn
        if not rehearse:
            torch.cuda.empty_cache()

    # ----------------------------------------------------------- 9. train
    if "train" in phases:
        from recommendflow_tpu_torch.retrieval.eval import make_recall_evaluator
        from recommendflow_tpu_torch.train.callbacks import EvalCallback
        if rehearse:   # the bench table does not train at CPU speed
            demo = Configuration(DEMO_CONF)
            model, _ = build_network(demo.networks["class"],
                                     {"conf": demo, "device": dev, "seed": 0})
        T = dict(warm=3, dense=20, sparse_set=20, table_dense=5,
                 eval_batches=512) if not rehearse else \
            dict(warm=1, dense=2, sparse_set=2, table_dense=2, eval_batches=4)
        seeds = iter(range(100_000, 200_000))

        def batches(n):
            return [synthetic_batch(model.schema, S["batch"], seed=next(seeds))
                    for _ in range(n)]

        runs = [("warm", "split", "dense"), ("dense", "split", "dense"),
                ("sparse_set", "split", "sparse_set"),
                ("table_dense", "dense", "dense")]
        data = {name: batches(T[name]) for name, _, _ in runs}
        eval_ds = batches(T["eval_batches"])
        if not rehearse:
            torch.cuda.reset_peak_memory_stats()
        reset_counts()
        state, per_run, losses = None, {}, []
        for name, mode, strategy in runs:
            trainer = Trainer(model, table_update=mode, split_strategy=strategy,
                              device=dev, seed=0)
            cbs = [EvalCallback(make_recall_evaluator(eval_ds, topk_list=[10, 100]))
                   ] if name == "table_dense" else []
            res = trainer.fit(data[name], state=state, callbacks=cbs,
                              resume_data=False, verbose=False)
            state, logs = res["state"], res["history"][-1]
            losses.append(logs["loss"])
            per_run[name] = {
                "steps": T[name], "loss": logs["loss"],
                "examples_per_s": logs["examples_per_sec"],
                "ms_per_step": S["batch"] / logs["examples_per_sec"] * 1e3}
        sync()
        launches["train"] = read_counts()
        recall = {k: v for k, v in logs.items() if k.startswith("val_")}
        require(all(math.isfinite(x) for x in losses), f"losses {losses}")
        # the training path runs the table kernels, gather_rows and, in
        # the recall evaluation, grouped_score_max; not the encoder's
        require(all(launches["train"][k] > 0 for k in (
            "gather_rows", "grouped_score_max", "scatter_add_rows",
            "rowwise_adagrad_update", "sparse_adagrad_apply")) or rehearse,
                f"a kernel was not launched on the training path: "
                f"{launches['train']}")
        require(bool(recall) and all(math.isfinite(v) for v in recall.values()),
                f"recall evaluation {recall}")
        update_check = {}
        for strategy in ("dense", "sparse_set"):
            update_check.update(check_split_step(model, state, batches(1)[0],
                                                 strategy, strategy))
        log("train", config=os.path.basename(BENCH_CONF) if not rehearse
            else os.path.basename(DEMO_CONF), batch=S["batch"],
            dropout=float(model.user_tower.drop.p) if model.user_tower.drop
            else 0.0, runs=per_run, recall=recall, launches=launches["train"],
            update_check=update_check,
            peak_mem_gb=(torch.cuda.max_memory_allocated() / 1e9
                         if not rehearse else None))
        del state, trainer, data, eval_ds
    del model
    if not rehearse:
        torch.cuda.empty_cache()

    # --------------------------------------------------------- 10. ranking
    if "ranking" in phases:
        rconf = Configuration(RANK_CONF if not rehearse else DEMO_RANK_CONF)
        if rehearse:   # the bench table does not train at CPU speed
            rconf.networks["class"] = "recommendflow_tpu.models.ranking.dcn.Dcn"
        RK = dict(batch=2048, serve_batches=64, check_rows=256, warm=3,
                  steps=20, eval_batches=16, reps=20) if not rehearse else \
            dict(batch=64, serve_batches=4, check_rows=32, warm=1, steps=2,
                 eval_batches=2, reps=2)
        model, _ = build_network(rconf.networks["class"],
                                 {"conf": rconf, "device": dev, "seed": 0})
        rschema = model.schema
        (rdim,) = table_params(model)
        rtable = table_params(model)[rdim]
        rseeds = iter(range(300_000, 400_000))

        def rbatches(n, zipf=0.0):
            return [synthetic_batch(rschema, RK["batch"], seed=next(rseeds),
                                    zipf=zipf) for _ in range(n)]

        if not rehearse:
            torch.cuda.reset_peak_memory_stats()
        reset_counts()
        # serving: scores of serve_batches x batch rows
        serve = rbatches(RK["serve_batches"])
        sync()
        t0 = time.perf_counter()
        out = predict(model, serve, dev)
        sync()
        serve_s = time.perf_counter() - t0
        n_rows = RK["batch"] * RK["serve_batches"]
        score = out["score"]
        require(score.shape == (n_rows,) and bool(np.isfinite(score).all())
                and bool(((score > 0) & (score < 1)).all()),
                f"ranking scores: shape {score.shape}, "
                f"range [{score.min()}, {score.max()}]")
        require(read_counts()["gather_rows"] > 0 or rehearse,
                "gather_rows did not launch on the ranking serving path")
        few = {k: v[:RK["check_rows"]] for k, v in serve[0].items()}
        del serve, out
        # training: the planner ("auto"), then each strategy on its own,
        # each run ending with the AUC on held-out batches
        eval_ds = rbatches(RK["eval_batches"])
        runs = [("warm", "auto", RK["warm"], 0.0),
                ("auto", "auto", RK["steps"], 0.0),
                ("dense", "dense", RK["steps"], 0.0),
                ("sparse_set", "sparse_set", RK["steps"], 0.0),
                ("auto_zipf1.2", "auto", RK["steps"], 1.2)]
        state, per_run = None, {}
        for name, strategy, n, zipf in runs:
            trainer = Trainer(model, split_strategy=strategy, device=dev, seed=0)
            res = trainer.fit(rbatches(n, zipf), valid_ds=eval_ds, state=state,
                              resume_data=False, verbose=False)
            state, logs = res["state"], res["history"][-1]
            require(math.isfinite(logs["loss"]) and
                    0.0 <= logs.get("val_auc", -1.0) <= 1.0,
                    f"ranking run {name}: {logs}")
            per_run[name] = {
                "steps": n, "zipf": zipf,
                "split": {f"dim{d}": s_ for d, s_ in trainer._split_dims.items()},
                "loss": logs["loss"], "val_auc": logs["val_auc"],
                "examples_per_s": logs["examples_per_sec"],
                "ms_per_step": RK["batch"] / logs["examples_per_sec"] * 1e3}
        sync()
        launches["ranking"] = read_counts()
        require(all(launches["ranking"][k] > 0 for k in (
            "gather_rows", "scatter_add_rows", "rowwise_adagrad_update",
            "sparse_adagrad_apply")) or rehearse,
                f"a kernel was not launched on the ranking path: "
                f"{launches['ranking']}")
        # the trained weights on the CPU (TF32 off on the card)
        model.eval()
        cpu_model = copy.deepcopy(model).to("cpu")
        with torch.no_grad():
            card_logit = model(to_device(few, dev))["logit"].cpu()
            cpu_logit = cpu_model(to_device(few, torch.device("cpu")))["logit"]
        cpu_err = float((card_logit - cpu_logit).abs().max())
        del cpu_model
        require(cpu_err <= RANK_CPU_TOL, f"ranking logits on the card vs the "
                f"CPU: {cpu_err} > {RANK_CPU_TOL}")
        update_check = {}
        for strategy in ("dense", "sparse_set"):
            for zipf in (0.0, 1.2):
                update_check.update(check_split_step(
                    model, state, rbatches(1, zipf)[0], strategy,
                    f"{strategy}/zipf{zipf}"))
        # the host never waits on the card in one predict batch's embed
        # pass or in the split path's gather: both launch gather_rows
        # unchecked (the host checked the batch's ids); CUDA's sync debug
        # mode raises on any wait. A warm-up pass first copies the slot
        # offsets to the card (once).
        sb = to_device(rbatches(1)[0], dev)
        strainer = Trainer(model, split_strategy="sparse_set", device=dev,
                           seed=0)
        strainer.plan(sb)
        model.eval()
        no_wait = {"embed_pass": lambda: model.embedder(sb),
                   "split_gather": lambda: strainer.split_rows(sb)}
        with torch.no_grad():
            for what, fn in no_wait.items():
                fn()
                sync()
                if not rehearse:
                    torch.cuda.set_sync_debug_mode("error")
                try:
                    fn()
                except RuntimeError as e:
                    raise RuntimeError(f"ranking {what} made the host wait "
                                       f"on the card: {e}") from e
                finally:
                    if not rehearse:
                        torch.cuda.set_sync_debug_mode("default")
        del sb, strainer
        # the planner's cost model: both strategies' split_table_update (the
        # sort and duplicate sum included) at the bench_recall and the
        # bench_ranking shapes, and the ranking table at half a batch's ids
        planner = None
        if not rehearse:
            fused = fused_group_ids(rschema, to_device(rbatches(1)[0], dev))
            rank_ids = physical_ids(rtable, rdim, fused[rdim]).to(torch.int32)
            shapes = {"bench_recall": (stored.clone(), ids_for(10_002) // 4),
                      "bench_ranking": (rtable.detach(), rank_ids),
                      "bench_ranking_half_ids": (rtable.detach(),
                                                 rank_ids[:rank_ids.numel() // 2])}
            names = list(shapes)
            timer = Timer(torch, RK["reps"])
            planner = {}
            for shape, (p_, ids_) in shapes.items():
                acc_ = init_accumulator(p_)
                g_ = (torch.randn((ids_.numel(), p_.shape[1]), generator=gen,
                                  device=dev) * 0.01).to(p_.dtype)
                ms = {s_: timer.median_ms(
                    lambda i, s_=s_: split_table_update(
                        p_, acc_, ids_, g_, lr=LR, strategy=s_))
                    for s_ in ("dense", "sparse_set")}
                nbytes = p_.numel() * p_.element_size()
                dense_s, sparse_s = split_costs(nbytes, ids_.numel())
                planner[shape] = {
                    "table_bytes": nbytes, "ids": ids_.numel(), "ms": ms,
                    "faster": min(ms, key=ms.get),
                    "planned": plan_strategy(nbytes, ids_.numel()),
                    "model_ms": {"dense": dense_s * 1e3,
                                 "sparse_set": sparse_s * 1e3}}
                del acc_, g_
            del shapes
            require(planner["bench_ranking"]["planned"] ==
                    planner["bench_ranking"]["faster"],
                    f"the planner's choice at bench_ranking is not the faster "
                    f"strategy: {planner['bench_ranking']}")
            # dense: seconds per table byte, least squares through 0 over the
            # two tables; sparse_set: a line over the three id counts
            by = [(planner[k]["table_bytes"], planner[k]["ms"]["dense"] / 1e3)
                  for k in ("bench_recall", "bench_ranking")]
            per_byte = sum(b * t for b, t in by) / sum(b * b for b, _ in by)
            slope, icpt = np.polyfit(
                [planner[k]["ids"] for k in names],
                [planner[k]["ms"]["sparse_set"] / 1e3 for k in names], 1)
            planner["fit"] = {"dense_s_per_byte": per_byte,
                              "sparse_s_per_id": float(slope),
                              "sparse_fixed_s": float(icpt)}
        peak_gb = torch.cuda.max_memory_allocated() / 1e9 if not rehearse \
            else None
        # where a step's time goes: 10 steps per split strategy under
        # torch.profiler (wall and device-busy ms per step, idle share)
        profiled = None
        if not rehearse:
            from recommendflow_tpu_torch.tools.profile_slice import (
                profile_training)
            profiled = {st["mode"]: {k: st[k] for k in (
                "per_step_wall_ms", "per_step_device_ms", "idle_share",
                "host_syncs_per_step", "top_ms", "port_kernels")}
                for st in profile_training(
                    model, dev, 10, batch=RK["batch"],
                    modes=(("split", "dense"), ("split", "sparse_set")))}
        log("ranking", config=os.path.basename(RANK_CONF) if not rehearse
            else os.path.basename(DEMO_RANK_CONF) + " (Dcn)",
            table=list(rtable.shape), table_dtype=str(rtable.dtype),
            batch=RK["batch"], serve_rows=n_rows,
            serve_ms_per_batch=serve_s / RK["serve_batches"] * 1e3,
            cpu_vs_card_logit=cpu_err, cpu_tolerance=RANK_CPU_TOL,
            dropout=float(model.deep.drop.p) if model.deep.drop else 0.0,
            runs=per_run, launches=launches["ranking"],
            update_check=update_check, planner=planner, profiled=profiled,
            host_waits={what: 0 for what in no_wait}, peak_mem_gb=peak_gb)
        del model, state, trainer, eval_ds, rtable
        if not rehearse:
            torch.cuda.empty_cache()

    # ----------------------------------------------------- 11. ranking_zoo
    if "ranking_zoo" in phases:
        zconf = Configuration(DEMO_RANK_CONF)
        zoo = {}
        for name, (path, kw) in ZOO.items():
            model, _ = build_network(path, {"conf": zconf, "device": dev,
                                            "seed": 0, **kw})
            zb = [synthetic_batch(model.schema, 256, seed=600 + i)
                  for i in range(4)]
            reset_counts()
            state, losses = None, []
            for strategy, b in zip(("dense", "dense", "sparse_set"), zb):
                trainer = Trainer(model, split_strategy=strategy, device=dev,
                                  seed=0)
                if state is None:
                    state = trainer.init_state(b)
                else:
                    trainer.plan(b)
                state, m = trainer.train_step(state, b)
                losses.append(float(m["loss"]))
            counts = read_counts()
            require(all(math.isfinite(x) for x in losses), f"{name}: {losses}")
            require(all(counts[k] > 0 for k in (
                "gather_rows", "scatter_add_rows", "rowwise_adagrad_update",
                "sparse_adagrad_apply")) or rehearse,
                    f"{name}: a kernel was not launched: {counts}")
            cpu_model = copy.deepcopy(model).to("cpu").eval()
            model.eval()
            with torch.no_grad():
                got = model(to_device(zb[3], dev))
                ref = cpu_model(to_device(zb[3], torch.device("cpu")))
            require(sorted(got) == sorted(ref), f"{name}: outputs {sorted(got)}")
            err = max(float((got[k].cpu() - ref[k]).abs().max()) for k in ref)
            require(err <= ZOO_CPU_TOL, f"{name}: eval on the card vs the CPU "
                    f"{err} > {ZOO_CPU_TOL}")
            zoo[name] = {"losses": losses, "launches": counts,
                         "outputs": sorted(got), "cpu_vs_card": err}
            del model, cpu_model, state, trainer, got, ref
        log("ranking_zoo", config=os.path.basename(DEMO_RANK_CONF), batch=256,
            tolerance=ZOO_CPU_TOL, models=zoo)

    # ------------------------------------------------- 12-13. quantized search
    # benchmarks/bench_quantized_search.py's configuration: 10M x 128 on the
    # card, toy sizes in the rehearsal (still past _HIER_MIN_ITEMS)
    Q = dict(n=10_000_000, q=2048, check_q=256, reps=5, ann_n=1 << 20,
             nlist=4096, nprobe=32) if not rehearse else \
        dict(n=300_000, q=64, check_q=32, reps=1, ann_n=20_000, nlist=64,
             nprobe=8)
    f64 = torch.float64
    qcorpus = None
    if any(p in phases for p in QUANT_PHASES):
        t0 = time.perf_counter()
        qcorpus = make_corpus(np, Q["n"], 128)
        corpus_gen_s = time.perf_counter() - t0

    def run_index(index_param, items, queries, **kw):
        """Build through EncoderSearcher (array mode, ip), warm up, then one
        search of every query with the counts reset just before it and read
        just after, and Q["reps"] more for the time."""
        t0 = time.perf_counter()
        es = EncoderSearcher(items=items, index_param=index_param,
                             measurement="ip", device=dev, **kw).train()
        sync()
        build_s = time.perf_counter() - t0
        es.search(queries[:64], topK=K)
        reset_counts()
        sync()
        t0 = time.perf_counter()
        ids, sims = es.search(queries, topK=K)
        sync()
        first_s = time.perf_counter() - t0
        counts = read_counts()
        times = []
        for _ in range(Q["reps"]):
            sync()
            t0 = time.perf_counter()
            es.search(queries, topK=K)
            sync()
            times.append(time.perf_counter() - t0)
        med = sorted(times)[len(times) // 2]
        return es, ids, sims, {"build_s": build_s, "first_search_s": first_s,
                               "search_ms": med * 1e3,
                               "qps": len(queries) / med, "launches": counts}

    def blocks_f64(x_np, rows=1 << 20):
        """(start, rows of an [N, D] numpy array as f64 on the card)."""
        for s0 in range(0, len(x_np), rows):
            yield s0, torch.from_numpy(x_np[s0:s0 + rows]).to(dev).to(f64)

    def exact_scan(q64, blocks):
        """Plain top-K of q·x over row blocks, in f64."""
        best = None
        for s0, xb in blocks:
            best = merge_topk(torch, best, q64 @ xb.T, s0, K)
        return best

    def rows_score(q64, x_of):
        """score_of for check_topk: q·x of the ids, in f64."""
        return lambda ids: torch.einsum("qd,qkd->qk", q64, x_of(ids))

    if "sq_search" in phases:
        queries = bench_queries(np, qcorpus, Q["q"])
        cq = Q["check_q"]
        q32 = torch.from_numpy(queries[:cq]).to(dev)
        q64 = q32.to(f64)
        res, checks = {}, {}
        flat, gt, _, res["Flat"] = run_index("Flat", qcorpus, queries)
        require(res["Flat"]["launches"]["grouped_score_max"] ==
                -(-Q["q"] // flat.index.query_block) or rehearse,
                f"Flat launches {res['Flat']['launches']}")
        ref_s, ref_i = exact_scan(q64, blocks_f64(qcorpus))
        x_dev = flat.index._vecs
        fs, fi = flat.index.search(queries[:cq], K, return_items=False)
        checks["Flat"] = check_topk(
            torch, "Flat", fs, fi, ref_s, ref_i,
            rows_score(q64, lambda ids: x_dev[ids].to(f64)))
        del flat, x_dev
        for spec in ("SQ8", "SQbf16"):
            es, ids, _, res[spec] = run_index(spec, qcorpus, queries)
            idx = es.index
            n_blocks = -(-Q["q"] // idx.query_block)
            form = "grouped_score_max_uint8" if spec == "SQ8" else \
                "grouped_score_max_bf16"
            got = res[spec]["launches"]
            require(rehearse or (got[form] == n_blocks and
                                 got["grouped_score_max"] == n_blocks),
                    f"{spec}: {form} launched {got}, not once per query "
                    f"block ({n_blocks})")
            launches["sq_search" if spec == "SQ8" else "sq_search_bf16"] = got
            # the tournament's function in plain f64: the K best groups of
            # bf16(q ⊙ scale)·codes, their items rescored by q·x̂
            codes, n_items = idx._codes, idx.num_items
            sq8 = spec == "SQ8"
            vmin = idx._vmin.to(f64) if sq8 else torch.zeros(128, dtype=f64,
                                                               device=dev)
            scl = idx._scale if sq8 else torch.ones(128, device=dev)
            qb = (q32 * scl).to(torch.bfloat16).to(f64)
            m1, exact = [], None
            for s0 in range(0, codes.shape[0], 1 << 20):
                c = codes[s0:s0 + (1 << 20)].to(f64)
                m = qb @ c.T
                m[:, max(0, n_items - s0):] = -math.inf
                m1.append(m.view(cq, -1, G).amax(-1))
                x = q64 @ (vmin + scl.to(f64) * c).T
                x[:, max(0, n_items - s0):] = -math.inf
                exact = merge_topk(torch, exact, x, s0, K)
                del c, m, x
            m1 = torch.cat(m1, 1)
            g_top = torch.topk(m1, K, dim=1)
            cand = (g_top.indices[:, :, None] * G + torch.arange(G, device=dev)
                    ).reshape(cq, K * G)

            def xhat(ids, codes=codes, vmin=vmin, scl=scl):
                return vmin + scl.to(f64) * codes[ids].to(f64)

            cs = torch.einsum("qd,qkd->qk", q64, xhat(cand))
            cs[cand >= n_items] = -math.inf
            rs, rp = torch.topk(cs, K, dim=1)
            ri = torch.gather(cand, 1, rp)
            kth_group = g_top.values[:, -1]

            def group_near(r, ids, m1=m1, kth_group=kth_group):
                gm = m1[r, ids // G]
                return (gm - kth_group[r]).abs() <= \
                    SEARCH_RTOL * kth_group[r].abs().clamp(min=1.0)

            ss, si = idx.search(queries[:cq], K, return_items=False)
            checks[spec] = check_topk(torch, spec, ss, si, rs, ri,
                                      rows_score(q64, xhat), group_near)
            checks[spec]["recall_vs_exact_xhat"] = recall_at_k(
                si, exact[1].cpu().numpy())
            res[spec]["recall@100_vs_flat"] = recall_at_k(ids, gt)
            res[spec]["code_gb"] = codes.numel() * codes.element_size() / 1e9
            del es, idx, codes, m1, cs
        sync()
        log("sq_search", n=Q["n"], d=128, queries=Q["q"], k=K,
            checked_queries=cq, corpus_gen_s=corpus_gen_s, tolerance=SEARCH_RTOL,
            results=res, checks=checks,
            peak_mem_gb=(torch.cuda.max_memory_allocated() / 1e9
                         if not rehearse else None))
        if not rehearse:
            torch.cuda.empty_cache()

    if "ann" in phases:
        # the bench run at --n 1,048,576: the generator's first chunk is the
        # first 1,048,576 rows of the 10M corpus; queries drawn from it
        sub = qcorpus[:Q["ann_n"]]
        queries = bench_queries(np, sub, Q["q"])
        cq = Q["check_q"]
        q32 = torch.from_numpy(queries[:cq]).to(dev)
        q64 = q32.to(f64)
        res, checks = {}, {}
        _, gt, _, res["Flat"] = run_index("Flat", sub, queries)
        exact_s, exact_i = exact_scan(q64, blocks_f64(sub))
        sub_dev = torch.from_numpy(sub).to(dev)
        ann = (("IVF%d" % Q["nlist"], {"nprobe": Q["nprobe"]}),
               ("PQ16", {"query_block": 4096}),
               ("IVF%d,PQ16" % Q["nlist"], {"nprobe": Q["nprobe"]}))
        for spec, kw in ann:
            es, ids, _, res[spec] = run_index(spec, sub, queries, **kw)
            res[spec]["recall@100_vs_flat"] = recall_at_k(ids, gt)
            idx = es.index
            if spec.startswith("IVF") and "PQ" not in spec:
                # nprobe = nlist scans every item: the exact search
                idx.nprobe = idx.nlist
                s_, i_ = idx.search(queries[:cq], K, return_items=False)
                idx.nprobe = kw["nprobe"]
                checks[spec + "@full_probe"] = check_topk(
                    torch, spec, s_, i_, exact_s, exact_i,
                    rows_score(q64, lambda ids: sub_dev[ids].to(f64)))
            elif spec == "PQ16":
                # a plain scan of the corpus as the scan decodes it
                cb16 = idx._codebooks.to(torch.bfloat16).to(f64)
                m_ar = torch.arange(cb16.shape[0], device=dev)

                def dec(ids, cb16=cb16, m_ar=m_ar, codes=idx._codes):
                    return cb16[m_ar, codes[ids].long()].flatten(-2)

                ref = None
                for s0 in range(0, len(sub), 1 << 18):
                    ids_b = torch.arange(s0, min(len(sub), s0 + (1 << 18)),
                                         device=dev)
                    ref = merge_topk(torch, ref, q64 @ dec(ids_b).T, s0, K)
                s_, i_ = idx.search(queries[:cq], K, return_items=False)
                checks[spec] = check_topk(torch, spec, s_, i_, *ref,
                                          rows_score(q64, dec))
            else:
                # full probe against the IVF-PQ score in plain f64: the bf16
                # lookup tables of q_s·codebook_s plus q·c for list members,
                # q·x̂ (decoded in f32) for the overflow pool
                msub = idx.num_subspaces
                lut = torch.einsum("qsd,skd->qsk", q32.view(cq, msub, -1),
                                   idx._codebooks).to(torch.bfloat16).to(f64)
                qc = q64 @ idx._centroids.to(f64).T
                assign = torch.from_numpy(idx._assign.astype(np.int64)).to(dev)
                over = torch.zeros(len(sub), dtype=torch.bool, device=dev)
                over[torch.from_numpy(idx._overflow_idx).to(dev)] = True
                over_of = torch.full((len(sub),), -1, dtype=torch.long,
                                     device=dev)
                over_of[torch.from_numpy(idx._overflow_idx).to(dev)] = \
                    torch.arange(len(idx._overflow_idx), device=dev)
                over_s = q64 @ idx._overflow_dec.to(f64).T
                m_ar = torch.arange(msub, device=dev)

                def ivfpq_score(ids, lut=lut, qc=qc, assign=assign,
                                over=over, over_of=over_of, over_s=over_s,
                                codes=idx._codes):
                    rows = torch.arange(cq, device=dev)[:, None]
                    c = codes[ids].long()                  # [cq, n, M]
                    s_ = lut[rows[:, :, None], m_ar, c].sum(-1) + \
                        qc[rows, assign[ids]]
                    if over_s.shape[1] == 0:
                        return s_
                    return torch.where(over[ids], over_s[rows, over_of[ids]
                                                         .clamp(min=0)], s_)

                ref = None
                for s0 in range(0, len(sub), 1 << 16):
                    ids_b = torch.arange(s0, min(len(sub), s0 + (1 << 16)),
                                         device=dev)
                    ref = merge_topk(torch, ref, ivfpq_score(
                        ids_b[None, :].expand(cq, -1)), s0, K)
                idx.nprobe = idx.nlist
                s_, i_ = idx.search(queries[:cq], K, return_items=False)
                idx.nprobe = kw["nprobe"]
                checks[spec + "@full_probe"] = check_topk(
                    torch, spec, s_, i_, *ref, ivfpq_score)
            del es, idx
        sync()
        log("ann", n=len(sub), d=128, queries=Q["q"], k=K, checked_queries=cq,
            nlist=Q["nlist"], nprobe=Q["nprobe"], tolerance=SEARCH_RTOL,
            results=res, checks=checks,
            peak_mem_gb=(torch.cuda.max_memory_allocated() / 1e9
                         if not rehearse else None))
        del sub_dev
    del qcorpus
    if not rehearse:
        torch.cuda.empty_cache()

    # --------------------------------------------------------- 14. encode
    if "encode" in phases:
        t0 = time.perf_counter()
        service = encoder_service()
        load_s = time.perf_counter() - t0
        service.warmup()
        if not rehearse:
            torch.cuda.reset_peak_memory_stats()
        reset_counts()
        sync()
        t0 = time.perf_counter()
        emb = service.encode(texts)
        sync()
        encode_s = time.perf_counter() - t0
        launches["encode"] = read_counts()
        n_batches = -(-len(texts) // E["batch"])
        require(launches["encode"]["flash_attention"] == layers * n_batches
                or rehearse, f"flash_attention launched "
                f"{launches['encode']['flash_attention']} times on the encode "
                f"path, not {layers} x {n_batches} batches")
        require(emb.shape == (len(texts), cfg["hidden_size"]),
                f"encode shape {emb.shape}")
        require(bool(np.isfinite(emb).all()), "non-finite text vectors")
        norm_err = float(np.abs(np.linalg.norm(emb, axis=1) - 1.0).max())
        require(norm_err <= 1e-4, f"text vectors not unit ({norm_err})")
        again = service.encode(texts[:1000])
        cache_equal = bool(np.array_equal(again, emb[:1000]))
        require(cache_equal, "the cache returned other rows")
        # the model's vectors on the card against the CPU's plain path
        few = texts[:8]
        cpu_svc = TextEncoderService.from_pretrained(
            *bert_files, max_len=64, batch_size=len(few), device="cpu")
        cpu_err = float(np.abs(service._encode_raw(few)
                               - cpu_svc._encode_raw(few)).max())
        del cpu_svc
        require(cpu_err <= ENCODE_CPU_TOL, f"encode on the card vs the CPU: "
                f"{cpu_err} > {ENCODE_CPU_TOL}")
        tok_counts = (tokenizer.encode_batch(texts, 64)[0] > 0).sum(1)
        log("encode", config={k: cfg[k] for k in (
                "vocab_size", "hidden_size", "num_hidden_layers",
                "num_attention_heads", "intermediate_size")},
            texts=len(texts), batch=E["batch"], batches=n_batches,
            tokens={"min": int(tok_counts.min()),
                    "median": float(np.median(tok_counts)),
                    "max": int(tok_counts.max()),
                    "truncated_share": float((tok_counts == 64).mean())},
            load_s=load_s, encode_s=encode_s,
            ms_per_batch_with_fit=encode_s / n_batches * 1e3,
            launches=launches["encode"], unit_norm_err=norm_err,
            cache_equal=cache_equal, cpu_vs_card=cpu_err,
            cpu_tolerance=ENCODE_CPU_TOL,
            peak_mem_gb=(torch.cuda.max_memory_allocated() / 1e9
                         if not rehearse else None))
        del again

    # ---------------------------------------------------------- 15. serve
    serve_latency = None
    if "serve" in phases:
        import threading
        import urllib.request
        from recommendflow_tpu_torch.serving import (EncodeServer,
                                                     RemoteEncoderClient,
                                                     make_server)
        service = encoder_service()
        backend = EncodeServer(service, max_batch=4096, batch_window_ms=4.0)
        httpd = make_server(backend, host="127.0.0.1", port=0)
        server = threading.Thread(target=httpd.serve_forever, daemon=True)
        server.start()
        url = f"http://127.0.0.1:{httpd.server_address[1]}"
        try:
            client = RemoteEncoderClient(url, local=None, request_timeout=120)
            require(client.ping(), "/health did not answer ok")
            with urllib.request.urlopen(url + "/health", timeout=60) as r:
                health = json.loads(r.read())
            require(health["device"] == str(dev) and (
                rehearse or health["card"] == kind), f"/health {health}")
            fresh = [t for t in enc_syn.make_texts(
                E["serve_clients"] * 2 * E["serve_texts"]
                + 2 * E["latency_reps"], seed=2) if t not in service._cache]
            n_conc = E["serve_clients"] * 2 * E["serve_texts"]
            conc, single = fresh[:n_conc], fresh[n_conc:]
            results, failures = {}, []

            def serve_client(c):
                for r in range(2):
                    at = (c * 2 + r) * E["serve_texts"]
                    try:
                        results[at] = client.encode(
                            conc[at:at + E["serve_texts"]])
                    except Exception as e:  # noqa: BLE001 — reported below
                        failures.append(repr(e))

            batches_before = backend._batcher.batches_run
            reset_counts()
            threads = [threading.Thread(target=serve_client, args=(c,))
                       for c in range(E["serve_clients"])]
            t0 = time.perf_counter()
            for t in threads:
                t.start()
            for t in threads:
                t.join()
            conc_s = time.perf_counter() - t0
            require(not failures, f"/encode requests failed: {failures[:3]}")
            conc_batches = backend._batcher.batches_run - batches_before
            lat_one, lat_batch = [], []
            for i in range(E["latency_reps"]):
                t0 = time.perf_counter()
                results[n_conc + i] = client.encode([single[i]])
                lat_one.append((time.perf_counter() - t0) * 1e3)
            block = single[E["latency_reps"]:]
            t0 = time.perf_counter()
            results[n_conc + E["latency_reps"]] = client.encode(block)
            lat_batch.append((time.perf_counter() - t0) * 1e3)
            serve_launches = read_counts()["flash_attention"]
            require(serve_launches > 0 or rehearse,
                    "the served texts were not encoded on the card")
            served = np.concatenate([results[k] for k in sorted(results)])
            direct = service.encode(conc + single)
            serve_err = float(np.abs(served - direct).max())
            require(served.dtype == np.float32 and
                    bool(np.array_equal(served, direct)),
                    f"served vectors differ from a direct encode: {serve_err}")
            serve_latency = {"one_text_ms_median": sorted(lat_one)[len(lat_one) // 2],
                             "one_text_ms": lat_one,
                             f"{len(block)}_texts_ms": lat_batch[0]}
            with urllib.request.urlopen(url + "/health", timeout=60) as r:
                health = json.loads(r.read())
        finally:
            httpd.shutdown()
            httpd.server_close()
            backend.close()
            server.join(timeout=10)
        log("serve", health=health, concurrent_requests=2 * E["serve_clients"],
            texts_per_request=E["serve_texts"], concurrent_s=conc_s,
            concurrent_encode_calls=conc_batches,
            flash_attention_launches=serve_launches,
            served_vs_direct=serve_err, latency=serve_latency)

    # ------------------------------------------------------ 16. text_search
    if "text_search" in phases:
        service = encoder_service()
        if emb is None:
            emb = service.encode(texts)
        t0 = time.perf_counter()
        es = EncoderSearcher(items=emb, index_param="SQ8", measurement="cos",
                             device=dev).train()
        sync()
        build_s = time.perf_counter() - t0
        qv = service.encode(texts)           # the service's own encode
        reset_counts()
        sync()
        t0 = time.perf_counter()
        ids, sims = es.search(qv, topK=10)
        sync()
        search_s = time.perf_counter() - t0
        hit = (ids == np.arange(len(texts))[:, None]).any(1)
        require(bool(hit.all()), f"text_search: {int((~hit).sum())} texts "
                f"missing from their own top-10")
        log("text_search", items=len(emb), dim=int(emb.shape[1]),
            index="SQ8", metric="cos", build_s=build_s, search_s=search_s,
            self_in_top10=float(hit.mean()),
            self_at_rank0=float((ids[:, 0] == np.arange(len(texts))).mean()),
            tournament=es.index._codes.shape[0] >= _kernels._HIER_MIN_ITEMS,
            launches=read_counts())
        del es

    # ------------------------------------------------------------ 17. cli
    if "cli" in phases:
        from recommendflow_tpu_torch.cli import evaluate as eval_cli
        from recommendflow_tpu_torch.cli import predict as pred_cli
        from recommendflow_tpu_torch.cli import train as train_cli
        from recommendflow_tpu_torch.train.checkpoint import read_checkpoint
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
            # train, then predict from the checkpoint it saved
            res = train_cli.main([DEMO_CONF, "--data", data, "--train_mode",
                                  "test", "--device", str(dev),
                                  "--batch_size", str(min(256, n // 8)),
                                  "--model_save_root", os.path.join(tmp, "m")])
            final = os.path.join(tmp, "m", "ckpt", "final.pt")
            hist = res["history"][-1]
            require(math.isfinite(hist["loss"]), f"train CLI logs {hist}")
            outs2 = pred_cli.main([DEMO_CONF, "--data", data, "--checkpoint",
                                   final, "--out", os.path.join(tmp, "p2.npz"),
                                   "--device", str(dev)])
            model.load_state_dict(read_checkpoint(final)["model"])
            direct2 = predict(model, ds, dev)
            diff2 = max(float(np.abs(outs2[k] - direct2[k]).max())
                        for k in ("user", "ad"))
            require(diff2 <= 1e-5, f"predict CLI on the trained checkpoint vs "
                    f"the model: {diff2}")
            del model
            # a ranking model (demo_ranking's Dnn): cli/train monitoring
            # val_auc, then cli/evaluate and cli/predict on its checkpoint
            rdemo = Configuration(DEMO_RANK_CONF)
            generate_records(rdemo, os.path.join(tmp, "rrec"),
                             num_rows=S["cli_rows"], num_files=2)
            rdata = os.path.join(tmp, "rrec", "*.rfb")
            rres = train_cli.main([
                DEMO_RANK_CONF, "--data", rdata, "--train_mode", "test",
                "--device", str(dev), "--batch_size", str(min(256, n // 8)),
                "--monitor", "val_auc", "--model_save_root",
                os.path.join(tmp, "rm")])
            rhist = rres["history"][-1]
            require(math.isfinite(rhist["loss"]) and
                    0.0 <= rhist.get("val_auc", -1.0) <= 1.0,
                    f"ranking train CLI logs {rhist}")
            rfinal = os.path.join(tmp, "rm", "ckpt", "final.pt")
            rmetrics = eval_cli.main([DEMO_RANK_CONF, "--data", rdata,
                                      "--checkpoint", rfinal, "--device",
                                      str(dev)])
            require(0.0 <= rmetrics["auc"] <= 1.0,
                    f"ranking evaluate CLI {rmetrics}")
            routs = pred_cli.main([DEMO_RANK_CONF, "--data", rdata,
                                   "--checkpoint", rfinal, "--out",
                                   os.path.join(tmp, "rp.npz"), "--device",
                                   str(dev)])
            rds, _ = make_dataset(rdemo, rdata, 2048, shuffle=False,
                                  drop_remainder=False)
            rdirect = predict(rres["state"].model, rds, dev)
            rdiff = float(np.abs(routs["score"] - rdirect["score"]).max())
            require(routs["score"].shape == (n,) and rdiff <= 1e-5,
                    f"ranking predict CLI vs the trained model: {rdiff}")
            del rres
            # cli/encode at its own widths, weights saved by the service
            from recommendflow_tpu_torch.cli import encode as encode_cli
            vocab_path = os.path.join(tmp, "vocab.txt")
            with open(vocab_path, "w") as f:
                f.write("\n".join(vocab) + "\n")
            widths = ["--model_dim", "256", "--num_layers", "4"]
            enc_svc = TextEncoderService(Tokenizer(vocab_path), max_len=64,
                                         use_whitening=True, model_dim=256,
                                         num_layers=4, device=dev, seed=1)
            cli_texts = texts[:E["cli_texts"]]
            enc_ref = enc_svc.encode(cli_texts)
            enc_svc.save(os.path.join(tmp, "encoder"))
            with open(os.path.join(tmp, "texts.txt"), "w") as f:
                f.write("\n".join(cli_texts) + "\n")
            enc_out = encode_cli.main([
                "--vocab", vocab_path, "--input", os.path.join(tmp, "texts.txt"),
                "--out", os.path.join(tmp, "emb.npz"), "--weights",
                os.path.join(tmp, "encoder"), "--whitening", "--device",
                str(dev), *widths])
            require(enc_out.shape == (len(cli_texts), 256) and
                    bool(np.isfinite(enc_out).all()),
                    f"encode CLI output {enc_out.shape}")
            enc_diff = float(np.abs(enc_out - enc_ref).max())
            require(enc_diff <= CLI_TOL, f"encode CLI vs its service: "
                    f"{enc_diff}")
            del enc_svc
        log("cli", rows=n, evaluate_metrics=metrics, predict_vs_model=diff,
            train_cli={k: v for k, v in hist.items()
                       if k in ("loss", "examples_per_sec", "val_hit@5")},
            trained_predict_vs_model=diff2,
            ranking_cli={"train": {k: v for k, v in rhist.items() if k in (
                "loss", "examples_per_sec", "val_auc")},
                "evaluate": rmetrics, "predict_vs_model": rdiff},
            encode_cli_texts=len(cli_texts), encode_cli_vs_service=enc_diff)

    # ---------------------------------------------------------- 18. times
    kernels = []
    if "times" in phases and not rehearse:
        timer = Timer(torch, S["reps"])
        row = {}

        def add(name, ms, plain_ms, library_ms, bytes_, ops=0.0, peak=None,
                **extra):
            t_bytes, t_ops = bytes_ / bw, ops / (peak or flops)
            kernels.append(dict(
                name=name, **KERNEL_META[name],
                launches=launches[KERNEL_PATH[name]].get(name, 0),
                launches_by_path={p: c.get(name, 0) for p, c in launches.items()},
                max_abs_err=errs.get(name), ms=ms, plain_ms=plain_ms,
                bound_ms=max(t_bytes, t_ops) * 1e3,
                bound_by="operations" if t_ops > t_bytes else "bytes",
                library_ms=library_ms, **extra))
            row[name] = {"bytes": bytes_, "ops": ops}

        def table_kernel_times(stored_, upd_, acc_, gd_):
            """Kernels 2-4 at one table's shape, on one batch's update (each
            timed call updates its table in place, as the trainer's does).
            {name: (ms, plain ms, library ms or None, bytes)}."""
            u, sm, nv = upd_["uid"], upd_["summed"], upd_["n_valid"]
            n_u = int(nv)
            n_t = int(upd_["touched"].sum())
            R_, W = stored_.shape
            uv, smv = u[:n_u].long(), sm[:n_u]
            out = {}
            out["scatter_add_rows"] = (
                timer.median_ms(lambda i: k_rows.scatter_add_rows(u, sm, gd_,
                                                                  nv)),
                timer.median_ms(lambda i: k_rows.scatter_add_rows_plain(
                    u, sm, gd_, nv)),
                timer.median_ms(lambda i: gd_.index_add_(0, uv,
                                                         smv.to(gd_.dtype))),
                n_u * (4 + W * 4 + 2 * W * 2) + 4)
            p_t, a_t = stored_.clone(), acc_.clone()
            out["rowwise_adagrad_update"] = (
                timer.median_ms(lambda i: k_dense.rowwise_adagrad_update(
                    p_t, a_t, gd_, lr=LR)),
                timer.median_ms(lambda i: k_dense.rowwise_adagrad_update_plain(
                    p_t, a_t, gd_, lr=LR)),
                None,
                # g and acc read whole; p read and written, acc written,
                # only where the gradient is not zero (the touched rows)
                R_ * W * 2 + R_ * 4 + n_t * (2 * W * 2 + 4))
            out["sparse_adagrad_apply"] = (
                timer.median_ms(lambda i: k_sparse.sparse_adagrad_apply(
                    p_t, a_t, u, sm, nv, lr=LR)),
                timer.median_ms(lambda i: k_sparse.sparse_adagrad_apply_plain(
                    p_t, a_t, u, sm, nv, lr=LR)),
                None,
                n_u * (4 + W * 4 + 2 * W * 2 + 2 * 4) + 4)
            return out, {"table": [R_, W], "unique_stored_rows": n_u,
                         "touched_stored_rows": n_t}

        # kernel 1 at every phase-2 shape, one batch's ids a timed call: the
        # median of single calls between two events (as every kernel here)
        # and the mean of reps calls between two events; its launches at
        # that row width on the path that runs the shape
        table32 = ranking_table()
        shape_path = {"recall_serving": "slice", "recall_split": "train",
                      "ranking_serving": "ranking",
                      "ranking_serving_zipf1.2": "ranking",
                      "ranking_split": "ranking"}
        gather_times = {}
        for name, (table_, ids_) in gather_cases(table32, 20_000,
                                                 S["reps"]).items():
            row_b = table_.shape[1] * table_.element_size()
            n_ids, uniq = ids_[0].numel(), torch.unique(ids_[0]).numel()
            nbytes = uniq * row_b + n_ids * row_b + n_ids * 4
            call = (lambda i, t=table_, x=ids_: k_rows.launch_gather_rows(
                t, x[i], check_ids=False))
            ms = timer.median_ms(call)
            batched = timer.batched_ms(call)
            bound = nbytes / bw * 1e3
            gather_times[name] = {
                "table": list(table_.shape), "row_bytes": row_b,
                "ids": n_ids, "unique_rows": uniq, "bytes": nbytes,
                "ms": ms, "batched_ms": batched, "bound_ms": bound,
                "bound_by": "bytes", "share_of_bound": bound / ms,
                "share_of_bound_batched": bound / batched,
                "plain_ms": timer.median_ms(
                    lambda i, t=table_, x=ids_: k_rows.gather_rows_plain(
                        t, x[i])),
                "library_ms": timer.median_ms(
                    lambda i, t=table_, x=ids_: torch.index_select(
                        t, 0, x[i])),
                "launches": launches[shape_path[name]].get(
                    "gather_rows_by_row_bytes", {}).get(row_b, 0)}
        rs = gather_times["recall_serving"]
        add("gather_rows", rs["ms"], rs["plain_ms"], rs["library_ms"],
            rs["bytes"], shapes=gather_times)
        # kernels 2-4 at the bench_recall shape (phases 4-6): the kernels
        # line
        recall_times, recall_shape = table_kernel_times(stored, upd, acc0, gd)
        for name in ("scatter_add_rows", "rowwise_adagrad_update",
                     "sparse_adagrad_apply"):
            add(name, *recall_times[name])
        # and at the bench_ranking shape
        stored32 = table32.view(-1, 256)
        upd32 = update_inputs(10_003, **rank)
        gd32 = torch.zeros_like(stored32)
        k_rows.scatter_add_rows(upd32["uid"], upd32["summed"], gd32,
                                upd32["n_valid"])
        acc32 = torch.rand((stored32.shape[0], 1), generator=gen,
                           device=dev) + 0.1
        rank_times, rank_shape = table_kernel_times(stored32, upd32, acc32,
                                                    gd32)
        ranking_shape = {"shape": rank_shape, **{
            name: {"ms": ms, "plain_ms": plain, "library_ms": lib,
                   "bound_ms": nbytes / bw * 1e3, "bound_by": "bytes",
                   "bytes": nbytes}
            for name, (ms, plain, lib, nbytes) in rank_times.items()}}
        del table32, stored32, upd32, gd32, acc32

        nq, n_pad, d = S["q"], S["n_pad"], S["d"]
        add("grouped_score_max",
            timer.median_ms(lambda i: k_scan.launch_grouped_score_max(
                q, corpus, None, group=G, num_items=num_items)),
            timer.median_ms(lambda i: k_scan.grouped_score_max_plain(
                q, corpus, None, group=G, num_items=num_items), SCAN_REPS),
            timer.median_ms(lambda i: torch.matmul(q, corpus.T).view(
                nq, n_pad // G, G).amax(dim=-1), SCAN_REPS),
            4 * (nq * d + n_pad * d + nq * (n_pad // G)),
            ops=2.0 * nq * num_items * d)
        # the uint8 form on phase 3's SQ8 codes; its products are bf16 x
        # bf16 (queries rounded to bf16, codes <= 255), so its bound is the
        # bf16 tensor-core rate. The library call multiplies the rounded
        # queries with the widened codes, then takes the group max.
        qs_b, codes_f = qs_u.to(torch.bfloat16).float(), codes_u.float()
        add("grouped_score_max_uint8",
            timer.median_ms(lambda i: k_scan.launch_grouped_score_max(
                qs_u, codes_u, None, group=G, num_items=num_items)),
            timer.median_ms(lambda i: k_scan.grouped_score_max_plain(
                qs_u, codes_u, None, group=G, num_items=num_items), SCAN_REPS),
            timer.median_ms(lambda i: torch.matmul(qs_b, codes_f.T).view(
                nq, n_pad // G, G).amax(dim=-1), SCAN_REPS),
            n_pad * d + 4 * (nq * d + nq * (n_pad // G)),
            ops=2.0 * nq * num_items * d, peak=bf16_tc)
        del qs_b, codes_f
        # kernel 5's bf16 form does the same bf16 x bf16 work on the bf16
        # corpus; the library call multiplies the rounded queries with the
        # widened corpus, then takes the group max
        corpus_b = corpus.to(torch.bfloat16)
        q_b, corpus_bf = q.to(torch.bfloat16).float(), corpus_b.float()
        add("grouped_score_max_bf16",
            timer.median_ms(lambda i: k_scan.launch_grouped_score_max(
                q, corpus_b, None, group=G, num_items=num_items)),
            timer.median_ms(lambda i: k_scan.grouped_score_max_plain(
                q, corpus_b, None, group=G, num_items=num_items), SCAN_REPS),
            timer.median_ms(lambda i: torch.matmul(q_b, corpus_bf.T).view(
                nq, n_pad // G, G).amax(dim=-1), SCAN_REPS),
            2 * n_pad * d + 4 * (nq * d + nq * (n_pad // G)),
            ops=2.0 * nq * num_items * d, peak=bf16_tc)
        del corpus_b, q_b, corpus_bf

        # flash_attention at the encoder's shape, f32, a batch's key mask
        qp, kp, vp = path_qkv(torch.float32)
        nb, nl = E["batch"], 64
        add("flash_attention",
            timer.median_ms(lambda i: k_fa.launch_flash_attention(
                qp, kp, vp, fa_mask)),
            timer.median_ms(lambda i: k_fa.flash_attention_plain(
                qp, kp, vp, fa_mask)),
            timer.median_ms(lambda i: torch.nn.functional
                            .scaled_dot_product_attention(
                                qp, kp, vp, attn_mask=fa_mask[:, None, None, :])),
            4 * (4 * nb * heads * nl * head_dim) + nb * nl,
            ops=4.0 * nb * heads * nl * nl * head_dim)
        del qp, kp, vp
        # the encode path: steady wall time, then a profiled window
        from recommendflow_tpu_torch.tools.profile_slice import profile_encode
        service = encoder_service()
        chunk = texts[:16 * E["batch"]]
        service._encode_raw(chunk[:E["batch"]])
        sync()
        t0 = time.perf_counter()
        service._encode_raw(chunk)
        sync()
        enc_wall = time.perf_counter() - t0
        enc_prof = profile_encode(service, texts, batches=8)
        encode_times = {
            "ms_per_batch": enc_wall / 16 * 1e3,
            "texts_per_s": len(chunk) / enc_wall,
            "profiled": {k: enc_prof[k] for k in (
                "per_batch_wall_ms", "per_batch_device_ms", "idle_share",
                "texts_per_s", "top_ms", "port_kernels")}}
        zero_ms = timer.median_ms(lambda i: gd.zero_())
        # the timing's own floor: two events with nothing between them, and
        # a kernel that does nothing (a zero-cycle spin), timed as above
        floor = {"events_ms": timer.median_ms(lambda i: None),
                 "empty_kernel_ms": timer.median_ms(
                     lambda i: torch.cuda._sleep(0)),
                 "empty_kernel_batched_ms": timer.batched_ms(
                     lambda i: torch.cuda._sleep(0))}
        log("times", card=card, peaks={"bytes_per_s": bw, "fp32_flops": flops,
                                       "bf16_tensor_core_flops": bf16_tc},
            shapes={"gather_rows": gather_times,
                    "grouped_score_max": {"q": nq, "n_pad": n_pad, "d": d},
                    "grouped_score_max_uint8": {"q": nq, "n_pad": n_pad,
                                                "d": d, "codes": "uint8"},
                    "grouped_score_max_bf16": {"q": nq, "n_pad": n_pad,
                                               "d": d, "corpus": "bfloat16"},
                    "flash_attention": [E["batch"], heads, 64, head_dim],
                    "update_ids": upd["n_ids"],
                    **{k: recall_shape[k] for k in (
                        "table", "unique_stored_rows", "touched_stored_rows")}},
            work=row, ranking_shape=ranking_shape, zero_fill_ms=zero_ms,
            timing_floor=floor,
            zero_fill_bound_ms=stored.numel() * 2 / bw * 1e3,
            library_ms_note={"rowwise_adagrad_update": "no single PyTorch call",
                             "sparse_adagrad_apply": "no single PyTorch call",
                             "flash_attention": "scaled_dot_product_attention "
                             "with the boolean key mask"},
            encode=encode_times, serve_latency=serve_latency,
            reps=S["reps"])

    svc = None
    enc_tmp.cleanup()
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
