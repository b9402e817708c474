"""End-to-end cascade on the PyTorch port: matching -> (pre)ranking over the
retrieved candidates (the counterpart of examples/cascade_demo.py).

  1. train the two-tower recall model (Dssm, conf/demo_recall.yaml) and
     predict user and item vectors of the evaluation rows;
  2. index the de-duplicated positive item vectors in
     FlatSearcher(metric="cos") and retrieve the top 50 per positive query
     (from 262,144 items the search is kernel 5's tournament);
  3. train a Cold preranker on the same interactions and score the
     evaluation rows;
  4. re-order each query's candidates by their cosine plus half a per-item
     prior (the ranker's mean score over the rows whose positive is that
     item; `rerank`) and report stage-1 hit@K against the re-ranked hit@K.

Run (a card by default; the CPU only when asked for):

    python examples/cascade_demo_torch.py [--device cpu] [--data_dir DIR]

`run_cascade` is the same pipeline over any datasets, timed stage by stage
(chip_smoke.py's cascade phase drives it at bench_recall width).
"""
from __future__ import annotations

import argparse
import os
import sys
import tempfile
import time
from typing import Any, Callable, Dict, Iterable, Optional

import numpy as np

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
if ROOT not in sys.path:
    sys.path.insert(0, ROOT)

import torch  # noqa: E402

from recommendflow_tpu_torch.config import Configuration  # noqa: E402
from recommendflow_tpu_torch.device import resolve_device  # noqa: E402

DEMO_CONF = os.path.join(ROOT, "conf", "demo_recall.yaml")
RANKER = "recommendflow_tpu.models.preranking.cold.Cold"
TOPK = 50
PRIOR_WEIGHT = 0.5


def rerank(cand_items: np.ndarray, cand_scores: np.ndarray,
           ranker_score: np.ndarray, inverse: np.ndarray,
           num_items: int) -> np.ndarray:
    """The candidates [Q, k] re-ordered by their stage-1 score plus
    PRIOR_WEIGHT times their item's prior: the mean ranker score over the
    rows whose positive item it is (`inverse[i]`, the corpus index of
    positive row i's item; `ranker_score[i]`, the ranker's score of that
    row). f64 sums, numpy's argsort of the negated blend."""
    item_prior = np.zeros(num_items)
    counts = np.zeros(num_items)
    np.add.at(item_prior, inverse, ranker_score)
    np.add.at(counts, inverse, 1.0)
    item_prior = item_prior / np.maximum(counts, 1.0)
    cand_items = np.asarray(cand_items)
    blended = np.asarray(cand_scores) + PRIOR_WEIGHT * item_prior[cand_items]
    order = np.argsort(-blended, axis=1)
    return np.take_along_axis(cand_items, order, axis=1)


def run_cascade(conf: Configuration, train_ds: Iterable, eval_ds: Iterable,
                device="cuda", recall_kw: Optional[Dict[str, Any]] = None,
                rank_kw: Optional[Dict[str, Any]] = None,
                recall_epochs: int = 2, rank_epochs: int = 1,
                on_stage: Optional[Callable[[str], None]] = None
                ) -> Dict[str, Any]:
    """The four stages over `train_ds` (fit) and `eval_ds` (predicted
    twice: it must iterate twice alike). `recall_kw` and `rank_kw` are
    Dssm's and Cold's keyword arguments (default the JAX demo's narrow
    heads; {} builds each at its own widths). `on_stage(name)` is called
    after each stage. Returns the stages' outputs and seconds (a card's
    work waited for at each stage's end)."""
    from recommendflow_tpu_torch.models.base import build_network
    from recommendflow_tpu_torch.retrieval import (FlatSearcher, click_ranks,
                                                   recall_metrics)
    from recommendflow_tpu_torch.retrieval.eval import build_eval_corpus
    from recommendflow_tpu_torch.train.trainer import Trainer
    dev = resolve_device(device)
    seconds: Dict[str, float] = {}
    clock = [time.perf_counter()]

    def done(stage):
        if dev.type == "cuda":
            torch.cuda.synchronize(dev)
        now = time.perf_counter()
        seconds[stage] = now - clock[0]
        clock[0] = now
        if on_stage is not None:
            on_stage(stage)

    # ---- stage 1: matching
    recall_model, _ = build_network("dssm", {
        "conf": conf, "device": dev,
        **({"tower_units": [64]} if recall_kw is None else recall_kw)})
    t1 = Trainer(recall_model, learning_rate=3e-3, seed=0, device=dev)
    r1 = t1.fit(train_ds, epochs=recall_epochs, verbose=False)
    done("recall_fit")
    out = t1.predict(r1["state"], eval_ds)
    done("recall_predict")
    corpus, inverse, pos = build_eval_corpus(out["user"], out["ad"],
                                             out["label"])
    if corpus is None:
        raise ValueError("the evaluation rows hold no positive")
    queries = np.ascontiguousarray(out["user"][pos])
    searcher = FlatSearcher(corpus.shape[1], metric="cos",
                            device=dev).train(corpus)
    done("corpus")
    k = min(TOPK, len(corpus))
    cand_items, cand_scores, _ = searcher.search(queries, topk=k)
    stage1 = recall_metrics(click_ranks(cand_items, inverse), [5, k])
    done("search")

    # ---- stage 2: a Cold preranker's per-item prior re-orders them
    rank_model, _ = build_network(RANKER, {
        "conf": conf, "device": dev,
        **({"hidden_units": (64,)} if rank_kw is None else rank_kw)})
    t2 = Trainer(rank_model, learning_rate=2e-3, seed=1, device=dev)
    r2 = t2.fit(train_ds, epochs=rank_epochs, verbose=False)
    done("rank_fit")
    rank_out = t2.predict(r2["state"], eval_ds)
    done("rank_predict")
    ranker_score = np.asarray(rank_out["score"])[pos]
    reordered = rerank(cand_items, cand_scores, ranker_score, inverse,
                       len(corpus))
    stage2 = recall_metrics(click_ranks(reordered, inverse), [5, k])
    done("rerank")
    return {"k": k, "stage1": stage1, "stage2": stage2, "rows": len(pos),
            "queries": queries, "corpus": corpus, "inverse": inverse,
            "searcher": searcher, "cand_items": cand_items,
            "cand_scores": cand_scores, "ranker_score": ranker_score,
            "reordered": reordered, "seconds": seconds,
            "recall_steps": r1["state"].step, "rank_steps": r2["state"].step,
            "recall_history": r1["history"], "rank_history": r2["history"]}


def main(device="cuda", data_dir: Optional[str] = None,
         conf: str = DEMO_CONF) -> Dict[str, Any]:
    """The demo on 8,000 synthetic records under `data_dir` (written there
    when it holds none; default a directory under the temporary root)."""
    from recommendflow_tpu_torch.data import (Dataset, compile_schema,
                                              resolve_paths)
    from recommendflow_tpu_torch.data.synthetic import generate_records
    from recommendflow_tpu_torch.utils.tables import print_table
    dev = resolve_device(device)          # no card: raise before any work
    config = Configuration(conf)
    schema = compile_schema(config.features)
    data_dir = data_dir or os.path.join(tempfile.gettempdir(),
                                        "recflow_cascade_torch")
    if not resolve_paths(data_dir):
        generate_records(config, data_dir, num_rows=8000, num_files=2,
                         seed=11)
    files = resolve_paths(data_dir)
    train_ds = Dataset(schema, files, batch_size=256, shuffle=True, seed=0)
    eval_ds = Dataset(schema, files[:1], batch_size=256, shuffle=False,
                      take_batches=8)
    res = run_cascade(config, train_ds, eval_ds, dev)
    k, s1, s2 = res["k"], res["stage1"], res["stage2"]
    print_table(
        [["stage-1 recall", f"{s1[f'hit@{k}']:.4f}", f"{s1['hit@5']:.4f}"],
         ["cascade (reranked)", f"{s2[f'hit@{k}']:.4f}",
          f"{s2['hit@5']:.4f}"]],
        headers=["stage", f"hit@{k}", "hit@5"], title="Cascade demo")
    return res


def cli(argv=None) -> Dict[str, Any]:
    ap = argparse.ArgumentParser(description="matching -> ranking cascade "
                                 "demo on the PyTorch port")
    ap.add_argument("--device", default="cuda",
                    help="cuda (default; raises without a card) or cpu")
    ap.add_argument("--data_dir", default=None)
    args = ap.parse_args(argv)
    return main(device=args.device, data_dir=args.data_dir)


if __name__ == "__main__":
    cli()
