"""CLI: offline retrieval/ranking evaluation of a checkpoint (the counterpart
of `recommendflow_tpu/cli/evaluate.py`, with --device).

Predicts embeddings over an eval set, indexes the deduplicated positive items
in a FlatSearcher and prints hit / mrr / ndcg @ K (AUC/AUPR for a scoring
model):

    python -m recommendflow_tpu_torch.cli.evaluate conf/demo_recall.yaml \
        --data 'records/*.rfb' [--checkpoint ckpt/final.pt] [--topk 5,10,50]
"""
from __future__ import annotations

import argparse

import numpy as np

from recommendflow_tpu_torch.utils.str_parser import str2list
from recommendflow_tpu_torch.utils.tables import print_args, print_table


def main(argv=None):
    p = argparse.ArgumentParser(description="Evaluate a checkpoint")
    p.add_argument("conf")
    p.add_argument("--data", required=True)
    p.add_argument("--checkpoint", default=None,
                   help="a port checkpoint (.pt or its directory) or an .npz "
                        "of a flattened flax variable tree")
    p.add_argument("--exp_id", type=int, default=None,
                   help="activate experiment row (must match the "
                        "checkpoint's training run)")
    p.add_argument("--batch_size", type=int, default=None)
    p.add_argument("--topk", default="5,10,50,100,200,300")
    p.add_argument("--dayno", default=None)
    p.add_argument("--seed", type=int, default=0)
    p.add_argument("--device", default="cuda", help="cuda (default) or cpu")
    args = p.parse_args(argv)
    print_args(args)

    from recommendflow_tpu_torch.cli.predict import build_model
    from recommendflow_tpu_torch.config import Configuration
    from recommendflow_tpu_torch.data.pipeline import make_dataset
    from recommendflow_tpu_torch.device import resolve_device
    from recommendflow_tpu_torch.retrieval.eval import (
        batch_compute_recall_score, build_eval_corpus, clamp_topk,
        recall_report)
    from recommendflow_tpu_torch.retrieval.flat import FlatSearcher
    from recommendflow_tpu_torch.train.metrics import (average_precision,
                                                       recall_at_precision,
                                                       roc_auc)
    from recommendflow_tpu_torch.train.trainer import predict

    dev = resolve_device(args.device)
    conf = Configuration(args.conf)
    if args.exp_id is not None:
        conf.active_experiment(args.exp_id)
    batch_size = args.batch_size or int(conf.get_conf_value_or("batch_size", 1024))
    # offline eval must see every example: no dropped tail
    ds, _ = make_dataset(conf, args.data, batch_size, dayno=args.dayno,
                         shuffle=False, valid_ratio=0.0, seed=args.seed,
                         drop_remainder=False)
    model = build_model(conf, args, dev)
    if not args.checkpoint:
        print("WARNING: no --checkpoint given — evaluating RANDOMLY "
              "INITIALIZED weights (baseline numbers, not a trained model)")
    out = predict(model, ds, dev)

    if "user" in out and "ad" in out:
        q, d, y = out["user"], out["ad"], out.get("label")
        corpus, inverse, pos = build_eval_corpus(q, d, y)
        if corpus is None:
            print("no positive rows in the eval set — recall metrics skipped")
            return {}
        searcher = FlatSearcher(dim=q.shape[1], metric="cos",
                                device=dev).train(corpus)
        topk = clamp_topk(str2list(args.topk, trans_type=int), len(corpus))
        metrics = batch_compute_recall_score(searcher, q[pos], inverse, topk)
        print(f"corpus items: {len(corpus)}, queries: {int(pos.sum())}")
        print(recall_report(metrics, topk))
        if y is not None:
            metrics["auc"] = roc_auc(y, np.sum(q * d, axis=1))
            print(f"auc={metrics['auc']:.5f}")
        return metrics
    if "score" in out:
        y, s = np.asarray(out["label"]), np.asarray(out["score"])
        rec, thr = recall_at_precision(y, s, 0.6)
        metrics = {"auc": roc_auc(y, s), "aupr": average_precision(y, s),
                   "recall@precision>=0.6": rec}
        print_table([["auc", f"{metrics['auc']:.5f}"],
                     ["aupr", f"{metrics['aupr']:.5f}"],
                     ["recall@precision>=0.6", f"{rec:.5f} (thr={thr:.4f})"]],
                    headers=["metric", "value"], title="Ranking evaluation")
        print(f"auc={metrics['auc']:.5f}")
        return metrics
    raise SystemExit(f"model outputs {list(out)} — nothing evaluable")


if __name__ == "__main__":
    main()
