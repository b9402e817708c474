"""CLI: the training pipeline (the counterpart of
`recommendflow_tpu/cli/train.py`, with --device).

Config-driven data and model, Trainer.fit with the epoch-end retrieval
evaluation, early stopping, LR plateau and per-epoch + best checkpoints; the
final state is saved to `<model_save_root>/ckpt/final.pt`, which
cli/predict and cli/evaluate take as --checkpoint:

    python -m recommendflow_tpu_torch.cli.train conf/demo_recall.yaml \
        --data 'records/*.rfb' [--train_mode test] [--device cpu] ...

--lr_schedule (cosine | linear | warmup_constant, peak --lr) with
--warmup_steps and --decay_steps re-derives the dense LR every step, so
ReduceLROnPlateau is left out while it is active.

--preempt_dir (default `<model_save_root>/preempt` when a save root is
known) installs the preemption handler: SIGTERM or SIGINT ends the run
after the step in flight with `<preempt_dir>/<step>.pt`, which
--load_checkpoint resumes mid-epoch.

Several processes, one per card, under torchrun: the CLI joins the process
group and trains on a mesh over every rank (`parallel.make_mesh`), each
rank reading its share of the record files; --shard_tables row-shards the
large tables over it, --no_mesh trains each process on its own share, as
in the JAX CLI:

    torchrun --nproc_per_node 4 -m recommendflow_tpu_torch.cli.train \
        conf/bench_recall.yaml --data 'records/*.rfb' --shard_tables

A plain single process keeps the path without a process group; with
--shard_tables it joins a group of one.
"""
from __future__ import annotations

import argparse
import os

from recommendflow_tpu_torch.utils.str_parser import str2debug, str2list
from recommendflow_tpu_torch.utils.tables import print_args


def build_argparser() -> argparse.ArgumentParser:
    p = argparse.ArgumentParser(description="Train a recommendflow model")
    p.add_argument("conf", help="yaml config path")
    p.add_argument("--data", default=None, help="override Train.data pattern")
    p.add_argument("--dayno", default=None, help="dayno DSL for YYYYMMDD substitution")
    p.add_argument("--epochs", type=int, default=None)
    p.add_argument("--batch_size", type=int, default=None)
    p.add_argument("--lr", type=float, default=1e-3)
    p.add_argument("--lr_schedule", default=None,
                   choices=["cosine", "linear", "warmup_constant"],
                   help="per-step LR schedule (peak = --lr)")
    p.add_argument("--warmup_steps", type=int, default=0)
    p.add_argument("--decay_steps", type=int, default=100_000)
    p.add_argument("--valid_ratio", type=float, default=0.1)
    p.add_argument("--topk", default="5,10,50,100", help="eval K list")
    p.add_argument("--train_mode", default="normal", help="'test' = 10-batch debug run")
    p.add_argument("--exp_id", type=int, default=None, help="activate experiment row")
    p.add_argument("--model_save_root", default=None)
    p.add_argument("--load_checkpoint", default=None,
                   help="a port checkpoint file or directory to resume from")
    p.add_argument("--warm_start", action="store_true",
                   help="with --load_checkpoint: restore weights but train "
                        "fresh epochs (no data fast-forward)")
    p.add_argument("--patience", type=int, default=3)
    p.add_argument("--monitor", default="val_auc")
    p.add_argument("--seed", type=int, default=0)
    p.add_argument("--no_mesh", action="store_true",
                   help="under torchrun, train each process on its own "
                        "(no mesh)")
    p.add_argument("--preempt_dir", default=None,
                   help="checkpoint dir for graceful SIGTERM/SIGINT "
                        "preemption (default: <model_save_root>/preempt)")
    p.add_argument("--shard_tables", action="store_true",
                   help="row-shard the large embedding tables over the mesh")
    p.add_argument("--device", default="cuda", help="cuda (default) or cpu")
    return p


def main(argv=None):
    args = build_argparser().parse_args(argv)
    print_args(args)

    from recommendflow_tpu_torch.config import Configuration
    from recommendflow_tpu_torch.data.pipeline import make_dataset
    from recommendflow_tpu_torch.models.base import build_network
    from recommendflow_tpu_torch.parallel import host_id, num_hosts
    from recommendflow_tpu_torch.parallel.mesh import launch_mesh
    from recommendflow_tpu_torch.retrieval.eval import make_recall_evaluator
    from recommendflow_tpu_torch.train.callbacks import (EarlyStopping,
                                                         EvalCallback,
                                                         ModelCheckpoint,
                                                         ReduceLROnPlateau)
    from recommendflow_tpu_torch.train.checkpoint import (restore_checkpoint,
                                                          save_checkpoint)
    from recommendflow_tpu_torch.train.trainer import (
        Trainer, install_preemption_handler)

    mesh, dev = launch_mesh(args.device, args.no_mesh, args.shard_tables)
    conf = Configuration(args.conf)
    loss_name = None
    data_pattern = args.data
    if args.exp_id is not None:
        row = conf.active_experiment(args.exp_id)
        loss_name = row.get("loss")
        data_pattern = data_pattern or row.get("train_data")
    conf.print_features()

    data_pattern = data_pattern or conf.get_conf_value("data")
    batch_size = args.batch_size or int(conf.get_conf_value_or("batch_size", 1024))
    epochs = args.epochs or int(conf.get_conf_value_or("epoch", 1))
    debug = str2debug(args.train_mode)
    train_ds, valid_ds = make_dataset(
        conf, data_pattern, batch_size, dayno=args.dayno,
        valid_ratio=args.valid_ratio, seed=args.seed, debug=debug,
        host_id=host_id(), num_hosts=num_hosts())

    model, _ = build_network(conf.networks["class"],
                             {"conf": conf, "loss": loss_name, "device": dev,
                              "seed": args.seed})
    schedule = ({"type": args.lr_schedule, "warmup_steps": args.warmup_steps,
                 "decay_steps": args.decay_steps}
                if args.lr_schedule else None)
    trainer = Trainer(model, learning_rate=args.lr, lr_schedule=schedule,
                      device=dev, seed=args.seed, mesh=mesh,
                      shard_tables=args.shard_tables)

    topk = str2list(args.topk, trans_type=int)
    monitor = args.monitor
    if valid_ds is None and monitor == "val_auc":
        # val_auc only comes from evaluate(valid_ds); the recall evaluator's
        # hit@K exists either way, and clamp_topk always keeps min(topk)
        monitor = f"val_hit@{min(topk)}"
        print(f"WARNING: no validation split — '{args.monitor}' is never "
              f"produced; monitoring '{monitor}' (train-set retrieval eval) "
              f"instead. Pass >= 2 files + --valid_ratio for a true "
              f"validation monitor.")
    callbacks = [
        EvalCallback(make_recall_evaluator(valid_ds or train_ds, topk_list=topk)),
        EarlyStopping(monitor=monitor, patience=args.patience),
    ]
    if args.lr_schedule:
        # the schedule re-derives the LR every step: the plateau callback's
        # set_learning_rate would have no effect
        print("note: --lr_schedule active; ReduceLROnPlateau disabled")
    else:
        callbacks.append(ReduceLROnPlateau(monitor=monitor,
                                           patience=max(args.patience - 1, 1)))
    save_root = args.model_save_root or conf.get_conf_value_or("model_save_root")
    if save_root and not debug:
        callbacks.append(ModelCheckpoint(os.path.join(save_root, "ckpt"),
                                         monitor=monitor))

    state = None
    if args.load_checkpoint:
        state = trainer.init_state(next(iter(train_ds)))
        restore_checkpoint(args.load_checkpoint, state)

    preempt_dir = args.preempt_dir or (
        os.path.join(save_root, "preempt") if save_root else None)
    if preempt_dir:
        install_preemption_handler(trainer)

    result = trainer.fit(train_ds, epochs=epochs, valid_ds=valid_ds,
                         callbacks=callbacks, state=state,
                         log_every=5 if debug else 100,
                         preempt_dir=preempt_dir,
                         resume_data=not args.warm_start)
    if result["preempted"]:
        print(f"preempted at step {result['state'].step}: resume with "
              f"--load_checkpoint {preempt_dir}")
    elif save_root:
        path = save_checkpoint(os.path.join(save_root, "ckpt", "final.pt"),
                               result["state"])
        print(f"saved {path}")
    final = result["history"][-1] if result["history"] else {}
    print("final:", {k: round(v, 5) for k, v in final.items()})
    return result


if __name__ == "__main__":
    main()
