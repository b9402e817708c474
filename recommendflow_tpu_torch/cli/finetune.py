"""CLI: the daily fine-tune from an existing checkpoint (the counterpart of
`recommendflow_tpu/cli/finetune.py`, flag for flag, with --device).

Parity surface: example/recall_search/finetune.py:42-85 of the reference
system: restore a prior model, train a few epochs on fresh daily data with
per-epoch checkpoints, then promote the result only if the promotion gate
(train/monitor.py) passes:

    python -m recommendflow_tpu_torch.cli.finetune conf/demo_recall.yaml \
        --data 'day/*.rfb' --load_checkpoint run/ckpt \
        --model_save_root ft --lr 3e-4 \
        --promotion_constraints 'val_auc=[-0.05, inf); val_hit@10=[-0.1, inf)'

--load_checkpoint is a port checkpoint (a `.pt` file or a directory: its
newest step). --lr replaces the checkpoint's learning rate. The metrics
before and after (the recall evaluation, then `Trainer.evaluate`, on the
validation split or else the training data) are measured the same way, and
the promoted state is written as `<model_save_root>/online/<step>.pt`, the
only checkpoint there, which cli/predict and cli/evaluate take as
--checkpoint `<model_save_root>/online`. --train_mode test never promotes.

Under torchrun (one process per card) the CLI joins the process group and
fine-tunes on a mesh over every rank, as the JAX CLI does with its
make_mesh; a plain single process keeps the path without a group. The
JAX CLI's enable_compilation_cache has no counterpart: the port compiles
no XLA.
"""
from __future__ import annotations

import argparse
import os

from recommendflow_tpu_torch.utils.str_parser import str2debug, str2dict
from recommendflow_tpu_torch.utils.tables import print_args


def build_argparser() -> argparse.ArgumentParser:
    p = argparse.ArgumentParser(description="Finetune from a checkpoint")
    p.add_argument("conf")
    p.add_argument("--data", required=True)
    p.add_argument("--dayno", default=None)
    p.add_argument("--load_checkpoint", required=True,
                   help="port checkpoint (.pt or its directory) to resume from")
    p.add_argument("--model_save_root", required=True)
    p.add_argument("--epochs", type=int, default=1)
    p.add_argument("--batch_size", type=int, default=None)
    p.add_argument("--lr", type=float, default=3e-4)
    p.add_argument("--train_mode", default="normal")
    p.add_argument("--monitor", default="val_auc")
    p.add_argument("--promotion_constraints", default="",
                   help="e.g. 'val_auc=[-0.05, inf); val_hit@50=[-0.1, inf)'")
    p.add_argument("--exp_id", type=int, default=None,
                   help="activate experiment row (must match the "
                        "checkpoint's training run: feature toggles change "
                        "the weights)")
    p.add_argument("--seed", type=int, default=0)
    p.add_argument("--device", default="cuda", help="cuda (default) or cpu")
    return p


def promote(root: str, state) -> str:
    """Write `state` as `<root>/online/<step>.pt` and remove any other
    checkpoint there, so the directory names this one (rank 0 writes under
    a mesh). Returns its path."""
    from recommendflow_tpu_torch.parallel import host_id
    from recommendflow_tpu_torch.train.checkpoint import save_step
    online = os.path.join(root, "online")
    path = save_step(online, state, state.step)
    if host_id() == 0:
        for name in os.listdir(online):
            if name.endswith(".pt") and name != os.path.basename(path):
                os.remove(os.path.join(online, name))
    return path


def main(argv=None):
    args = build_argparser().parse_args(argv)
    print_args(args)

    from recommendflow_tpu_torch.config import Configuration
    from recommendflow_tpu_torch.data.pipeline import make_dataset
    from recommendflow_tpu_torch.models.base import build_network
    from recommendflow_tpu_torch.parallel import host_id, num_hosts
    from recommendflow_tpu_torch.parallel.mesh import launch_mesh
    from recommendflow_tpu_torch.retrieval.eval import make_recall_evaluator
    from recommendflow_tpu_torch.train.callbacks import (EvalCallback,
                                                         ModelCheckpoint)
    from recommendflow_tpu_torch.train.checkpoint import restore_checkpoint
    from recommendflow_tpu_torch.train.monitor import model_online_monitor
    from recommendflow_tpu_torch.train.trainer import (Trainer,
                                                       set_learning_rate)

    mesh, dev = launch_mesh(args.device)
    conf = Configuration(args.conf)
    loss_name = None
    if args.exp_id is not None:
        row = conf.active_experiment(args.exp_id)
        loss_name = row.get("loss")
    batch_size = args.batch_size or int(conf.get_conf_value_or("batch_size", 1024))
    debug = str2debug(args.train_mode)
    train_ds, valid_ds = make_dataset(conf, args.data, batch_size,
                                      dayno=args.dayno, valid_ratio=0.1,
                                      seed=args.seed, debug=debug,
                                      host_id=host_id(),
                                      num_hosts=num_hosts())
    model, _ = build_network(conf.networks["class"],
                             {"conf": conf, "loss": loss_name, "device": dev,
                              "seed": args.seed})
    trainer = Trainer(model, learning_rate=args.lr, device=dev, seed=args.seed,
                      mesh=mesh)

    state = trainer.init_state(next(iter(train_ds)))
    restore_checkpoint(args.load_checkpoint, state)
    # the checkpoint restores the optimizer's state, the previous run's
    # (possibly plateau-reduced) LR included: --lr must win
    set_learning_rate(state, args.lr)

    eval_ds = valid_ds or train_ds
    eval_cb = EvalCallback(make_recall_evaluator(eval_ds))
    base_logs: dict = {}
    base_logs.update(eval_cb.eval_fn(trainer, state))
    base_logs.update(trainer.evaluate(state, eval_ds))
    print("pre-finetune metrics:", {k: round(v, 5) for k, v in base_logs.items()})

    callbacks = [eval_cb]
    if not debug:  # a 10-batch smoke run must not write real checkpoints
        callbacks.append(
            ModelCheckpoint(os.path.join(args.model_save_root, "ckpt"),
                            monitor=args.monitor))
    # resume_data=False: fresh epochs from the restored weights (the restored
    # step is another run's position, not a mid-run resume point)
    result = trainer.fit(train_ds, epochs=args.epochs, valid_ds=valid_ds,
                         callbacks=callbacks, state=state,
                         log_every=5 if debug else 100, resume_data=False)
    # measured exactly like base_logs (fit's history lacks val_auc when
    # there is no validation split)
    final_logs = dict(result["history"][-1]) if result["history"] else {}
    final_logs.update(eval_cb.eval_fn(trainer, result["state"]))
    final_logs.update(trainer.evaluate(result["state"], eval_ds))

    if args.promotion_constraints:
        constraints = str2dict(args.promotion_constraints)
        model_online_monitor(base_logs, final_logs, constraints)
    online = None
    if debug:
        print("debug mode: NOT promoting to online (10-batch smoke run)")
    else:
        online = promote(args.model_save_root, result["state"])
        print("promoted to", online)
    print("final:", {k: round(v, 5) for k, v in final_logs.items()})
    return {"state": result["state"], "base_logs": base_logs,
            "final_logs": final_logs, "online": online}


if __name__ == "__main__":
    main()
