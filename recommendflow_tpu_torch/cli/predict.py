"""CLI: batch embedding inference (the counterpart of
`recommendflow_tpu/cli/predict.py`, with --device).

Restores weights, runs the model over record files and dumps the outputs
(npz) for downstream indexing:

    python -m recommendflow_tpu_torch.cli.predict conf/demo_recall.yaml \
        --data 'records/*.rfb' --out preds.npz [--checkpoint vars.npz]

--checkpoint is one of the port's training checkpoints (a `.pt` file that
cli/train wrote, or its directory: the newest step; train/checkpoint.py), or
an .npz of a flattened flax variable tree ('/'-joined keys, interop.py) for
weights carried from the JAX package.
"""
from __future__ import annotations

import argparse
import os

import numpy as np

from recommendflow_tpu_torch.utils.tables import print_args


def build_model(conf, args, dev):
    """Model from the config, with --checkpoint weights when given."""
    from recommendflow_tpu_torch.interop import load_jax_variables
    from recommendflow_tpu_torch.models.base import build_network
    from recommendflow_tpu_torch.train.checkpoint import read_checkpoint
    npz = args.checkpoint if args.checkpoint and \
        args.checkpoint.endswith(".npz") else None
    model, restored = build_network(
        conf.networks["class"], {"conf": conf, "device": dev, "seed": args.seed},
        checkpoint_path=npz)
    if restored is not None:
        load_jax_variables(model, restored)
    elif args.checkpoint:
        model.load_state_dict(read_checkpoint(args.checkpoint)["model"])
    return model


def main(argv=None):
    p = argparse.ArgumentParser(description="Batch predict embeddings/scores")
    p.add_argument("conf", help="yaml config path")
    p.add_argument("--data", required=True, help="record pattern")
    p.add_argument("--checkpoint", default=None,
                   help="a port checkpoint (.pt or its directory) or an .npz "
                        "of a flattened flax variable tree")
    p.add_argument("--out", required=True, help="output .npz path")
    p.add_argument("--batch_size", type=int, default=None)
    p.add_argument("--dayno", default=None)
    p.add_argument("--seed", type=int, default=0)
    p.add_argument("--device", default="cuda", help="cuda (default) or cpu")
    args = p.parse_args(argv)
    print_args(args)

    from recommendflow_tpu_torch.config import Configuration
    from recommendflow_tpu_torch.data.pipeline import make_dataset
    from recommendflow_tpu_torch.device import resolve_device
    from recommendflow_tpu_torch.train.trainer import predict

    dev = resolve_device(args.device)
    conf = Configuration(args.conf)
    batch_size = args.batch_size or int(conf.get_conf_value_or("batch_size", 2048))
    # drop_remainder=False: a dropped tail would silently omit up to
    # batch_size-1 embeddings from the npz
    ds, _ = make_dataset(conf, args.data, batch_size, dayno=args.dayno,
                         shuffle=False, valid_ratio=0.0, seed=args.seed,
                         drop_remainder=False)
    model = build_model(conf, args, dev)
    if not args.checkpoint:
        print("WARNING: no --checkpoint given — predicting with RANDOMLY "
              "INITIALIZED weights (the npz will hold garbage embeddings)")
    outputs = predict(model, ds, dev)
    os.makedirs(os.path.dirname(os.path.abspath(args.out)), exist_ok=True)
    out = args.out if args.out.endswith(".npz") else args.out + ".npz"
    np.savez_compressed(out, **outputs)
    print(f"wrote {out}: " + ", ".join(f"{k}{v.shape}" for k, v in outputs.items()))
    return outputs


if __name__ == "__main__":
    main()
