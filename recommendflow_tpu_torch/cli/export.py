"""CLI: export a model to a serving artifact (the counterpart of
`recommendflow_tpu/cli/export.py`, with --device):

    python -m recommendflow_tpu_torch.cli.export conf/demo_ranking.yaml \
        --checkpoint /path/ckpt/final.pt --out model.rfx [--batch_size 256] \
        [--device cpu]

The model is built from the config on --device, its weights restored from
one of the port's training checkpoints (a `.pt` file or its directory: the
newest step; `train/checkpoint.py`), and traced at a fixed serving batch of
--batch_size rows. Label columns are baked in as zeroed constants, so that
requests carry no labels. The artifact is reloaded and run once as a check.
`--format savedmodel|both` (the JAX package's jax2tf TensorFlow export)
raises: TensorFlow is not part of the port.
"""
from __future__ import annotations

import argparse

import numpy as np

from recommendflow_tpu_torch.utils.tables import print_args


def main(argv=None):
    p = argparse.ArgumentParser(description="Export a model to .rfx")
    p.add_argument("conf")
    p.add_argument("--checkpoint", default=None,
                   help="a port checkpoint (.pt or its directory)")
    p.add_argument("--out", required=True, help="output .rfx path")
    p.add_argument("--batch_size", type=int, default=256,
                   help="fixed serving batch size")
    p.add_argument("--format", default="rfx",
                   choices=["rfx", "savedmodel", "both"],
                   help="rfx = torch.export program (the port's serving); "
                   "savedmodel / both (TensorFlow) are not ported")
    p.add_argument("--device", default="cuda", help="cuda (default) or cpu")
    args = p.parse_args(argv)
    print_args(args)
    if args.format != "rfx":
        raise NotImplementedError(
            f"--format {args.format}: the TensorFlow SavedModel / frozen "
            f"GraphDef export goes through jax2tf and TensorFlow, which the "
            f"PyTorch port does not use; export with --format rfx")

    from recommendflow_tpu_torch.config import Configuration
    from recommendflow_tpu_torch.data.synthetic import synthetic_batch
    from recommendflow_tpu_torch.device import resolve_device
    from recommendflow_tpu_torch.export import ServingModel, export_model
    from recommendflow_tpu_torch.models.base import build_network
    from recommendflow_tpu_torch.train.checkpoint import restore_checkpoint
    from recommendflow_tpu_torch.train.trainer import Trainer

    dev = resolve_device(args.device)
    conf = Configuration(args.conf)
    model, _ = build_network(conf.networks["class"],
                             {"conf": conf, "device": dev, "seed": 0})
    schema = model.schema
    sample = synthetic_batch(schema, args.batch_size)
    trainer = Trainer(model, device=dev)
    state = trainer.init_state(sample)
    if args.checkpoint:
        restore_checkpoint(args.checkpoint, state)
    else:
        print("WARNING: no --checkpoint given — exporting RANDOMLY "
              "INITIALIZED weights into the serving artifact")
    # serving requests carry no labels: bake label columns in as zeroed
    # constants (their output echoes are dropped) instead of making them
    # part of the serving input signature
    label_keys = [k for k in schema.label_names if k in sample]
    serve_sample = {k: v for k, v in sample.items() if k not in label_keys}
    constants = {k: np.zeros_like(sample[k]) for k in label_keys}
    path = export_model(state.model, serve_sample, args.out,
                        constants=constants)
    print(f"exported to {path}")
    serving = ServingModel.load(path, device=dev)
    out = serving.predict(serve_sample)
    print("reload check:", {k: v.shape for k, v in out.items()})
    return path


if __name__ == "__main__":
    main()
