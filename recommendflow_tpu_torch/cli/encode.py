"""CLI: batch text encoding (the counterpart of
`recommendflow_tpu/cli/encode.py`, with --device).

Reads one text per line, writes an .npz of the texts and their embeddings;
supports whitening and the LRU-cached encode path. `--weights` is the port's
weights directory (`TextEncoderService.save`: `variables.npz`, and
`whitening.npz` once whitening is fit).

    python -m recommendflow_tpu_torch.cli.encode --vocab vocab.txt \\
        --input texts.txt --out emb.npz [--weights dir] [--device cpu]
"""
from __future__ import annotations

import argparse
import os
import sys

import numpy as np

from recommendflow_tpu_torch.utils.tables import print_args


def main(argv=None):
    p = argparse.ArgumentParser(description="Encode texts to embeddings")
    p.add_argument("--vocab", required=True, help="vocab.txt path")
    p.add_argument("--input", default="-", help="text file (one per line) or -")
    p.add_argument("--out", required=True, help="output .npz")
    p.add_argument("--weights", default=None, help="encoder weights dir")
    p.add_argument("--max_len", type=int, default=64)
    p.add_argument("--model_dim", type=int, default=256)
    p.add_argument("--num_layers", type=int, default=4)
    p.add_argument("--pooling", default="cls")
    p.add_argument("--whitening", action="store_true")
    p.add_argument("--device", default="cuda", help="cuda (default) or cpu")
    args = p.parse_args(argv)
    print_args(args)

    from recommendflow_tpu_torch.encoder import TextEncoderService, Tokenizer

    tokenizer = Tokenizer(args.vocab)
    service = TextEncoderService(
        tokenizer, max_len=args.max_len, use_whitening=args.whitening,
        model_dim=args.model_dim, num_layers=args.num_layers,
        pooling=args.pooling, device=args.device)
    if args.weights:
        service.load_weights(args.weights)

    if args.input == "-":
        lines = sys.stdin.read().splitlines()
    else:
        with open(args.input) as f:
            lines = f.read().splitlines()
    texts = [l for l in lines if l.strip()]
    emb = service.encode(texts)
    # np.savez appends .npz when absent — report the REAL path written
    out = args.out if args.out.endswith(".npz") else args.out + ".npz"
    os.makedirs(os.path.dirname(os.path.abspath(out)), exist_ok=True)
    # unicode '<U' dtype (NOT object): loads without allow_pickle
    np.savez_compressed(out, texts=np.asarray(texts), embeddings=emb)
    print(f"encoded {len(texts)} texts -> {out} {emb.shape}")
    return emb


if __name__ == "__main__":
    main()
