"""CLI: serve the text encoder and/or an exported model over HTTP (the
counterpart of `recommendflow_tpu/cli/serve.py`, with --device):

    python -m recommendflow_tpu_torch.cli.serve --vocab vocab.txt \\
        --weights /path/encoder_dir --port 8500 [--device cpu]
    python -m recommendflow_tpu_torch.cli.serve --model model.rfx \\
        --port 8500 [--device cpu]

    curl -XPOST :8500/encode -d '{"texts": ["hello"]}'
    curl -XPOST :8500/predict -d '{"batch": {"item_id": [[...]], ...}}'

`--model` is an export of the port (`cli/export.py`); it is loaded on
--device and run once before the server binds.
"""
from __future__ import annotations

import argparse

import numpy as np

from recommendflow_tpu_torch.utils.tables import print_args


def build(argv=None):
    """Parse the flags, load and warm the encoder, and bind the server:
    (EncodeServer, HTTP server), not yet serving."""
    p = argparse.ArgumentParser(description="HTTP serving for encoder/model")
    p.add_argument("--vocab", default=None, help="vocab.txt -> enables /encode")
    p.add_argument("--weights", default=None, help="encoder weights dir")
    p.add_argument("--model", default=None,
                   help=".rfx export -> enables /predict")
    p.add_argument("--host", default="0.0.0.0")
    p.add_argument("--port", type=int, default=8500)
    p.add_argument("--max_len", type=int, default=64)
    p.add_argument("--model_dim", type=int, default=256)
    p.add_argument("--num_layers", type=int, default=4)
    p.add_argument("--pooling", default="cls")
    p.add_argument("--whitening", action="store_true")
    p.add_argument("--max_batch", type=int, default=4096)
    p.add_argument("--batch_window_ms", type=float, default=4.0,
                   help="coalesce concurrent /encode requests into one "
                   "encode call within this window (0 disables)")
    p.add_argument("--device", default="cuda", help="cuda (default) or cpu")
    args = p.parse_args(argv)
    print_args(args)

    if args.weights and not args.vocab:
        p.error("--weights requires --vocab (it loads encoder weights)")
    if not args.vocab and not args.model:
        p.error("--vocab (enables /encode) and/or --model (enables "
                "/predict) is required")
    from recommendflow_tpu_torch.serving import (EncodeServer, ServingModel,
                                                 make_server)
    encoder = None
    if args.vocab:
        from recommendflow_tpu_torch.encoder import (TextEncoderService,
                                                     Tokenizer)
        encoder = TextEncoderService(
            Tokenizer(args.vocab), max_len=args.max_len,
            use_whitening=args.whitening, model_dim=args.model_dim,
            num_layers=args.num_layers, pooling=args.pooling,
            device=args.device)
        if args.weights:
            encoder.load_weights(args.weights)
        # build the kernels and run one batch before accepting traffic;
        # this must NOT auto-fit whitening on the warmup dummy
        encoder.warmup()
    serving_model = None
    if args.model:
        serving_model = ServingModel.load(args.model, device=args.device)
        # build the kernels and run the program once before accepting
        # traffic, on a batch of the exported shapes (ids 0: the pad rows)
        serving_model.predict({
            k: np.zeros(serving_model.meta["shapes"][k],
                        serving_model.meta["dtypes"][k])
            for k in serving_model.batch_keys})
    backend = EncodeServer(encoder, serving_model, max_batch=args.max_batch,
                           batch_window_ms=args.batch_window_ms)
    return backend, make_server(backend, args.host, args.port)


def main(argv=None):
    backend, httpd = build(argv)
    endpoints = backend.handle_health({})["endpoints"]
    print(f"serving {endpoints} on {httpd.server_address[0]}:"
          f"{httpd.server_address[1]}")
    try:
        httpd.serve_forever()
    except KeyboardInterrupt:
        print("shutting down")
    finally:
        httpd.server_close()
        backend.close()  # stop the micro-batcher worker thread


if __name__ == "__main__":
    main()
