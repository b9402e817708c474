"""Online serving: a stdlib HTTP server over the text encoder and an
exported model (the counterpart of `recommendflow_tpu/serving/server.py`).

  * POST /encode  {"texts": [...], "normalize": true}
        -> {"embeddings": [[...], ...], "dim": D}
    backed by a TextEncoderService (tokenize + encode on the card +
    whitening + LRU cache);
  * POST /predict {"batch": {feature: nested lists}}
        -> {output name: nested lists}
    backed by a ServingModel (`export/exporter.py`: a `torch.export` program
    whose embedding ids are checked on the host, so an id outside its table
    is a 400);
  * GET  /health  -> {"status": "ok", "device": ..., "card": ...,
                      "endpoints": [...]}.

Threading model: ThreadingHTTPServer accepts concurrently; encode and
predict calls funnel through one lock (one batch on the card at a time, and
the encoder's LRU cache is not thread-safe under concurrent mutation), and
concurrent /encode requests are coalesced into one encode call by
`_MicroBatcher`.
"""
from __future__ import annotations

import json
import queue
import threading
import time
from http.server import BaseHTTPRequestHandler, ThreadingHTTPServer
from typing import Any, Dict

import numpy as np

from recommendflow_tpu_torch.utils.logger import get_logger


class _MicroBatcher:
    """Coalesce concurrent encode requests into one encode call.

    A worker thread takes the first queued request, then drains more until
    `window_ms` passes or `max_batch` texts are gathered; per-request slices
    come back through per-request events. A lone request pays at most the
    window.
    """

    def __init__(self, encode_fn, window_ms: float = 4.0,
                 max_batch: int = 4096):
        self.encode_fn = encode_fn
        self.window = window_ms / 1e3
        self.max_batch = max_batch
        self.q: "queue.Queue" = queue.Queue()
        self.batches_run = 0
        self.requests_batched = 0
        self._closed = False
        self._thread = threading.Thread(target=self._loop, daemon=True)
        self._thread.start()

    class _Req:
        __slots__ = ("texts", "normalize", "event", "result", "error")

        def __init__(self, texts, normalize):
            self.texts, self.normalize = texts, normalize
            self.event = threading.Event()
            self.result, self.error = None, None

    def encode(self, texts, normalize: bool = True):
        if self._closed:
            raise RuntimeError("micro-batcher is closed")
        req = self._Req(list(texts), bool(normalize))
        self.q.put(req)
        # bounded waits so a dead worker cannot hang this handler thread
        while not req.event.wait(timeout=1.0):
            if self._closed:
                raise RuntimeError("micro-batcher worker exited")
        if req.error is not None:
            raise req.error
        return req.result

    def close(self):
        self.q.put(None)
        self._thread.join(timeout=5)

    def _loop(self):
        try:
            self._loop_inner()
        finally:
            # fail everything still queued rather than leaving handler
            # threads blocked on events no one will set
            self._closed = True
            while True:
                try:
                    req = self.q.get_nowait()
                except queue.Empty:
                    break
                if req is not None:
                    req.error = RuntimeError("micro-batcher worker exited")
                    req.event.set()

    def _loop_inner(self):
        carry = None   # a dequeued request that would overflow this batch
        while True:
            head = carry if carry is not None else self.q.get()
            carry = None
            if head is None:
                return
            batch = [head]
            total = len(head.texts)
            # monotonic: a wall-clock step would stretch or collapse the
            # coalescing window
            deadline = time.monotonic() + self.window
            while total < self.max_batch:
                left = deadline - time.monotonic()
                if left <= 0:
                    break
                try:
                    req = self.q.get(timeout=left)
                except queue.Empty:
                    break
                if req is None:
                    self.q.put(None)  # re-queue shutdown for after this batch
                    break
                if total + len(req.texts) > self.max_batch:
                    carry = req       # honor max_batch: open the NEXT batch
                    break
                batch.append(req)
                total += len(req.texts)
            self.batches_run += 1
            self.requests_batched += len(batch)
            for norm in (True, False):
                group = [r for r in batch if r.normalize == norm]
                if not group:
                    continue
                texts = [t for r in group for t in r.texts]
                try:
                    embs = self.encode_fn(texts, normalize=norm)
                    off = 0
                    for r in group:
                        r.result = embs[off:off + len(r.texts)]
                        off += len(r.texts)
                except Exception as e:  # noqa: BLE001 — deliver, don't die
                    for r in group:
                        r.error = e
            for r in batch:
                r.event.set()


class EncodeServer:
    """The encoder and/or the serving model behind the HTTP endpoints, with
    the dispatch table."""

    def __init__(self, encoder=None, serving_model=None, max_batch: int = 4096,
                 batch_window_ms: float = 4.0):
        if encoder is None and serving_model is None:
            raise ValueError("need an encoder and/or a serving model to serve")
        self.encoder = encoder
        self.serving_model = serving_model
        self.max_batch = max_batch
        self._lock = threading.Lock()        # the card: one encode at a time
        self._count_lock = threading.Lock()  # counters only
        self.requests_served = 0

        # cross-request micro-batching for /encode (batch_window_ms <= 0
        # disables it and leaves the plain lock path)
        def _locked_encode(texts, normalize=True):
            with self._lock:
                return encoder.encode(texts, normalize=normalize)

        self._batcher = (_MicroBatcher(_locked_encode, batch_window_ms,
                                       max_batch)
                         if encoder is not None and batch_window_ms > 0
                         else None)

    # ----------------------------------------------------------- handlers
    def handle_health(self, _payload) -> Dict[str, Any]:
        import torch
        backend = self.encoder if self.encoder is not None \
            else self.serving_model
        dev = getattr(backend, "device", None)
        dev = torch.device(dev) if dev is not None else torch.device("cpu")
        endpoints = ["/health"]
        if self.encoder is not None:
            endpoints.append("/encode")
        if self.serving_model is not None:
            endpoints.append("/predict")
        info = {"status": "ok",
                "device": str(dev),
                "card": (torch.cuda.get_device_name(dev)
                         if dev.type == "cuda" else None),
                "requests_served": self.requests_served,
                "endpoints": endpoints}
        if self._batcher is not None:
            info["batches_run"] = self._batcher.batches_run
            info["requests_batched"] = self._batcher.requests_batched
        return info

    def handle_encode(self, payload) -> Dict[str, Any]:
        if self.encoder is None:
            raise LookupError("no encoder loaded on this server")
        texts = payload.get("texts")
        if not isinstance(texts, list) or not all(isinstance(t, str) for t in texts):
            raise ValueError("'texts' must be a list of strings")
        if len(texts) > self.max_batch:
            raise ValueError(f"batch too large ({len(texts)} > {self.max_batch})")
        normalize = bool(payload.get("normalize", True))
        if self._batcher is not None:
            emb = self._batcher.encode(texts, normalize=normalize)
            with self._count_lock:
                self.requests_served += 1
        else:
            with self._lock:
                emb = self.encoder.encode(texts, normalize=normalize)
                self.requests_served += 1
        emb = np.asarray(emb)
        return {"embeddings": emb.tolist(),
                "dim": int(emb.shape[1]) if emb.ndim == 2 else 0}

    def handle_predict(self, payload) -> Dict[str, Any]:
        if self.serving_model is None:
            raise LookupError("no serving model loaded on this server")
        batch_in = payload.get("batch")
        if not isinstance(batch_in, dict):
            raise ValueError("'batch' must be a dict of feature arrays")
        batch = {k: np.asarray(v) for k, v in batch_in.items()}
        sizes = {len(v) for v in batch.values() if v.ndim}
        if sizes and max(sizes) > self.max_batch:
            raise ValueError(f"batch too large ({max(sizes)} > {self.max_batch})")
        with self._lock:
            out = self.serving_model.predict(batch)
            self.requests_served += 1
        return {k: np.asarray(v).tolist() for k, v in out.items()}

    def dispatch(self, path: str, payload) -> Dict[str, Any]:
        table = {"/health": self.handle_health,
                 "/encode": self.handle_encode,
                 "/predict": self.handle_predict}
        if path not in table:
            raise LookupError(f"unknown endpoint {path}")
        if not isinstance(payload, dict):
            # a top-level JSON list/string/number is the client's mistake
            raise ValueError("request body must be a JSON object")
        return table[path](payload)

    def close(self):
        """Stop the micro-batcher worker thread (idempotent)."""
        if self._batcher is not None:
            self._batcher.close()


class _Handler(BaseHTTPRequestHandler):
    server_version = "recflow-serve/1"
    backend: EncodeServer  # set by make_server

    def log_message(self, fmt, *args):  # quiet by default; logger has it
        get_logger("recflow.serve").debug(fmt % args)

    # one request may not buffer more than this before validation runs
    # (an uncapped read lets a single Content-Length: 8G request OOM the
    # serving host)
    MAX_BODY_BYTES = 64 * 1024 * 1024

    def _reply(self, code: int, obj: Dict[str, Any]):
        try:
            # non-finite floats would serialize as bare NaN/Infinity tokens,
            # which are not JSON: a server error
            body = json.dumps(obj, allow_nan=False).encode("utf-8")
        except ValueError:
            code = 500
            body = json.dumps(
                {"error": "non-finite value in response"}).encode("utf-8")
        self.send_response(code)
        self.send_header("Content-Type", "application/json")
        self.send_header("Content-Length", str(len(body)))
        self.end_headers()
        self.wfile.write(body)

    def _dispatch_and_reply(self, path: str, payload):
        # bad requests are the client's fault, not a 500
        try:
            self._reply(200, self.backend.dispatch(path, payload))
        except KeyError as e:
            # a missing input of /predict (ServingModel.predict): the
            # client's body, not the path. KeyError is a LookupError, so it
            # must be answered before the 404 clause (the JAX server answers
            # it 404)
            self._reply(400, {"error": str(e)})
        except LookupError as e:
            self._reply(404, {"error": str(e)})
        except (ValueError, TypeError) as e:
            self._reply(400, {"error": str(e)})
        except Exception as e:  # noqa: BLE001 — serving must not die
            self._reply(500, {"error": str(e)})

    def do_GET(self):
        # query strings are allowed (health probes append cache-busters)
        self._dispatch_and_reply(self.path.split("?", 1)[0], {})

    def do_POST(self):
        path = self.path.split("?", 1)[0]
        try:
            n = int(self.headers.get("Content-Length", 0))
            if n > self.MAX_BODY_BYTES:
                self._reply(413, {"error": f"body {n} bytes exceeds "
                                           f"{self.MAX_BODY_BYTES}"})
                return
            payload = json.loads(self.rfile.read(n) or b"{}")
        except ValueError as e:
            self._reply(400, {"error": str(e)})
            return
        self._dispatch_and_reply(path, payload)


def make_server(backend: EncodeServer, host: str = "0.0.0.0",
                port: int = 8500) -> ThreadingHTTPServer:
    """Build the HTTP server (call .serve_forever(), or run it in a thread;
    .server_address[1] gives the bound port when port=0)."""
    handler = type("BoundHandler", (_Handler,), {"backend": backend})
    return ThreadingHTTPServer((host, port), handler)
