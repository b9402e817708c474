"""Remote encoder client with local fallback (a copy of
`recommendflow_tpu/serving/client.py`).

Parity surface: the reference's BertEncoder remote path
(backend/encoder/bert_encoder.py:79-117) — try the bert-serving endpoint
with a connect timeout, fall back to the local encoder on any failure or
per-call timeout, and remember a dead server so later calls skip the wait.
"""
from __future__ import annotations

import json
import urllib.error
import urllib.request
from typing import Optional, Sequence

import numpy as np

from recommendflow_tpu_torch.utils.logger import get_logger

log = get_logger("recflow.serve.client")


class RemoteEncoderClient:
    """encode(texts) against a /encode HTTP endpoint, falling back to a
    local TextEncoderService when the server is unreachable or slow.

    connect_timeout guards the first contact (reference: 5 s connect,
    bert_encoder.py:84-90); request_timeout guards each encode call with
    fallback-to-local on expiry (bert_encoder.py:100-113).
    """

    def __init__(self, url: str, local=None,
                 connect_timeout: float = 5.0,
                 request_timeout: float = 10.0,
                 retry_dead_after: int = 64):
        self.url = url.rstrip("/")
        self.local = local
        self.connect_timeout = connect_timeout
        self.request_timeout = request_timeout
        self.retry_dead_after = retry_dead_after
        self._dead_calls = 0          # calls since the server was marked dead
        self._alive: Optional[bool] = None

    # ------------------------------------------------------------ plumbing
    def _post(self, path: str, payload: dict, timeout: float) -> dict:
        req = urllib.request.Request(
            self.url + path, data=json.dumps(payload).encode("utf-8"),
            headers={"Content-Type": "application/json"}, method="POST")
        with urllib.request.urlopen(req, timeout=timeout) as resp:
            return json.loads(resp.read().decode("utf-8"))

    def ping(self) -> bool:
        try:
            req = urllib.request.Request(self.url + "/health")
            with urllib.request.urlopen(req, timeout=self.connect_timeout) as r:
                ok = json.loads(r.read().decode("utf-8")).get("status") == "ok"
            self._alive = ok
            return ok
        except (urllib.error.URLError, OSError, ValueError):
            self._alive = False
            return False

    # -------------------------------------------------------------- encode
    def encode(self, texts: Sequence[str], normalize: bool = True) -> np.ndarray:
        texts = list(texts)
        if self._alive is None:
            self.ping()
        if self._alive is False:
            # dead server: use local, occasionally re-probe
            self._dead_calls += 1
            if self._dead_calls >= self.retry_dead_after:
                self._dead_calls = 0
                self.ping()
            if self._alive is False:
                return self._local_encode(texts, normalize)
        try:
            out = self._post("/encode", {"texts": texts, "normalize": normalize},
                             timeout=self.request_timeout)
            return np.asarray(out["embeddings"], np.float32)
        except (urllib.error.URLError, OSError, TimeoutError, KeyError,
                ValueError) as e:
            log.warning("remote encode failed (%s); falling back to local", e)
            self._alive = False
            self._dead_calls = 0
            return self._local_encode(texts, normalize)

    def _local_encode(self, texts, normalize) -> np.ndarray:
        if self.local is None:
            raise RuntimeError(
                f"remote encoder {self.url} unreachable and no local fallback")
        return self.local.encode(texts, normalize=normalize)
