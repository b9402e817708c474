"""BERT-whitening for embedding post-processing (a numpy copy of
`recommendflow_tpu/retrieval/whitening.py`; the two give bitwise equal
results on equal inputs).

Parity with VecsWhitening (backend/third_party_components/vecs_whitening.py:
11-73): fit computes the whitening kernel from the covariance SVD (optionally
reducing dimension), transform applies (x - mu) @ W; persistence via npz.
"""
from __future__ import annotations

from typing import Optional

import numpy as np


class VecsWhitening:
    def __init__(self, n_components: Optional[int] = None):
        self.n_components = n_components
        self.kernel: Optional[np.ndarray] = None
        self.bias: Optional[np.ndarray] = None

    def fit(self, vecs: np.ndarray) -> "VecsWhitening":
        vecs = np.asarray(vecs, np.float64)
        mu = vecs.mean(axis=0, keepdims=True)
        cov = np.cov((vecs - mu).T)
        u, s, _ = np.linalg.svd(cov)
        w = u @ np.diag(1.0 / np.sqrt(np.maximum(s, 1e-12)))
        if self.n_components:
            w = w[:, :self.n_components]
        self.kernel = w.astype(np.float32)
        self.bias = (-mu).astype(np.float32)
        return self

    def transform(self, vecs: np.ndarray, normalize: bool = True) -> np.ndarray:
        if self.kernel is None:
            raise RuntimeError("fit() before transform()")
        out = (np.asarray(vecs, np.float32) + self.bias) @ self.kernel
        if normalize:
            out = out / np.maximum(np.linalg.norm(out, axis=1, keepdims=True), 1e-12)
        return out

    def fit_transform(self, vecs: np.ndarray, normalize: bool = True) -> np.ndarray:
        return self.fit(vecs).transform(vecs, normalize)

    def save(self, path: str):
        np.savez(path, kernel=self.kernel, bias=self.bias)

    @classmethod
    def load(cls, path: str) -> "VecsWhitening":
        data = np.load(path if path.endswith(".npz") else path + ".npz")
        w = cls()
        w.kernel, w.bias = data["kernel"], data["bias"]
        return w
