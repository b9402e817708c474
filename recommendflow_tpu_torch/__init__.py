"""RecommendFlow on PyTorch and CUDA (NVIDIA Hopper).

The PyTorch counterpart of `recommendflow_tpu`: the same YAML feature engine,
record format and models, with every device kernel of the JAX package
rewritten by hand for sm_90a (`csrc/`, bound in `ops/cuda/`). The JAX package
stays the reference; this package imports nothing of it.

What is here so far is the serving slice of the flagship recall model:
Dssm inference (`models/matching/dssm.py`) and exact Flat retrieval
(`retrieval/flat.py`), driven by `cli/predict.py` and `cli/evaluate.py`.

Every entry point takes `device` and defaults to "cuda"; with no card it
raises instead of falling back to the CPU (`device.py`).
"""

__version__ = "0.1.0"
