"""RecommendFlow on PyTorch and CUDA (NVIDIA Hopper).

The PyTorch counterpart of `recommendflow_tpu`: the same YAML feature engine,
record format and models, with every device kernel of the JAX package
rewritten by hand for sm_90a (`csrc/`, bound in `ops/cuda/`). The JAX package
stays the reference; this package imports nothing of it.

Every module of the JAX package has its counterpart here (a Chrome-trace
reader, `utils/trace.py`, in place of the xplane one), and
`examples/cascade_demo_torch.py` runs the whole recall -> rank cascade.

Every entry point takes `device` and defaults to "cuda"; with no card it
raises instead of falling back to the CPU (`device.py`).
"""

from recommendflow_tpu_torch.version import __version__

__all__ = ["__version__"]
