"""Hand-written CUDA kernels for Hopper and their PyTorch wrappers.

Each module holds one kernel's wrapper, its plain PyTorch version and a launch
counter; `_build.py` compiles `csrc/*.cu` with nvcc on first use. Nothing is
built or loaded when a module is imported.
"""

# csrc/<name>.cu, one shared library each
KERNELS = ("embedding_bag", "grouped_topk", "table_update", "sparse_apply",
           "flash_attention", "span_marker", "row_grad_combine")
