"""`launch_marker`: the train step's phase markers (`csrc/span_marker.cu`),
one empty one-thread kernel per phase, named `rf_span_<phase>`;
`launch_region`: the markers of a stretch inside a phase, named
`rf_region_<region>`, a family apart from the phases'.

`utils/profiling.py:mark_phase` decides when a marker is launched (into a
CUDA graph's capture always, eagerly only while spans are recorded); this
module only launches one on the current stream. The markers do no work,
have no plain version and are not counted in `launches.py`.
"""
from __future__ import annotations

import ctypes

import torch

from recommendflow_tpu_torch.ops.cuda import _build

_NAME = "span_marker"

# the order of csrc/span_marker.cu's switch
PHASES = ("gather", "forward", "backward", "optimizer", "table_update", "end")
# the order of csrc/span_marker.cu's second switch: each region's start,
# then its end
REGIONS = ("cross_forward", "cross_forward_end", "cross_backward",
           "cross_backward_end")


def _lib() -> ctypes.CDLL:
    lib = _build.load(_NAME)
    if not getattr(lib, "_typed", False):
        lib.rf_span_mark.argtypes = [ctypes.c_int, ctypes.c_void_p]
        lib.rf_span_mark.restype = ctypes.c_int
        lib.rf_region_mark.argtypes = [ctypes.c_int, ctypes.c_void_p]
        lib.rf_region_mark.restype = ctypes.c_int
        lib._typed = True
    return lib


def launch_marker(phase: str, device: torch.device) -> None:
    """Launch `rf_span_<phase>` on `device`'s current stream. Raises for a
    phase not in PHASES."""
    lib = _lib()
    rc = lib.rf_span_mark(PHASES.index(phase),
                          torch.cuda.current_stream(device).cuda_stream)
    _build.check(lib, rc, f"span marker {phase}")


def launch_region(region: str, device: torch.device) -> None:
    """Launch `rf_region_<region>` on `device`'s current stream. Raises for
    a region not in REGIONS."""
    lib = _lib()
    rc = lib.rf_region_mark(REGIONS.index(region),
                            torch.cuda.current_stream(device).cuda_stream)
    _build.check(lib, rc, f"region marker {region}")
