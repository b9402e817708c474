// Phase markers of the train step: one empty kernel per phase, launched
// with one thread at the phase's start, so that a device trace names where
// each phase of a graphed step begins, replay by replay, on the card's own
// timeline. The symbols are extern "C", so the trace shows them unmangled:
// rf_span_<phase>. The order of the switch is ops/cuda/span_marker.py's
// PHASES.
//
// Region markers mark a stretch inside a phase (the low-rank cross's
// forward and backward): rf_region_<region>, a start and an end each, a
// family apart from rf_span_, so a reader that pairs the six phase
// markers in order never meets one. The order of their switch is
// ops/cuda/span_marker.py's REGIONS.
//
// Cost: a launch of one thread that does nothing, about a microsecond or
// two of the card's time each (PERF.md).

#include <cuda_runtime.h>

extern "C" __global__ void rf_span_gather() {}
extern "C" __global__ void rf_span_forward() {}
extern "C" __global__ void rf_span_backward() {}
extern "C" __global__ void rf_span_optimizer() {}
extern "C" __global__ void rf_span_table_update() {}
extern "C" __global__ void rf_span_end() {}

extern "C" int rf_span_mark(int phase, void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  switch (phase) {
    case 0: rf_span_gather<<<1, 1, 0, s>>>(); break;
    case 1: rf_span_forward<<<1, 1, 0, s>>>(); break;
    case 2: rf_span_backward<<<1, 1, 0, s>>>(); break;
    case 3: rf_span_optimizer<<<1, 1, 0, s>>>(); break;
    case 4: rf_span_table_update<<<1, 1, 0, s>>>(); break;
    case 5: rf_span_end<<<1, 1, 0, s>>>(); break;
    default: return (int)cudaErrorInvalidValue;
  }
  return (int)cudaGetLastError();
}

extern "C" __global__ void rf_region_cross_forward() {}
extern "C" __global__ void rf_region_cross_forward_end() {}
extern "C" __global__ void rf_region_cross_backward() {}
extern "C" __global__ void rf_region_cross_backward_end() {}

extern "C" int rf_region_mark(int region, void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  switch (region) {
    case 0: rf_region_cross_forward<<<1, 1, 0, s>>>(); break;
    case 1: rf_region_cross_forward_end<<<1, 1, 0, s>>>(); break;
    case 2: rf_region_cross_backward<<<1, 1, 0, s>>>(); break;
    case 3: rf_region_cross_backward_end<<<1, 1, 0, s>>>(); break;
    default: return (int)cudaErrorInvalidValue;
  }
  return (int)cudaGetLastError();
}

extern "C" const char* rf_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}
