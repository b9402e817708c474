// Row-wise Adagrad over a whole table, in place, one pass:
//
//   acc[r] += mean(g[r, :]^2)
//   p[r, :] -= lr * g[r, :] * rsqrt(acc[r] + eps)
//
// in float32 whatever the table's type, with one rounding back to it.
//
// Replaces: recommendflow_tpu/ops/pallas/table_update.py,
// rowwise_adagrad_update (the Pallas streaming update), and the fused XLA
// apply of train/optimizers.py:split_table_update's "dense" strategy
// (:266-270) that the JAX trainer runs in its place.
//
// Bound: bytes. The update reads g and acc whole; a row whose gradient is
// all +0.0 keeps p and acc exactly as they are (mean 0, p - (+0) = p for
// every p), so only the rows with another bit pattern somewhere in their
// gradient read and write p and write acc. For the bench_recall dim-64
// bf16 table (1,505,024 stored rows of 512 bytes) that is 770 MB of g and
// 6 MB of acc, plus 1 KB a touched row: ~0.26 ms at 3.35 TB/s for one
// batch's ~77k touched rows. (Reading and writing every row, as the TPU
// kernel does, is 2.3 GB, ~0.69 ms.)
//
// Design: the TPU kernel streams [1024, W] blocks through VMEM in grid
// order; here one warp owns one stored row (512 bytes: a 16-byte word a
// lane), sums its squares in registers and ORs the bit patterns of its
// gradient; a row whose gradient is all +0.0 leaves after one warp vote,
// before the reduction. The test is on the bits, not on the sum of squares,
// which also underflows to 0 for nonzero gradients below ~4e-23, and -0.0
// counts as touched, since p - (-0) turns a -0.0 of p into +0.0. A touched
// row sums its squares across the warp with a fixed butterfly of shuffles.
// (Testing the bits costs ~5% of the kernel's time on the H100 against
// testing the sum of squares: PERF.md.) Rows are independent, so blocks run
// in any order. The arithmetic uses the _rn intrinsics so that nvcc
// contracts nothing into an FMA: the same operations, in the same order, as
// the plain PyTorch version (lr * g first, then * rsqrt, then the
// subtraction).

#include <cuda_runtime.h>
#include <stdint.h>

#include "row_io.cuh"

namespace {

template <typename T, bool VEC8>
__global__ void rowwise_adagrad_kernel(T* __restrict__ p, float* __restrict__ acc,
                                       const T* __restrict__ g, int64_t rows,
                                       int64_t width, float lr, float eps) {
  const int64_t r = ((int64_t)blockIdx.x * blockDim.x + threadIdx.x) >> 5;
  const int lane = threadIdx.x & 31;
  if (r >= rows) return;
  const T* gr = g + r * width;
  float ss = 0.f;
  unsigned bits = 0u;             // OR of the gradient's bit patterns
  if (VEC8) {
    // not unrolled: at W = 256 a lane reads one word, and the unrolled loop's
    // set-up delays that load (2% slower on the H100)
#pragma unroll 1
    for (int64_t c = (int64_t)lane * 8; c < width; c += 32 * 8) {
      float v[8];
      Elt<T>::load8(gr + c, v);
#pragma unroll
      for (int k = 0; k < 8; ++k) {
        ss = __fadd_rn(ss, __fmul_rn(v[k], v[k]));
        bits |= __float_as_uint(v[k]);
      }
    }
  } else {
    for (int64_t c = lane; c < width; c += 32) {
      const float v = Elt<T>::load(gr + c);
      ss = __fadd_rn(ss, __fmul_rn(v, v));
      bits |= __float_as_uint(v);
    }
  }
  // untouched row (every gradient element +0.0): p and acc stay as they are,
  // and the warp leaves before its reduction. The whole warp reaches this
  // line (r is the same for its 32 lanes).
  if (!__any_sync(0xffffffffu, bits != 0u)) return;
  ss = warp_sum(ss);
  const float a = __fadd_rn(acc[r], __fdiv_rn(ss, (float)width));
  const float rs = rsqrtf(__fadd_rn(a, eps));
  T* pr = p + r * width;
  if (VEC8) {
    for (int64_t c = (int64_t)lane * 8; c < width; c += 32 * 8) {
      float v[8], w[8];
      Elt<T>::load8(gr + c, v);
      Elt<T>::load8(pr + c, w);
#pragma unroll
      for (int k = 0; k < 8; ++k)
        w[k] = __fsub_rn(w[k], __fmul_rn(__fmul_rn(lr, v[k]), rs));
      Elt<T>::store8(pr + c, w);
    }
  } else {
    for (int64_t c = lane; c < width; c += 32) {
      const float v = Elt<T>::load(gr + c);
      Elt<T>::store(pr + c, __fsub_rn(Elt<T>::load(pr + c),
                                      __fmul_rn(__fmul_rn(lr, v), rs)));
    }
  }
  if (lane == 0) acc[r] = a;
}

template <typename T>
cudaError_t launch(void* p, float* acc, const void* g, int64_t rows,
                   int64_t width, float lr, float eps, int vec8,
                   cudaStream_t stream) {
  if (rows == 0) return cudaSuccess;
  const int threads = 256;                       // 8 rows a block
  const int64_t blocks = (rows * 32 + threads - 1) / threads;
  if (vec8)
    rowwise_adagrad_kernel<T, true><<<(unsigned)blocks, threads, 0, stream>>>(
        static_cast<T*>(p), acc, static_cast<const T*>(g), rows, width, lr, eps);
  else
    rowwise_adagrad_kernel<T, false><<<(unsigned)blocks, threads, 0, stream>>>(
        static_cast<T*>(p), acc, static_cast<const T*>(g), rows, width, lr, eps);
  return cudaGetLastError();
}

}  // namespace

// p, g: [rows, width] of dtype (0 float32, 1 bfloat16); acc: [rows] float32.
// p and acc are updated in place. vec8 = 1 when width is a multiple of 8 and
// both row pointers are 16-byte aligned. Returns a cudaError_t.
extern "C" int rf_rowwise_adagrad_update(void* p, float* acc, const void* g,
                                         int64_t rows, int64_t width,
                                         float lr, float eps, int dtype,
                                         int vec8, void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  switch (dtype) {
    case 0: return (int)launch<float>(p, acc, g, rows, width, lr, eps, vec8, s);
    case 1: return (int)launch<__nv_bfloat16>(p, acc, g, rows, width, lr, eps,
                                              vec8, s);
    default: return (int)cudaErrorInvalidValue;
  }
}

extern "C" const char* rf_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}
