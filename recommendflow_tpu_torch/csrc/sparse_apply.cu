// Row-wise Adagrad applied to the touched rows only, from compacted f32 row
// gradients (unique sorted row ids, duplicates already summed):
//
//   for i < n_valid with 0 <= uid[i] < rows, r = uid[i]:
//     acc[r] += mean(gs[i, :]^2)
//     p[r, :] -= lr * gs[i, :] * rsqrt(acc[r] + eps)
//
// in float32, one rounding back to p's type; every other row of p and acc
// stays bit for bit as it was.
//
// Replaces: recommendflow_tpu/ops/pallas/sparse_apply.py,
// sparse_adagrad_apply (with _compact_sorted and split_update_pallas), and the
// gather / compute / sorted scatter-SET of train/optimizers.py:
// split_table_update's "sparse_set" strategy (:277-287) that the JAX trainer
// runs.
//
// Bound: bytes. Each valid row reads its f32 gradient row, its acc and its p
// row and writes p and acc back: for the bench_recall dim-64 bf16 table
// (512-byte rows, W = 256) that is 1 KB of gradient + 1 KB of p + 8 bytes a
// row, ~53 us at 3.35 TB/s for ~87k rows.
//
// Design: the TPU kernel streams the whole table in 2048-row blocks and
// assembles each block's gradient rows from a 16-aligned window of the sorted
// gradient array with a one-hot product on the MXU, falling back to the XLA
// path when a block's rows overflow the window. None of that is needed here:
// one warp owns one unique row, reads its gradient row and the table row it
// names, and writes both back, so the table is touched only where the batch
// touched it, in any order, with no window and no fallback. The ids are
// unique, so no two warps write one row. n_valid is read from device memory
// (no host sync); padding entries carry ids >= rows and are skipped, never
// clamped onto a real row. The _rn intrinsics keep nvcc from contracting
// into FMAs, so the arithmetic is the plain version's, operation for
// operation.

#include <cuda_runtime.h>
#include <stdint.h>

#include "row_io.cuh"

namespace {

template <typename T, bool VEC8>
__global__ void sparse_adagrad_kernel(T* __restrict__ p, float* __restrict__ acc,
                                      const int32_t* __restrict__ uid,
                                      const float* __restrict__ gs,
                                      const int32_t* __restrict__ n_valid,
                                      int64_t n, int64_t rows, int64_t width,
                                      float lr, float eps) {
  const int64_t i = ((int64_t)blockIdx.x * blockDim.x + threadIdx.x) >> 5;
  const int lane = threadIdx.x & 31;
  if (i >= n || i >= (int64_t)__ldg(n_valid)) return;
  const int64_t r = (int64_t)__ldg(uid + i);
  if (r < 0 || r >= rows) return;
  const float* gr = gs + i * width;
  float ss = 0.f;
  if (VEC8) {
    for (int64_t c = (int64_t)lane * 8; c < width; c += 32 * 8) {
      float v[8];
      Elt<float>::load8(gr + c, v);
#pragma unroll
      for (int k = 0; k < 8; ++k) ss = __fadd_rn(ss, __fmul_rn(v[k], v[k]));
    }
  } else {
    for (int64_t c = lane; c < width; c += 32) {
      const float v = __ldg(gr + c);
      ss = __fadd_rn(ss, __fmul_rn(v, v));
    }
  }
  ss = warp_sum(ss);
  const float a = __fadd_rn(acc[r], __fdiv_rn(ss, (float)width));
  const float rs = rsqrtf(__fadd_rn(a, eps));
  T* pr = p + r * width;
  if (VEC8) {
    for (int64_t c = (int64_t)lane * 8; c < width; c += 32 * 8) {
      float v[8], w[8];
      Elt<float>::load8(gr + c, v);
      Elt<T>::load8(pr + c, w);
#pragma unroll
      for (int k = 0; k < 8; ++k)
        w[k] = __fsub_rn(w[k], __fmul_rn(__fmul_rn(lr, v[k]), rs));
      Elt<T>::store8(pr + c, w);
    }
  } else {
    for (int64_t c = lane; c < width; c += 32) {
      const float v = __ldg(gr + c);
      Elt<T>::store(pr + c, __fsub_rn(Elt<T>::load(pr + c),
                                      __fmul_rn(__fmul_rn(lr, v), rs)));
    }
  }
  if (lane == 0) acc[r] = a;
}

template <typename T>
cudaError_t launch(void* p, float* acc, const int32_t* uid, const float* gs,
                   const int32_t* n_valid, int64_t n, int64_t rows,
                   int64_t width, float lr, float eps, int vec8,
                   cudaStream_t stream) {
  if (n == 0) return cudaSuccess;
  const int threads = 256;                       // 8 rows a block
  const int64_t blocks = (n * 32 + threads - 1) / threads;
  T* pt = static_cast<T*>(p);
  if (vec8)
    sparse_adagrad_kernel<T, true><<<(unsigned)blocks, threads, 0, stream>>>(
        pt, acc, uid, gs, n_valid, n, rows, width, lr, eps);
  else
    sparse_adagrad_kernel<T, false><<<(unsigned)blocks, threads, 0, stream>>>(
        pt, acc, uid, gs, n_valid, n, rows, width, lr, eps);
  return cudaGetLastError();
}

}  // namespace

// p: [rows, width] of dtype (0 float32, 1 bfloat16) and acc: [rows] float32,
// both updated in place; uid: [n] int32; gs: [n, width] float32; n_valid: one
// int32 in device memory. vec8 = 1 when width is a multiple of 8 and the p and
// gs pointers are 16-byte aligned. Returns a cudaError_t.
extern "C" int rf_sparse_adagrad_apply(void* p, float* acc, const int32_t* uid,
                                       const float* gs, const int32_t* n_valid,
                                       int64_t n, int64_t rows, int64_t width,
                                       float lr, float eps, int dtype, int vec8,
                                       void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  switch (dtype) {
    case 0: return (int)launch<float>(p, acc, uid, gs, n_valid, n, rows, width,
                                      lr, eps, vec8, s);
    case 1: return (int)launch<__nv_bfloat16>(p, acc, uid, gs, n_valid, n, rows,
                                              width, lr, eps, vec8, s);
    default: return (int)cudaErrorInvalidValue;
  }
}

extern "C" const char* rf_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}
