// Fused score + group-max scan for exact top-k retrieval:
//   m1[q, g] = max over items i of group g (items g*G .. g*G+G-1) of s(q, i),
//   s(q, i) = q . v_i                 (ip, cos)
//           = 2 q . v_i - |v_i|^2     (l2 surrogate, when sq_norms is given)
//   and s(q, i) = NEG = -1e30 for i >= num_items (padding), before the max.
//
// Replaces: recommendflow_tpu/ops/pallas/grouped_topk.py, grouped_score_max,
// in its three corpus types: f32, bf16 and uint8 (SQ8 codes, :50-56). Its
// output there is transposed ([N/G, Q]) only for a Mosaic reshape limit;
// this kernel writes [Q, N/G] directly. For a bf16 or uint8 corpus the
// wrapper rounds the queries through bf16 first, as the Pallas function does
// (:84-87); codes <= 255 and bf16 values widen to f32 exactly, so every
// product is exact in f32 and only the order of the f32 sums differs.
//
// Bound: operations. 2 * Q * N * D flops: for a 4096-query block over a
// 1,048,576 x 128 corpus that is 1.10 TFLOP, about 16 ms at the H100 SXM's
// 67 TFLOP/s FP32 rate outside the tensor cores (2.2 ms on TF32 tensor
// cores, a later kernel's target). The m1 write is 1.07 GB (~0.3 ms). The
// bf16 and uint8 forms do bf16 x bf16 work (queries rounded to bf16, codes
// <= 255 exact in bf16), whose bound is the bf16 tensor-core rate: 1.11 ms
// at that shape (989 TFLOP/s), above the bytes (0.36 ms for uint8 codes).
//
// Design (plain FP32 SIMT; wgmma and TMA are later work):
//   * block = 256 threads on a 128-query x 128-item output tile; the grid is
//     1-D with the query tile fastest, so consecutive blocks share one corpus
//     tile and the corpus streams from device memory about once per call;
//   * query and corpus tiles are staged through shared memory in D-chunks of
//     16, stored k-major; a bf16 or uint8 corpus is widened to f32 there
//     (one element a thread: the 16-byte loads of the codes are later work);
//   * each thread keeps an 8 x 8 f32 accumulator in registers: queries
//     {ty*4+i, 64+ty*4+i} x items {tx*4+j, 64+tx*4+j}, so a thread holds runs
//     of 4 consecutive items and a group of G items spans G/4 neighbouring
//     lanes of one warp;
//   * the epilogue forms the l2 surrogate, masks items >= num_items to NEG,
//     takes the max over the thread's run of 4 and then over the G/4 lanes
//     with warp shuffles; one lane per group writes m1. The [Q, N] score
//     matrix never reaches device memory, which is the point of the kernel.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int BQ = 128;   // queries per block tile
constexpr int BN = 128;   // items per block tile
constexpr int BK = 16;    // D-chunk staged per step
constexpr int PAD = 4;    // keeps rows 16-byte aligned, spreads store banks
constexpr int NT = 256;   // threads per block
constexpr float NEG = -1e30f;

__device__ __forceinline__ float widen(float x) { return x; }
__device__ __forceinline__ float widen(__nv_bfloat16 x) {
  return __bfloat162float(x);
}
__device__ __forceinline__ float widen(uint8_t x) { return (float)x; }

template <typename T>
__global__ void __launch_bounds__(NT)
grouped_score_max_kernel(const float* __restrict__ q,
                         const T* __restrict__ v,
                         const float* __restrict__ sqn,
                         float* __restrict__ m1, int nq, int64_t n_pad,
                         int d, int group, int64_t num_items, int n_qtiles) {
  __shared__ __align__(16) float As[BK][BQ + PAD];
  __shared__ __align__(16) float Bs[BK][BN + PAD];

  const int tid = threadIdx.x;
  const int tx = tid & 15;
  const int ty = tid >> 4;
  const int64_t bid = blockIdx.x;
  const int q0 = (int)(bid % n_qtiles) * BQ;
  const int64_t i0 = (bid / n_qtiles) * BN;

  float acc[8][8];
#pragma unroll
  for (int i = 0; i < 8; ++i)
#pragma unroll
    for (int j = 0; j < 8; ++j) acc[i][j] = 0.f;

  for (int k0 = 0; k0 < d; k0 += BK) {
#pragma unroll
    for (int e = tid; e < BQ * BK; e += NT) {
      const int r = e / BK;
      const int c = e % BK;
      const int kk = k0 + c;
      const int qi = q0 + r;
      As[c][r] = (qi < nq && kk < d) ? __ldg(q + (int64_t)qi * d + kk) : 0.f;
      const int64_t vi = i0 + r;
      Bs[c][r] = (vi < n_pad && kk < d) ? widen(v[vi * d + kk]) : 0.f;
    }
    __syncthreads();
#pragma unroll
    for (int k = 0; k < BK; ++k) {
      const float4 a0 = *reinterpret_cast<const float4*>(&As[k][ty * 4]);
      const float4 a1 = *reinterpret_cast<const float4*>(&As[k][64 + ty * 4]);
      const float4 b0 = *reinterpret_cast<const float4*>(&Bs[k][tx * 4]);
      const float4 b1 = *reinterpret_cast<const float4*>(&Bs[k][64 + tx * 4]);
      const float a[8] = {a0.x, a0.y, a0.z, a0.w, a1.x, a1.y, a1.z, a1.w};
      const float b[8] = {b0.x, b0.y, b0.z, b0.w, b1.x, b1.y, b1.z, b1.w};
#pragma unroll
      for (int i = 0; i < 8; ++i)
#pragma unroll
        for (int j = 0; j < 8; ++j) acc[i][j] = fmaf(a[i], b[j], acc[i][j]);
    }
    __syncthreads();
  }

  const int lanes = group / 4;  // lanes sharing one group: 1, 2, 4, 8 or 16
  const int64_t n_groups = n_pad / group;
#pragma unroll
  for (int h = 0; h < 2; ++h) {
    const int64_t item = i0 + h * 64 + tx * 4;  // first of this thread's 4
    float sq[4];
    bool ok[4];
#pragma unroll
    for (int j = 0; j < 4; ++j) {
      ok[j] = item + j < num_items;
      sq[j] = (sqn != nullptr && item + j < n_pad) ? __ldg(sqn + item + j)
                                                   : 0.f;
    }
    const int64_t g = item / group;
#pragma unroll
    for (int i = 0; i < 8; ++i) {
      float m = NEG;
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        float s = acc[i][h * 4 + j];
        if (sqn != nullptr) s = 2.f * s - sq[j];
        m = fmaxf(m, ok[j] ? s : NEG);
      }
      for (int off = 1; off < lanes; off <<= 1)
        m = fmaxf(m, __shfl_xor_sync(0xffffffffu, m, off));
      const int qi = q0 + (i < 4 ? ty * 4 + i : 64 + ty * 4 + (i - 4));
      if ((tx % lanes) == 0 && qi < nq && g < n_groups)
        m1[(int64_t)qi * n_groups + g] = m;
    }
  }
}

template <typename T>
cudaError_t launch(const float* q, const void* v, const float* sqn, float* m1,
                   int nq, int64_t n_pad, int d, int group, int64_t num_items,
                   cudaStream_t stream) {
  const int n_qtiles = (nq + BQ - 1) / BQ;
  const int64_t n_itiles = (n_pad + BN - 1) / BN;
  const int64_t blocks = (int64_t)n_qtiles * n_itiles;
  if (blocks == 0) return cudaSuccess;
  if (blocks > 0x7fffffffLL) return cudaErrorInvalidConfiguration;
  grouped_score_max_kernel<T><<<(unsigned)blocks, NT, 0, stream>>>(
      q, static_cast<const T*>(v), sqn, m1, nq, n_pad, d, group, num_items,
      n_qtiles);
  return cudaGetLastError();
}

}  // namespace

// queries [nq, d] f32; vecs [n_pad, d] f32 (vec_dtype 0), bf16 (1) or uint8 (2);
// sq_norms [n_pad] f32 or null; m1 [nq, n_pad / group] f32.
// group must be 4, 8, 16, 32 or 64 and divide n_pad. Returns a cudaError_t.
extern "C" int rf_grouped_score_max(const float* queries, const void* vecs,
                                    int vec_dtype, const float* sq_norms,
                                    float* m1, int nq, int64_t n_pad, int d,
                                    int group, int64_t num_items,
                                    void* stream) {
  if (group != 4 && group != 8 && group != 16 && group != 32 && group != 64)
    return (int)cudaErrorInvalidValue;
  if (n_pad % group != 0) return (int)cudaErrorInvalidValue;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (vec_dtype == 0)
    return (int)launch<float>(queries, vecs, sq_norms, m1, nq, n_pad, d,
                              group, num_items, s);
  if (vec_dtype == 1)
    return (int)launch<__nv_bfloat16>(queries, vecs, sq_norms, m1, nq, n_pad,
                                      d, group, num_items, s);
  if (vec_dtype == 2)
    return (int)launch<uint8_t>(queries, vecs, sq_norms, m1, nq, n_pad, d,
                                group, num_items, s);
  return (int)cudaErrorInvalidValue;
}

extern "C" const char* rf_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}
