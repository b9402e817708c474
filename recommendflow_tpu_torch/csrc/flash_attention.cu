// Blocked (flash) attention, forward only:
//   out[b, h, i, :] = sum_j w_ij v[b, h, j, :],  w_i = softmax_j(s_ij),
//   s_ij = (q_i . k_j) / sqrt(D) where key j is valid, -1e9 where it is masked
//   (mask[b, j] == 0), the same fill as the vanilla SDPA of
//   recommendflow_tpu/ops/attention.py:53-59. A query row whose keys are all
//   masked therefore averages v over the Lk real keys, as the vanilla path
//   does; keys past Lk (a tile's ragged edge) are left out of the sum, not
//   zero-padded in as the Pallas kernel does.
//
// Replaces: recommendflow_tpu/ops/pallas/flash_attention.py, flash_attention.
//
// Bound: bytes at the text encoder's shapes. For BERT-Base at batch 256 x 64
// tokens ([256, 12, 64, 64] f32) q, k, v and out are 50.3 MB each: 201 MB,
// 0.060 ms at the H100 SXM's 3.35 TB/s; the 4 * B * H * Lq * Lk * D = 3.22
// GFLOP take 0.048 ms at its 67 TFLOP/s FP32 rate outside the tensor cores.
//
// Design (plain FP32 SIMT, simple and right first; wgmma, TMA and bf16 tensor
// cores are later work):
//   * one block per (b * H + h, 64-query tile); TPR threads share one query
//     row (TPR = 1 up to D = 32, 2 at D <= 64, 4 at D <= 128), so a thread
//     holds at most 32 dims of q and of the f32 accumulator in registers;
//     a row's dims are dealt out to its threads in float4 chunks, interleaved
//     (chunk c*TPR + sub), so the TPR threads of a row read neighbouring
//     shared-memory banks;
//   * K and V tiles of BK keys (64, or 32 at D > 64: 32 KB together) are
//     staged through static shared memory as f32, zero-padded to the head
//     dim bucket DT (8, 16, 32, 64, 128); every thread then reads each key's
//     row as broadcast float4 loads;
//   * online softmax over steps of 16 keys: the step's scores, their max,
//     one rescale of the running sum and accumulator, then p * v; a bf16 p
//     is rounded to bf16 before the product (the Pallas contract: p in v's
//     type, f32 accumulation);
//   * the [Lq, Lk] scores never reach device memory; no atomics, so the
//     result is deterministic; every operand is read through the strides it
//     is given (the last dim must be contiguous), so split_heads' permuted
//     views need no copy and the output can be the [B, L, H, D] buffer that
//     merge_heads reads as is.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

namespace {

constexpr int BQ = 64;            // query rows per block
constexpr int CH = 16;            // keys per online-softmax step
constexpr float MASKED = -1e9f;   // the vanilla path's fill

struct Strides {                  // in elements; the last dim is contiguous
  int64_t q[3], k[3], v[3], o[3]; // batch, head, row
  int64_t mask;                   // batch stride of the [B, Lk] key mask
};

__device__ __forceinline__ float to_f32(float x) { return x; }
__device__ __forceinline__ float to_f32(__nv_bfloat16 x) {
  return __bfloat162float(x);
}

template <typename T>
__device__ __forceinline__ T from_f32(float x);
template <>
__device__ __forceinline__ float from_f32<float>(float x) { return x; }
template <>
__device__ __forceinline__ __nv_bfloat16 from_f32<__nv_bfloat16>(float x) {
  return __float2bfloat16(x);
}

// p as the P.V product takes it: in v's type
template <typename T>
__device__ __forceinline__ float p_operand(float p) {
  return to_f32(from_f32<T>(p));
}

template <int DT, int TPR, int BK, typename T>
__global__ void __launch_bounds__(BQ * TPR)
flash_attention_kernel(const T* __restrict__ q, const T* __restrict__ k,
                       const T* __restrict__ v,
                       const uint8_t* __restrict__ mask, T* __restrict__ out,
                       Strides st, int H, int Lq, int Lk, int D,
                       float sqrt_d) {
  constexpr int NT = BQ * TPR;
  constexpr int NC = DT / (4 * TPR);   // float4 chunks of a row per thread
  static_assert(NC >= 1 && BK % CH == 0, "tile shape");
  __shared__ __align__(16) float Ks[BK][DT];
  __shared__ __align__(16) float Vs[BK][DT];
  __shared__ float valid[BK];

  const int tid = threadIdx.x;
  const int sub = tid % TPR;
  const int b = blockIdx.x / H;
  const int h = blockIdx.x % H;
  const int qi = blockIdx.y * BQ + tid / TPR;
  const bool live = qi < Lq;

  const T* kb = k + b * st.k[0] + h * st.k[1];
  const T* vb = v + b * st.v[0] + h * st.v[1];

  float qr[NC * 4], acc[NC * 4];
  {
    const T* qrow = q + b * st.q[0] + h * st.q[1] + (int64_t)qi * st.q[2];
#pragma unroll
    for (int c = 0; c < NC; ++c)
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const int d = (c * TPR + sub) * 4 + e;
        qr[c * 4 + e] = (live && d < D) ? to_f32(qrow[d]) : 0.f;
        acc[c * 4 + e] = 0.f;
      }
  }
  float m = -INFINITY;   // running max of the row's scores
  float l = 0.f;         // running sum of exp(s - m)

  for (int k0 = 0; k0 < Lk; k0 += BK) {
    const int nk = min(BK, Lk - k0);
    for (int e = tid; e < BK * DT; e += NT) {
      const int j = e / DT;
      const int d = e % DT;
      const bool in = j < nk && d < D;
      Ks[j][d] = in ? to_f32(kb[(int64_t)(k0 + j) * st.k[2] + d]) : 0.f;
      Vs[j][d] = in ? to_f32(vb[(int64_t)(k0 + j) * st.v[2] + d]) : 0.f;
    }
    for (int j = tid; j < BK; j += NT)
      valid[j] = (j < nk && (mask == nullptr ||
                             mask[b * st.mask + k0 + j] != 0)) ? 1.f : 0.f;
    __syncthreads();

    for (int j0 = 0; j0 < nk; j0 += CH) {
      float s[CH];
      float step_max = -INFINITY;
#pragma unroll
      for (int jj = 0; jj < CH; ++jj) {
        const int j = j0 + jj;
        float dot = 0.f;
#pragma unroll
        for (int c = 0; c < NC; ++c) {
          const float4 kk =
              *reinterpret_cast<const float4*>(&Ks[j][(c * TPR + sub) * 4]);
          dot = fmaf(qr[c * 4 + 0], kk.x, dot);
          dot = fmaf(qr[c * 4 + 1], kk.y, dot);
          dot = fmaf(qr[c * 4 + 2], kk.z, dot);
          dot = fmaf(qr[c * 4 + 3], kk.w, dot);
        }
#pragma unroll
        for (int off = 1; off < TPR; off <<= 1)
          dot += __shfl_xor_sync(0xffffffffu, dot, off);
        // keys past Lk are left out (-inf, weight 0); j0 < nk keeps at
        // least one real key in every step, so step_max is finite
        const float sj = j >= nk ? -INFINITY
                                 : (valid[j] != 0.f ? dot / sqrt_d : MASKED);
        s[jj] = sj;
        step_max = fmaxf(step_max, sj);
      }
      const float m_new = fmaxf(m, step_max);
      const float corr = expf(m - m_new);   // 0 at the first step (m = -inf)
      l *= corr;
#pragma unroll
      for (int i = 0; i < NC * 4; ++i) acc[i] *= corr;
#pragma unroll
      for (int jj = 0; jj < CH; ++jj) {
        const int j = j0 + jj;
        const float p = expf(s[jj] - m_new);
        l += p;
        const float pv = p_operand<T>(p);
#pragma unroll
        for (int c = 0; c < NC; ++c) {
          const float4 vv =
              *reinterpret_cast<const float4*>(&Vs[j][(c * TPR + sub) * 4]);
          acc[c * 4 + 0] = fmaf(pv, vv.x, acc[c * 4 + 0]);
          acc[c * 4 + 1] = fmaf(pv, vv.y, acc[c * 4 + 1]);
          acc[c * 4 + 2] = fmaf(pv, vv.z, acc[c * 4 + 2]);
          acc[c * 4 + 3] = fmaf(pv, vv.w, acc[c * 4 + 3]);
        }
      }
      m = m_new;
    }
    __syncthreads();
  }

  if (live) {
    T* orow = out + b * st.o[0] + h * st.o[1] + (int64_t)qi * st.o[2];
#pragma unroll
    for (int c = 0; c < NC; ++c)
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const int d = (c * TPR + sub) * 4 + e;
        if (d < D) orow[d] = from_f32<T>(acc[c * 4 + e] / l);
      }
  }
}

template <int DT, int TPR, int BK, typename T>
cudaError_t launch(const void* q, const void* k, const void* v,
                   const uint8_t* mask, void* out, const Strides& st, int B,
                   int H, int Lq, int Lk, int D, cudaStream_t stream) {
  const int64_t bh = (int64_t)B * H;
  const int q_tiles = (Lq + BQ - 1) / BQ;
  if (bh > 0x7fffffffLL || q_tiles > 65535) return cudaErrorInvalidConfiguration;
  dim3 grid((unsigned)bh, (unsigned)q_tiles);
  flash_attention_kernel<DT, TPR, BK, T><<<grid, BQ * TPR, 0, stream>>>(
      static_cast<const T*>(q), static_cast<const T*>(k),
      static_cast<const T*>(v), mask, static_cast<T*>(out), st, H, Lq, Lk, D,
      sqrtf((float)D));
  return cudaGetLastError();
}

template <typename T>
cudaError_t dispatch(const void* q, const void* k, const void* v,
                     const uint8_t* mask, void* out, const Strides& st, int B,
                     int H, int Lq, int Lk, int D, cudaStream_t s) {
  if (D <= 8) return launch<8, 1, 64, T>(q, k, v, mask, out, st, B, H, Lq, Lk, D, s);
  if (D <= 16) return launch<16, 1, 64, T>(q, k, v, mask, out, st, B, H, Lq, Lk, D, s);
  if (D <= 32) return launch<32, 1, 64, T>(q, k, v, mask, out, st, B, H, Lq, Lk, D, s);
  if (D <= 64) return launch<64, 2, 64, T>(q, k, v, mask, out, st, B, H, Lq, Lk, D, s);
  if (D <= 128) return launch<128, 4, 32, T>(q, k, v, mask, out, st, B, H, Lq, Lk, D, s);
  return cudaErrorInvalidValue;
}

}  // namespace

// q [B, H, Lq, D], k and v [B, H, Lk, D], out [B, H, Lq, D], all f32
// (dtype 0) or all bf16 (1), read and written through `strides`: 13 int64
// values, the batch, head and row strides of q, k, v and out in elements
// (each last dim contiguous), then the batch stride of `mask`, a [B, Lk]
// bool key mask (1 = valid) or null (every key valid). 1 <= D <= 128,
// Lk >= 1. Returns a cudaError_t.
extern "C" int rf_flash_attention(const void* q, const void* k, const void* v,
                                  const uint8_t* mask, void* out, int dtype,
                                  const int64_t* strides, int B, int H, int Lq,
                                  int Lk, int D, void* stream) {
  if (D < 1 || D > 128 || Lk < 1 || B < 0 || H < 0 || Lq < 0)
    return (int)cudaErrorInvalidValue;
  if ((int64_t)B * H == 0 || Lq == 0) return (int)cudaSuccess;
  Strides st;
  for (int i = 0; i < 3; ++i) {
    st.q[i] = strides[i];
    st.k[i] = strides[3 + i];
    st.v[i] = strides[6 + i];
    st.o[i] = strides[9 + i];
  }
  st.mask = strides[12];
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (dtype == 0)
    return (int)dispatch<float>(q, k, v, mask, out, st, B, H, Lq, Lk, D, s);
  if (dtype == 1)
    return (int)dispatch<__nv_bfloat16>(q, k, v, mask, out, st, B, H, Lq, Lk,
                                        D, s);
  return (int)cudaErrorInvalidValue;
}

extern "C" const char* rf_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}
