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
// Bound: bytes and FP32 operations, nearly level, at the text encoder's
// shape. For BERT-Base at batch 256 x 64 tokens ([256, 12, 64, 64] f32) q, k,
// v and out are 50.3 MB each: 201 MB, 0.060 ms at the H100 SXM's 3.35 TB/s;
// the 4 * B * H * Lq * Lk * D = 3.22 GFLOP take 0.048 ms at its 67 TFLOP/s
// FP32 rate outside the tensor cores. The f32 form stays on the FP32 pipes
// (the encoder runs f32 with TF32 off), so the kernel has to keep both the
// memory system and the FMA pipes busy: every shared-memory load must feed
// several FMAs, the loads must be wide and overlap the products, and enough
// warps must stay resident to hide the latency.
//
// Design (FP32 SIMT, register-tiled; 128 threads and 64 query rows a block,
// one block per (b * H + h, 64-query tile)):
//   * Lk <= 128: the whole head in one tile (64 or 128 keys), one pass, no
//     online rescale. Q, K, V and the key mask of one (b, h) are staged into
//     shared memory (V in a copy group of its own, so S = Q K^T starts
//     before V has landed) as f32 rows (padded by 4 floats, so rows stay
//     16-byte aligned and neighbouring rows start on other banks) with 16-byte
//     cp.async copies where the rows allow it (f32, D % 4 == 0, aligned
//     strides), else 4-byte copies; a bf16 operand is widened on the way in.
//   * S = Q K^T: thread (r, c) computes an 8-row x (Lk/16)-key patch: rows
//     8r..8r+7, keys c, c+16, ...; per 4 dims one float4 load of each of its
//     keys and one of each row feeds 8 * 4 * 4 FMAs.
//   * each row's max and sum are taken over the 16 lanes that share it with
//     4 xor-shuffles; every score's exp is computed once, as exp2f of the
//     score pre-scaled by log2(e) / sqrt(D) (a masked score becomes
//     -1e9 * log2(e): the same weights, exp(-1e9 - m) and exp2(-1e9 log2(e)
//     - m') are both +0 once a real key sets the max, and both 1 when every
//     key is masked). P goes to shared memory (over Q, which is no longer
//     needed, when it fits), in v's type for a bf16 v (the Pallas
//     contract: p rounded to bf16 before P.V, f32 accumulation).
//   * O = P V: thread (ro, co) holds DT/8 rows x 4 consecutive dims (DT is
//     D rounded up to 32, 64 or 128; zero-padded), so per 4 keys 4 float4
//     loads of V and DT/8 of P feed 2 * DT FMAs; the output is written with
//     16-byte stores.
//   * Lk > 128: the same tile over 64-key steps with online softmax; the
//     next step's K, V and mask are copied (cp.async) while the current one
//     is computed (two buffers). A 64-key step whose keys are all masked is
//     skipped when the batch row has a valid key: exp(-1e9 - m) is +0 in f32
//     once a real score sets m, and adding +0 changes no sum.
//   * D > 128 (flash_attention_wide_kernel): the head dim in 128-wide
//     chunks, one output chunk a block, the scores summed over every chunk;
//     always the 64-key online steps.
//   * at the encoder's shape a block holds 52 KB of shared memory, so four
//     blocks (16 warps) stay resident on an SM; no atomics, so the result is
//     deterministic; every operand is read through the strides it is given
//     (the last dim must be contiguous), so split_heads' permuted views need
//     no copy and the output can be the [B, L, H, D] buffer that merge_heads
//     reads as is.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

namespace {

constexpr int BQ = 64;             // query rows per block
constexpr int NT = 128;            // threads per block
constexpr float LOG2E = 1.4426950408889634f;
constexpr float MASKED = -1e9f * LOG2E;   // the vanilla fill, in log2 units

struct Strides {                   // in elements; the last dim is contiguous
  int64_t q[3], k[3], v[3], o[3];  // batch, head, row
  int64_t mask;                    // batch stride of the [B, Lk] key mask
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

__device__ __forceinline__ uint32_t smem_addr(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}
// cp.async of 16 or 4 bytes; a source size of 0 fills the destination with
// zeros (the source address is then not read)
__device__ __forceinline__ void cp_async16(float* dst, const float* src,
                                           bool in) {
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::"r"(
                   smem_addr(dst)),
               "l"(src), "r"(in ? 16 : 0));
}
__device__ __forceinline__ void cp_async4(float* dst, const float* src,
                                          bool in) {
  asm volatile("cp.async.ca.shared.global [%0], [%1], 4, %2;\n" ::"r"(
                   smem_addr(dst)),
               "l"(src), "r"(in ? 4 : 0));
}
__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::);
}
template <int N>
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(N));
}

// Copy `rows` rows of D values (row stride `stride`) into a [ROWS][LD] f32
// tile; rows >= valid_rows and dims >= D become 0. f32 rows go by cp.async
// (16 bytes when `vec`), bf16 rows are widened through registers.
template <int ROWS, int DT, int LD>
__device__ __forceinline__ void stage(float* dst, const float* src,
                                      int64_t stride, int valid_rows, int D,
                                      bool vec) {
  if (vec) {
    constexpr int CH = DT / 4;
    for (int e = threadIdx.x; e < ROWS * CH; e += NT) {
      const int r = e / CH, d = (e % CH) * 4;
      const bool in = r < valid_rows && d < D;
      cp_async16(dst + r * LD + d, in ? src + r * stride + d : src, in);
    }
  } else {
    for (int e = threadIdx.x; e < ROWS * DT; e += NT) {
      const int r = e / DT, d = e % DT;
      const bool in = r < valid_rows && d < D;
      cp_async4(dst + r * LD + d, in ? src + r * stride + d : src, in);
    }
  }
}
template <int ROWS, int DT, int LD>
__device__ __forceinline__ void stage(float* dst, const __nv_bfloat16* src,
                                      int64_t stride, int valid_rows, int D,
                                      bool) {
  for (int e = threadIdx.x; e < ROWS * DT; e += NT) {
    const int r = e / DT, d = e % DT;
    dst[r * LD + d] = (r < valid_rows && d < D)
                          ? __bfloat162float(src[r * stride + d]) : 0.f;
  }
}

// 1.0 for a key < nk that the mask keeps, else 0; returns whether this
// thread saw a valid key
template <int BK>
__device__ __forceinline__ bool stage_valid(float* valid, const uint8_t* m,
                                            int nk) {
  bool any = false;
  for (int j = threadIdx.x; j < BK; j += NT) {
    const bool ok = j < nk && (m == nullptr || m[j] != 0);
    valid[j] = ok ? 1.f : 0.f;
    any |= ok;
  }
  return any;
}

template <int DT, int BK, bool ONLINE>
struct Layout {                       // offsets in floats of dynamic smem
  static constexpr int LDQ = DT + 4;  // row stride of Q, K and V tiles
  static constexpr int LDP = BK + 4;  // row stride of P
  static constexpr int NBUF = ONLINE ? 2 : 1;
  // P reuses Q's space in the one-pass kernel when it fits
  static constexpr bool P_OVER_Q = !ONLINE && LDP <= LDQ;
  static constexpr int Q = 0;
  static constexpr int K = Q + BQ * LDQ;
  static constexpr int V = K + NBUF * BK * LDQ;
  static constexpr int P = P_OVER_Q ? Q : V + NBUF * BK * LDQ;
  static constexpr int VALID = (P_OVER_Q ? V + NBUF * BK * LDQ : P + BQ * LDP);
  static constexpr int ROWC = VALID + NBUF * BK;   // per-row rescale factor
  static constexpr int ROWL = ROWC + BQ;           // per-row sum of weights
  static constexpr int FLOATS = ROWL + BQ;
  static constexpr size_t BYTES = FLOATS * sizeof(float);
};


template <int KPT>
__device__ __forceinline__ void zero_scores(float (&s)[8][KPT]) {
#pragma unroll
  for (int i = 0; i < 8; ++i)
#pragma unroll
    for (int j = 0; j < KPT; ++j) s[i][j] = 0.f;
}

// S += Q K^T for rows 8r..8r+7 and keys c + 16j of a staged tile
template <int DT, int KPT, int LD>
__device__ __forceinline__ void qk_add(float (&s)[8][KPT], const float* Qs,
                                       const float* Ks, int r, int c) {
#pragma unroll 2
  for (int d = 0; d < DT; d += 4) {
    float4 kk[KPT];
#pragma unroll
    for (int j = 0; j < KPT; ++j)
      kk[j] = *reinterpret_cast<const float4*>(Ks + (c + 16 * j) * LD + d);
#pragma unroll
    for (int i = 0; i < 8; ++i) {
      const float4 a = *reinterpret_cast<const float4*>(Qs + (8 * r + i) * LD + d);
#pragma unroll
      for (int j = 0; j < KPT; ++j) {
        s[i][j] = fmaf(a.x, kk[j].x, s[i][j]);
        s[i][j] = fmaf(a.y, kk[j].y, s[i][j]);
        s[i][j] = fmaf(a.z, kk[j].z, s[i][j]);
        s[i][j] = fmaf(a.w, kk[j].w, s[i][j]);
      }
    }
  }
}

// S = Q K^T for rows 8r..8r+7 and keys c + 16j of a staged tile
template <int DT, int KPT, int LD>
__device__ __forceinline__ void qk(float (&s)[8][KPT], const float* Qs,
                                   const float* Ks, int r, int c) {
  zero_scores<KPT>(s);
  qk_add<DT, KPT, LD>(s, Qs, Ks, r, c);
}

// acc += P V for rows ro*RPT.. and dims 4co..4co+3 over keys [0, nk)
// (rounded up to 4: P is 0 and V is zero-filled past nk)
template <int RPT, int LDP, int LDV>
__device__ __forceinline__ void pv(float (&acc)[RPT][4], const float* Ps,
                                   const float* Vs, int ro, int co, int nk) {
  for (int kk = 0; kk < nk; kk += 4) {
    float4 vv[4];
#pragma unroll
    for (int e = 0; e < 4; ++e)
      vv[e] = *reinterpret_cast<const float4*>(Vs + (kk + e) * LDV + 4 * co);
#pragma unroll
    for (int i = 0; i < RPT; ++i) {
      const float4 p =
          *reinterpret_cast<const float4*>(Ps + (ro * RPT + i) * LDP + kk);
      const float pe[4] = {p.x, p.y, p.z, p.w};
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        acc[i][0] = fmaf(pe[e], vv[e].x, acc[i][0]);
        acc[i][1] = fmaf(pe[e], vv[e].y, acc[i][1]);
        acc[i][2] = fmaf(pe[e], vv[e].z, acc[i][2]);
        acc[i][3] = fmaf(pe[e], vv[e].w, acc[i][3]);
      }
    }
  }
}

// the scores of one tile in log2 units: masked keys at MASKED, keys past nk
// at -inf (left out); returns each row's max over the 16 lanes sharing it
template <int KPT>
__device__ __forceinline__ void mask_scale(float (&s)[8][KPT], float (&mx)[8],
                                           const float* valid, int nk, int c,
                                           float scale_log2) {
#pragma unroll
  for (int i = 0; i < 8; ++i) {
    float m = -INFINITY;
#pragma unroll
    for (int j = 0; j < KPT; ++j) {
      const int key = c + 16 * j;
      const float t = key >= nk ? -INFINITY
                                : (valid[key] != 0.f ? s[i][j] * scale_log2
                                                     : MASKED);
      s[i][j] = t;
      m = fmaxf(m, t);
    }
#pragma unroll
    for (int off = 1; off < 16; off <<= 1)
      m = fmaxf(m, __shfl_xor_sync(0xffffffffu, m, off));
    mx[i] = m;
  }
}

// s <- exp2(s - m) per row; returns each row's sum over its 16 lanes
template <int KPT>
__device__ __forceinline__ void exp_rows(float (&s)[8][KPT],
                                         const float (&m)[8], float (&sum)[8]) {
#pragma unroll
  for (int i = 0; i < 8; ++i) {
    float l = 0.f;
#pragma unroll
    for (int j = 0; j < KPT; ++j) {
      s[i][j] = exp2f(s[i][j] - m[i]);
      l += s[i][j];
    }
#pragma unroll
    for (int off = 1; off < 16; off <<= 1)
      l += __shfl_xor_sync(0xffffffffu, l, off);
    sum[i] = l;
  }
}

template <typename T, int KPT, int LDP>
__device__ __forceinline__ void store_p(float* Ps, const float (&s)[8][KPT],
                                        int r, int c) {
#pragma unroll
  for (int i = 0; i < 8; ++i)
#pragma unroll
    for (int j = 0; j < KPT; ++j)
      Ps[(8 * r + i) * LDP + c + 16 * j] = p_operand<T>(s[i][j]);
}

template <int DT, int BK, bool ONLINE, typename T>
__global__ void __launch_bounds__(NT, (!ONLINE && BK == 64) ? 4 : 1)
flash_attention_kernel(const T* __restrict__ q, const T* __restrict__ k,
                       const T* __restrict__ v,
                       const uint8_t* __restrict__ mask, T* __restrict__ out,
                       Strides st, int H, int Lq, int Lk, int D,
                       float scale_log2, bool vec) {
  using L = Layout<DT, BK, ONLINE>;
  constexpr int KPT = BK / 16;        // keys per thread in S = Q K^T
  constexpr int CG = DT / 4;          // 4-dim column groups in O = P V
  constexpr int RPT = BQ * CG / NT;   // rows per thread in O = P V
  static_assert(RPT >= 1 && KPT >= 1, "tile shape");
  extern __shared__ __align__(16) float smem[];
  float* Qs = smem + L::Q;
  float* Ks = smem + L::K;
  float* Vs = smem + L::V;
  float* Ps = smem + L::P;
  float* valid = smem + L::VALID;
  float* rowc = smem + L::ROWC;
  float* rowl = smem + L::ROWL;

  const int tid = threadIdx.x;
  const int b = blockIdx.x / H;
  const int h = blockIdx.x % H;
  const int q0 = blockIdx.y * BQ;
  const T* kb = k + b * st.k[0] + h * st.k[1];
  const T* vb = v + b * st.v[0] + h * st.v[1];
  const uint8_t* mb = mask ? mask + b * st.mask : nullptr;
  // S = Q K^T ownership: rows 8r..8r+7, keys c + 16j
  const int r = tid / 16, c = tid % 16;
  // O = P V ownership: rows ro*RPT.., dims 4co..4co+3
  const int ro = tid / CG, co = tid % CG;

  stage<BQ, DT, L::LDQ>(Qs, q + b * st.q[0] + h * st.q[1] + q0 * st.q[2],
                        st.q[2], min(BQ, Lq - q0), D, vec);
  float acc[RPT][4];
#pragma unroll
  for (int i = 0; i < RPT; ++i)
#pragma unroll
    for (int e = 0; e < 4; ++e) acc[i][e] = 0.f;
  float s[8][KPT], m[8], l[8];

  if constexpr (!ONLINE) {
    // the whole head in one tile (Lk <= BK)
    // Q and K in one copy group, V in the next: S = Q K^T starts while V
    // is still on its way
    stage<BK, DT, L::LDQ>(Ks, kb, st.k[2], Lk, D, vec);
    cp_async_commit();
    stage<BK, DT, L::LDQ>(Vs, vb, st.v[2], Lk, D, vec);
    cp_async_commit();
    stage_valid<BK>(valid, mb, Lk);
    cp_async_wait<1>();
    __syncthreads();
    qk<DT, KPT, L::LDQ>(s, Qs, Ks, r, c);
    mask_scale<KPT>(s, m, valid, Lk, c, scale_log2);
    exp_rows<KPT>(s, m, l);
    if (L::P_OVER_Q) __syncthreads();   // every thread is done with Q
    store_p<T, KPT, L::LDP>(Ps, s, r, c);
    if (c == 0)
#pragma unroll
      for (int i = 0; i < 8; ++i) rowl[8 * r + i] = l[i];
    cp_async_wait<0>();
    __syncthreads();
    pv<RPT, L::LDP, L::LDQ>(acc, Ps, Vs, ro, co, Lk);
  } else {
    // 64-key steps with online softmax, the next step copied while the
    // current one is computed
    const int steps = (Lk + BK - 1) / BK;
    bool has_valid = true;             // may a wholly masked step be skipped?
    if (mb != nullptr) {
      bool any = false;
      for (int j = tid; j < Lk; j += NT) any |= mb[j] != 0;
      has_valid = __syncthreads_or(any);
    }
    stage<BK, DT, L::LDQ>(Ks, kb, st.k[2], min(BK, Lk), D, vec);
    stage<BK, DT, L::LDQ>(Vs, vb, st.v[2], min(BK, Lk), D, vec);
    cp_async_commit();
    bool my_any = stage_valid<BK>(valid, mb, min(BK, Lk));
#pragma unroll
    for (int i = 0; i < 8; ++i) {
      m[i] = -INFINITY;
      l[i] = 0.f;
    }
    for (int t = 0; t < steps; ++t) {
      const int buf = t & 1;
      const int nk = min(BK, Lk - t * BK);
      bool next_any = false;
      if (t + 1 < steps) {
        const int k1 = (t + 1) * BK;
        const int nk1 = min(BK, Lk - k1);
        stage<BK, DT, L::LDQ>(Ks + (buf ^ 1) * BK * L::LDQ,
                              kb + k1 * st.k[2], st.k[2], nk1, D, vec);
        stage<BK, DT, L::LDQ>(Vs + (buf ^ 1) * BK * L::LDQ,
                              vb + k1 * st.v[2], st.v[2], nk1, D, vec);
        cp_async_commit();
        next_any = stage_valid<BK>(valid + (buf ^ 1) * BK,
                                   mb ? mb + k1 : nullptr, nk1);
        cp_async_wait<1>();
      } else {
        cp_async_wait<0>();
      }
      const bool step_any = __syncthreads_or(my_any);
      my_any = next_any;
      if (has_valid && !step_any) continue;   // exact: its weights are +0
      const float* Kt = Ks + buf * BK * L::LDQ;
      const float* Vt = Vs + buf * BK * L::LDQ;
      float mx[8], sum[8], corr[8];
      qk<DT, KPT, L::LDQ>(s, Qs, Kt, r, c);
      mask_scale<KPT>(s, mx, valid + buf * BK, nk, c, scale_log2);
#pragma unroll
      for (int i = 0; i < 8; ++i) {
        const float m_new = fmaxf(m[i], mx[i]);   // finite: nk >= 1
        corr[i] = exp2f(m[i] - m_new);            // 0 at the first step
        m[i] = m_new;
      }
      exp_rows<KPT>(s, m, sum);
#pragma unroll
      for (int i = 0; i < 8; ++i) l[i] = l[i] * corr[i] + sum[i];
      store_p<T, KPT, L::LDP>(Ps, s, r, c);
      if (c == 0)
#pragma unroll
        for (int i = 0; i < 8; ++i) rowc[8 * r + i] = corr[i];
      __syncthreads();
#pragma unroll
      for (int i = 0; i < RPT; ++i) {
        const float f = rowc[ro * RPT + i];
#pragma unroll
        for (int e = 0; e < 4; ++e) acc[i][e] *= f;
      }
      pv<RPT, L::LDP, L::LDQ>(acc, Ps, Vt, ro, co, nk);
      __syncthreads();   // before the next step rewrites P and the buffers
    }
    if (c == 0)
#pragma unroll
      for (int i = 0; i < 8; ++i) rowl[8 * r + i] = l[i];
    __syncthreads();
  }

  const int d = 4 * co;
  if (d >= D) return;
#pragma unroll
  for (int i = 0; i < RPT; ++i) {
    const int row = ro * RPT + i;
    const int qi = q0 + row;
    if (qi >= Lq) continue;
    const float inv = 1.f / rowl[row];
    T* o = out + b * st.o[0] + h * st.o[1] + qi * st.o[2] + d;
    if constexpr (sizeof(T) == 4) {
      if (vec) {
        *reinterpret_cast<float4*>(o) = make_float4(
            acc[i][0] * inv, acc[i][1] * inv, acc[i][2] * inv, acc[i][3] * inv);
        continue;
      }
    }
#pragma unroll
    for (int e = 0; e < 4; ++e)
      if (d + e < D) o[e] = from_f32<T>(acc[i][e] * inv);
  }
}

// D > 128: the head dim in 128-wide chunks. Grid z picks the 128-dim chunk
// of the output a block writes. Over 64-key steps with online softmax, the
// block sums each step's scores over every chunk of q and k (staged one
// chunk at a time, Q re-read from L2 each step), then adds P times its
// chunk of v. Every block of a (b, h, query tile) sums the same products in
// the same order, so the blocks' softmax weights agree bit for bit. Q, K
// and V tiles of 64 x 128 and P over Q: 100 KB of shared memory, two
// blocks an SM.
constexpr int WIDE_DT = 128;
constexpr int WIDE_BK = 64;
constexpr int WIDE_LD = WIDE_DT + 4;
constexpr int WIDE_LDP = WIDE_BK + 4;
constexpr size_t WIDE_BYTES =
    ((BQ + 2 * WIDE_BK) * WIDE_LD + WIDE_BK + 2 * BQ) * sizeof(float);
static_assert(WIDE_LDP <= WIDE_LD, "P fits over Q");

template <typename T>
__global__ void __launch_bounds__(NT, 2)
flash_attention_wide_kernel(const T* __restrict__ q, const T* __restrict__ k,
                            const T* __restrict__ v,
                            const uint8_t* __restrict__ mask,
                            T* __restrict__ out, Strides st, int H, int Lq,
                            int Lk, int D, float scale_log2, bool vec) {
  constexpr int DT = WIDE_DT, BK = WIDE_BK, LD = WIDE_LD, LDP = WIDE_LDP;
  constexpr int KPT = BK / 16, CG = DT / 4, RPT = BQ * CG / NT;
  extern __shared__ __align__(16) float smem[];
  float* Qs = smem;
  float* Ps = smem;                   // over Q, once the step's scores are in
  float* Ks = Qs + BQ * LD;
  float* Vs = Ks + BK * LD;
  float* valid = Vs + BK * LD;
  float* rowc = valid + BK;
  float* rowl = rowc + BQ;

  const int tid = threadIdx.x;
  const int b = blockIdx.x / H;
  const int h = blockIdx.x % H;
  const int q0 = blockIdx.y * BQ;
  const int oc = blockIdx.z * DT;     // the first output dim of this block
  const int nq = min(BQ, Lq - q0);
  const T* qb = q + b * st.q[0] + h * st.q[1] + q0 * st.q[2];
  const T* kb = k + b * st.k[0] + h * st.k[1];
  const T* vb = v + b * st.v[0] + h * st.v[1] + oc;
  const uint8_t* mb = mask ? mask + b * st.mask : nullptr;
  const int r = tid / 16, c = tid % 16;
  const int ro = tid / CG, co = tid % CG;

  float acc[RPT][4];
#pragma unroll
  for (int i = 0; i < RPT; ++i)
#pragma unroll
    for (int e = 0; e < 4; ++e) acc[i][e] = 0.f;
  float s[8][KPT], m[8], l[8];
#pragma unroll
  for (int i = 0; i < 8; ++i) {
    m[i] = -INFINITY;
    l[i] = 0.f;
  }
  for (int k0 = 0; k0 < Lk; k0 += BK) {
    const int nk = min(BK, Lk - k0);
    stage<BK, DT, LD>(Vs, vb + k0 * st.v[2], st.v[2], nk, min(DT, D - oc),
                      vec);
    cp_async_commit();
    stage_valid<BK>(valid, mb ? mb + k0 : nullptr, nk);
    zero_scores<KPT>(s);
    for (int c0 = 0; c0 < D; c0 += DT) {
      stage<BQ, DT, LD>(Qs, qb + c0, st.q[2], nq, min(DT, D - c0), vec);
      stage<BK, DT, LD>(Ks, kb + k0 * st.k[2] + c0, st.k[2], nk,
                        min(DT, D - c0), vec);
      cp_async_commit();
      cp_async_wait<0>();
      __syncthreads();
      qk_add<DT, KPT, LD>(s, Qs, Ks, r, c);
      __syncthreads();                // before Q and K are restaged
    }
    float mx[8], sum[8], corr[8];
    mask_scale<KPT>(s, mx, valid, nk, c, scale_log2);
#pragma unroll
    for (int i = 0; i < 8; ++i) {
      const float m_new = fmaxf(m[i], mx[i]);   // finite: nk >= 1
      corr[i] = exp2f(m[i] - m_new);            // 0 at the first step
      m[i] = m_new;
    }
    exp_rows<KPT>(s, m, sum);
#pragma unroll
    for (int i = 0; i < 8; ++i) l[i] = l[i] * corr[i] + sum[i];
    store_p<T, KPT, LDP>(Ps, s, r, c);
    if (c == 0)
#pragma unroll
      for (int i = 0; i < 8; ++i) rowc[8 * r + i] = corr[i];
    __syncthreads();
#pragma unroll
    for (int i = 0; i < RPT; ++i) {
      const float f = rowc[ro * RPT + i];
#pragma unroll
      for (int e = 0; e < 4; ++e) acc[i][e] *= f;
    }
    pv<RPT, LDP, LD>(acc, Ps, Vs, ro, co, nk);
    __syncthreads();   // before the next step rewrites P, V and the mask
  }
  if (c == 0)
#pragma unroll
    for (int i = 0; i < 8; ++i) rowl[8 * r + i] = l[i];
  __syncthreads();

  const int d = oc + 4 * co;
  if (d >= D) return;
#pragma unroll
  for (int i = 0; i < RPT; ++i) {
    const int row = ro * RPT + i;
    const int qi = q0 + row;
    if (qi >= Lq) continue;
    const float inv = 1.f / rowl[row];
    T* o = out + b * st.o[0] + h * st.o[1] + qi * st.o[2] + d;
    if constexpr (sizeof(T) == 4) {
      if (vec) {
        *reinterpret_cast<float4*>(o) = make_float4(
            acc[i][0] * inv, acc[i][1] * inv, acc[i][2] * inv, acc[i][3] * inv);
        continue;
      }
    }
#pragma unroll
    for (int e = 0; e < 4; ++e)
      if (d + e < D) o[e] = from_f32<T>(acc[i][e] * inv);
  }
}

template <typename T>
cudaError_t launch_wide(const void* q, const void* k, const void* v,
                        const uint8_t* mask, void* out, const Strides& st,
                        int B, int H, int Lq, int Lk, int D, bool vec,
                        cudaStream_t stream) {
  const int64_t bh = (int64_t)B * H;
  const int q_tiles = (Lq + BQ - 1) / BQ;
  const int chunks = (D + WIDE_DT - 1) / WIDE_DT;
  if (bh > 0x7fffffffLL || q_tiles > 65535 || chunks > 65535)
    return cudaErrorInvalidConfiguration;
  auto kernel = flash_attention_wide_kernel<T>;
  static bool sized = false;
  if (!sized) {
    const cudaError_t e = cudaFuncSetAttribute(
        kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)WIDE_BYTES);
    if (e != cudaSuccess) return e;
    sized = true;
  }
  dim3 grid((unsigned)bh, (unsigned)q_tiles, (unsigned)chunks);
  kernel<<<grid, NT, WIDE_BYTES, stream>>>(
      static_cast<const T*>(q), static_cast<const T*>(k),
      static_cast<const T*>(v), mask, static_cast<T*>(out), st, H, Lq, Lk, D,
      LOG2E / sqrtf((float)D), vec);
  return cudaGetLastError();
}

template <int DT, int BK, bool ONLINE, typename T>
cudaError_t launch(const void* q, const void* k, const void* v,
                   const uint8_t* mask, void* out, const Strides& st, int B,
                   int H, int Lq, int Lk, int D, bool vec,
                   cudaStream_t stream) {
  using L = Layout<DT, BK, ONLINE>;
  const int64_t bh = (int64_t)B * H;
  const int q_tiles = (Lq + BQ - 1) / BQ;
  if (bh > 0x7fffffffLL || q_tiles > 65535) return cudaErrorInvalidConfiguration;
  auto kernel = flash_attention_kernel<DT, BK, ONLINE, T>;
  static bool sized = false;   // the dynamic shared memory limit, once
  if (!sized) {
    const cudaError_t e = cudaFuncSetAttribute(
        kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)L::BYTES);
    if (e != cudaSuccess) return e;
    sized = true;
  }
  dim3 grid((unsigned)bh, (unsigned)q_tiles);
  kernel<<<grid, NT, L::BYTES, stream>>>(
      static_cast<const T*>(q), static_cast<const T*>(k),
      static_cast<const T*>(v), mask, static_cast<T*>(out), st, H, Lq, Lk, D,
      LOG2E / sqrtf((float)D), vec);
  return cudaGetLastError();
}

template <int DT, typename T>
cudaError_t by_keys(const void* q, const void* k, const void* v,
                    const uint8_t* mask, void* out, const Strides& st, int B,
                    int H, int Lq, int Lk, int D, bool vec, cudaStream_t s) {
  if (Lk <= 64)
    return launch<DT, 64, false, T>(q, k, v, mask, out, st, B, H, Lq, Lk, D, vec, s);
  if (Lk <= 128)
    return launch<DT, 128, false, T>(q, k, v, mask, out, st, B, H, Lq, Lk, D, vec, s);
  return launch<DT, 64, true, T>(q, k, v, mask, out, st, B, H, Lq, Lk, D, vec, s);
}

template <typename T>
cudaError_t dispatch(const void* q, const void* k, const void* v,
                     const uint8_t* mask, void* out, const Strides& st, int B,
                     int H, int Lq, int Lk, int D, bool vec, cudaStream_t s) {
  // head dims up to 32 share one bucket (zero-padded): fewer kernels to build
  if (D <= 32) return by_keys<32, T>(q, k, v, mask, out, st, B, H, Lq, Lk, D, vec, s);
  if (D <= 64) return by_keys<64, T>(q, k, v, mask, out, st, B, H, Lq, Lk, D, vec, s);
  if (D <= 128) return by_keys<128, T>(q, k, v, mask, out, st, B, H, Lq, Lk, D, vec, s);
  return launch_wide<T>(q, k, v, mask, out, st, B, H, Lq, Lk, D, vec, s);
}

}  // namespace

// q [B, H, Lq, D], k and v [B, H, Lk, D], out [B, H, Lq, D], all f32
// (dtype 0) or all bf16 (1), read and written through `strides`: 13 int64
// values, the batch, head and row strides of q, k, v and out in elements
// (each last dim contiguous), then the batch stride of `mask`, a [B, Lk]
// bool key mask (1 = valid) or null (every key valid). D >= 1 (above 128
// the head dim runs in 128-wide chunks), Lk >= 1. Rows are copied 16 bytes
// at a time when every f32 operand's base is 16-byte aligned and D and
// every stride are multiples of 4. Returns a cudaError_t.
extern "C" int rf_flash_attention(const void* q, const void* k, const void* v,
                                  const uint8_t* mask, void* out, int dtype,
                                  const int64_t* strides, int B, int H, int Lq,
                                  int Lk, int D, void* stream) {
  if (D < 1 || Lk < 1 || B < 0 || H < 0 || Lq < 0)
    return (int)cudaErrorInvalidValue;
  if ((int64_t)B * H == 0 || Lq == 0) return (int)cudaSuccess;
  Strides st;
  bool vec = dtype == 0 && D % 4 == 0;
  for (int i = 0; i < 3; ++i) {
    st.q[i] = strides[i];
    st.k[i] = strides[3 + i];
    st.v[i] = strides[6 + i];
    st.o[i] = strides[9 + i];
    vec = vec && st.q[i] % 4 == 0 && st.k[i] % 4 == 0 && st.v[i] % 4 == 0 &&
          st.o[i] % 4 == 0;
  }
  st.mask = strides[12];
  const void* ptrs[4] = {q, k, v, out};
  for (const void* p : ptrs)
    vec = vec && reinterpret_cast<uintptr_t>(p) % 16 == 0;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (dtype == 0)
    return (int)dispatch<float>(q, k, v, mask, out, st, B, H, Lq, Lk, D, vec, s);
  if (dtype == 1)
    return (int)dispatch<__nv_bfloat16>(q, k, v, mask, out, st, B, H, Lq, Lk,
                                        D, vec, s);
  return (int)cudaErrorInvalidValue;
}

extern "C" const char* rf_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}
