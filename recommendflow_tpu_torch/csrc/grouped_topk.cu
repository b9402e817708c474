// Fused score + group-max scan for exact top-k retrieval:
//   m1[q, g] = max over items i of group g (items g*G .. g*G+G-1) of s(q, i),
//   s(q, i) = q . v_i                 (ip, cos)
//           = 2 q . v_i - |v_i|^2     (l2 surrogate, when sq_norms is given)
//   and s(q, i) = NEG = -1e30 for i >= num_items (padding), before the max.
//
// Replaces: recommendflow_tpu/ops/pallas/grouped_topk.py, grouped_score_max,
// in its three corpus types: f32, bf16 and uint8 (SQ8 codes, :50-56). Its
// output there is transposed ([N/G, Q]) only for a Mosaic reshape limit;
// these kernels write [Q, N/G] directly.
//
// Two kernels, picked by the corpus type:
//
// f32 corpus: plain FP32 SIMT. Bound: operations. 2 * Q * N * D flops: for a
// 4096-query block over a 1,048,576 x 128 corpus that is 1.10 TFLOP, about
// 16 ms at the H100 SXM's 67 TFLOP/s FP32 rate outside the tensor cores; the
// m1 write is 1.07 GB (~0.3 ms). TF32 tensor cores would change its numbers,
// so it stays on the FP32 pipes:
//   * block = 256 threads on a 128-query x 128-item output tile; the grid is
//     1-D with the query tile fastest, so consecutive blocks share one corpus
//     tile and the corpus streams from device memory about once per call;
//   * query and corpus tiles are staged through shared memory in D-chunks of
//     16, stored k-major;
//   * each thread keeps an 8 x 8 f32 accumulator in registers: queries
//     {ty*4+i, 64+ty*4+i} x items {tx*4+j, 64+tx*4+j}, so a thread holds runs
//     of 4 consecutive items and a group of G items spans G/4 neighbouring
//     lanes of one warp;
//   * the epilogue forms the l2 surrogate, masks items >= num_items to NEG,
//     takes the max over the thread's run of 4 and then over the G/4 lanes
//     with warp shuffles; one lane per group writes m1. The [Q, N] score
//     matrix never reaches device memory, which is the point of the kernel.
//
// bf16 and uint8 corpora: bf16 tensor cores (wgmma). The wrapper hands the
// queries over rounded to bf16, as the Pallas function rounds them
// (:84-87); bf16 values and codes <= 255 are exact in bf16, and a product
// of two bf16 values is exact in f32, so only the order (and the tensor
// cores' rounding) of the f32 sums differs from the plain version. Bound:
// operations at the bf16 tensor-core rate, 1.11 ms at the shape above (989
// TFLOP/s), above the bytes (0.36 ms for uint8 codes plus the m1 write).
// What holds an FP32 SIMT loop back on them is the FP32 pipe itself (~34
// TFLOP/s reached) and one-element corpus loads; the design:
//   * a block works on 256 queries (two consumer warpgroups of two 64-row
//     accumulator tiles each; 64 queries, one warpgroup of one tile, when
//     Q <= 128), zero-padded to 64-dim K-blocks and laid out as wgmma's
//     K-major 128-byte swizzle (8 rows of 128 bytes, 16-byte chunk c of row
//     r at chunk c ^ (r % 8)). While the query tile leaves room for a ring
//     of 4 stages (2 at 64 queries), up to D of 256-320 (1280-1536), it
//     stays in shared memory for the block's life; past that, for any D,
//     each ring stage carries its K-block of the query rows beside the
//     items and the producer streams both. Each corpus tile is read from
//     L2 once per 256 queries (at 128 the L2 feed alone came close to
//     bounding the kernel). Blocks are
//     persistent, one per SM, and walk units of (query tile, run of
//     128-item tiles); the units are a multiple of the blocks, so every SM
//     gets the same work, and the blocks that share a run work on its item
//     tiles at the same time, so each corpus tile streams from device
//     memory about once per call. A resident tile's warpgroup loads its
//     own query rows at the start of a unit;
//   * a producer warpgroup keeps a ring of up to 8 stages (one 128-item x
//     64-dim K-block each, 16 KB of bf16) full; each half of it fills every
//     other stage, up to 3 of its stages in flight: 16-byte cp.async copies
//     of bf16 rows straight into the swizzled layout, or of 16 codes into
//     a raw stage that the same thread then widens to bf16 exactly (the
//     byte under the exponent of 2^23, minus 2^23) into the ring; once its
//     own copies have landed a thread fences them for the async proxy and
//     arrives on the stage's `full` mbarrier (rows that a
//     16-byte copy would straddle, D % 8 != 0 for bf16 or D % 16 != 0 for
//     codes, go element by element through registers instead);
//   * each consumer warpgroup waits on `full`, issues wgmma m64n128k16
//     (f32 += bf16 x bf16, A = 64 of its queries, B = the stage, both from
//     shared memory) for each of its accumulator tiles over the K-block,
//     and releases the previous stage on its `empty` mbarrier once that
//     stage's products are done; two accumulator tiles take 128 registers
//     a thread, so the producer warpgroup gives registers up (setmaxnreg:
//     64 for the producer, 216 for the consumers);
//   * the epilogue runs in registers: in wgmma's accumulator layout a thread
//     holds items 8j + 2(lane % 4) + {0, 1} of rows lane / 4 and lane / 4 + 8
//     of its warp's 16, so a group's max is an in-thread max over G/8 item
//     octets followed by xor-shuffles within the lane quad, for every G; the
//     l2 surrogate reads |v|^2 of the thread's items, items >= num_items are
//     masked; a transposing butterfly over the quad (3 shuffles for 4
//     groups) leaves each lane the whole max of its own group, so a quad
//     writes 4 consecutive groups of a row and no lane idles;
//   * D not a multiple of 8 (or unaligned rows) is read element by element
//     and zero-filled; rows past N_pad and queries past Q are zero-filled
//     and never written.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

#include <algorithm>

namespace {

constexpr int BQ = 128;   // queries per block tile
constexpr int BN = 128;   // items per block tile
constexpr int BK = 16;    // D-chunk staged per step
constexpr int PAD = 4;    // keeps rows 16-byte aligned, spreads store banks
constexpr int NT = 256;   // threads per block
constexpr float NEG = -1e30f;

__global__ void __launch_bounds__(NT)
grouped_score_max_kernel(const float* __restrict__ q,
                         const float* __restrict__ v,
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
      Bs[c][r] = (vi < n_pad && kk < d) ? __ldg(v + vi * d + kk) : 0.f;
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

cudaError_t launch_f32(const float* q, const float* v, const float* sqn,
                       float* m1, int nq, int64_t n_pad, int d, int group,
                       int64_t num_items, cudaStream_t stream) {
  const int n_qtiles = (nq + BQ - 1) / BQ;
  const int64_t n_itiles = (n_pad + BN - 1) / BN;
  const int64_t blocks = (int64_t)n_qtiles * n_itiles;
  if (blocks == 0) return cudaSuccess;
  if (blocks > 0x7fffffffLL) return cudaErrorInvalidConfiguration;
  grouped_score_max_kernel<<<(unsigned)blocks, NT, 0, stream>>>(
      q, v, sqn, m1, nq, n_pad, d, group, num_items, n_qtiles);
  return cudaGetLastError();
}

// ---------------------------------------------------------------------------
// bf16 tensor-core form (bf16 and uint8 corpora)

namespace tc {

constexpr int BN = 128;                  // items per tile: wgmma's N
constexpr int KB = 64;                   // dims per K-block: one 128-byte row
constexpr int ROW = KB * 2;              // bytes of one swizzled row
constexpr int STAGE = BN * ROW;          // 16 KB
constexpr int MAX_STAGES = 8;
constexpr int PT = 64;                   // threads of one producer half

__device__ __forceinline__ uint32_t smem_u32(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}
// a shared address, in bytes, of a chunk of a swizzled row-major tile
__device__ __forceinline__ uint32_t swz(uint32_t base, int row, int chunk) {
  return base + row * ROW + ((chunk ^ (row & 7)) << 4);
}
__device__ __forceinline__ void st_shared16(uint32_t addr, uint4 x) {
  asm volatile("st.shared.v4.b32 [%0], {%1, %2, %3, %4};\n" ::"r"(addr),
               "r"(x.x), "r"(x.y), "r"(x.z), "r"(x.w)
               : "memory");
}
__device__ __forceinline__ void mbar_init(uint32_t bar, int count) {
  asm volatile("mbarrier.init.shared::cta.b64 [%0], %1;\n" ::"r"(bar),
               "r"(count)
               : "memory");
}
__device__ __forceinline__ void mbar_arrive(uint32_t bar) {
  asm volatile("mbarrier.arrive.shared::cta.b64 _, [%0];\n" ::"r"(bar)
               : "memory");
}
// wait until the phase of parity `parity` has completed
__device__ __forceinline__ void mbar_wait(uint32_t bar, uint32_t parity) {
  uint32_t done;
  do {
    asm volatile(
        "{\n.reg .pred p;\n"
        "mbarrier.try_wait.parity.shared::cta.b64 p, [%1], %2;\n"
        "selp.u32 %0, 1, 0, p;\n}\n"
        : "=r"(done)
        : "r"(bar), "r"(parity)
        : "memory");
  } while (!done);
}
// generic-proxy stores to shared memory, made visible to wgmma's reads
__device__ __forceinline__ void fence_async_shared() {
  asm volatile("fence.proxy.async.shared::cta;\n" ::: "memory");
}
__device__ __forceinline__ void wgmma_fence() {
  asm volatile("wgmma.fence.sync.aligned;\n" ::: "memory");
}
__device__ __forceinline__ void wgmma_commit() {
  asm volatile("wgmma.commit_group.sync.aligned;\n" ::: "memory");
}
template <int N>
__device__ __forceinline__ void wgmma_wait() {
  asm volatile("wgmma.wait_group.sync.aligned %0;\n" ::"n"(N) : "memory");
}
// shared-memory matrix descriptor of a K-major tile in the 128-byte swizzle:
// start address >> 4, leading offset 16 B (unused by this layout), stride
// 1024 B between 8-row groups, layout type 1 (128-byte swizzle)
__device__ __forceinline__ uint64_t desc(uint32_t addr) {
  return (uint64_t)((addr & 0x3FFFF) >> 4) | ((uint64_t)1 << 16) |
         ((uint64_t)(1024 >> 4) << 32) | ((uint64_t)1 << 62);
}

// d[0..63] (+)= A B^T for one warpgroup: A 64 x 16 and B 128 x 16 bf16 in
// shared memory (descriptors da, db), f32 accumulators in wgmma's layout
__device__ __forceinline__ void wgmma_m64n128k16(float (&d)[64], uint64_t da,
                                                 uint64_t db, int accumulate) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %66, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n128k16.f32.bf16.bf16 {"
      "%0, %1, %2, %3, %4, %5, %6, %7,"
      "%8, %9, %10, %11, %12, %13, %14, %15,"
      "%16, %17, %18, %19, %20, %21, %22, %23,"
      "%24, %25, %26, %27, %28, %29, %30, %31,"
      "%32, %33, %34, %35, %36, %37, %38, %39,"
      "%40, %41, %42, %43, %44, %45, %46, %47,"
      "%48, %49, %50, %51, %52, %53, %54, %55,"
      "%56, %57, %58, %59, %60, %61, %62, %63"
      "}, %64, %65, p, 1, 1, 0, 0;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]),
        "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7]),
        "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]),
        "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]),
        "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]),
        "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]),
        "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]),
        "+f"(d[28]), "+f"(d[29]), "+f"(d[30]), "+f"(d[31]),
        "+f"(d[32]), "+f"(d[33]), "+f"(d[34]), "+f"(d[35]),
        "+f"(d[36]), "+f"(d[37]), "+f"(d[38]), "+f"(d[39]),
        "+f"(d[40]), "+f"(d[41]), "+f"(d[42]), "+f"(d[43]),
        "+f"(d[44]), "+f"(d[45]), "+f"(d[46]), "+f"(d[47]),
        "+f"(d[48]), "+f"(d[49]), "+f"(d[50]), "+f"(d[51]),
        "+f"(d[52]), "+f"(d[53]), "+f"(d[54]), "+f"(d[55]),
        "+f"(d[56]), "+f"(d[57]), "+f"(d[58]), "+f"(d[59]),
        "+f"(d[60]), "+f"(d[61]), "+f"(d[62]), "+f"(d[63])
      : "l"(da), "l"(db), "r"(accumulate));
}

// 8 consecutive values of one row, starting at dim d0, as 8 bf16 (16 bytes);
// zeros past D or for a row that is out of range
__device__ __forceinline__ uint4 chunk8(const __nv_bfloat16* row, int d0,
                                        int D, bool in, bool vec) {
  if (!in || d0 >= D) return make_uint4(0, 0, 0, 0);
  if (vec) return __ldg(reinterpret_cast<const uint4*>(row + d0));
  uint16_t e[8];
#pragma unroll
  for (int i = 0; i < 8; ++i)
    e[i] = d0 + i < D ? __bfloat16_as_ushort(row[d0 + i]) : (uint16_t)0;
  return make_uint4(e[0] | (uint32_t)e[1] << 16, e[2] | (uint32_t)e[3] << 16,
                    e[4] | (uint32_t)e[5] << 16, e[6] | (uint32_t)e[7] << 16);
}
// raw codes: 8 bytes
__device__ __forceinline__ uint2 chunk8(const uint8_t* row, int d0, int D,
                                        bool in, bool vec) {
  if (!in || d0 >= D) return make_uint2(0, 0);
  if (vec) return __ldg(reinterpret_cast<const uint2*>(row + d0));
  uint32_t w[2] = {0, 0};
#pragma unroll
  for (int i = 0; i < 8; ++i)
    if (d0 + i < D) w[i / 4] |= (uint32_t)row[d0 + i] << (8 * (i % 4));
  return make_uint2(w[0], w[1]);
}
__device__ __forceinline__ uint4 to_bf16(uint4 x) { return x; }
// two codes (bytes k and k+1 of w) as a bf16 pair: the byte under the
// exponent of 2^23 is the float 2^23 + code, minus 2^23 the code, exactly
__device__ __forceinline__ uint32_t codes_bf16x2(uint32_t w, int k) {
  const float lo = __uint_as_float(__byte_perm(w, 0x4B000000u, 0x7440 | k)) -
                   8388608.f;
  const float hi =
      __uint_as_float(__byte_perm(w, 0x4B000000u, 0x7440 | (k + 1))) -
      8388608.f;
  const __nv_bfloat162 p = __floats2bfloat162_rn(lo, hi);
  return *reinterpret_cast<const uint32_t*>(&p);
}
__device__ __forceinline__ uint4 to_bf16(uint2 x) {
  return make_uint4(codes_bf16x2(x.x, 0), codes_bf16x2(x.x, 2),
                    codes_bf16x2(x.y, 0), codes_bf16x2(x.y, 2));
}

// 16 bytes; a source size of 0 fills the destination with zeros
__device__ __forceinline__ void cp_async(uint32_t dst, const void* src,
                                         bool in) {
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::"r"(dst),
               "l"(src), "r"(in ? 16 : 0)
               : "memory");
}
__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::: "memory");
}
template <int N>
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(N) : "memory");
}
__device__ __forceinline__ void bar_sync(int id, int threads) {
  asm volatile("bar.sync %0, %1;\n" ::"r"(id), "r"(threads) : "memory");
}
// raw code bytes of a stage when a uint8 corpus is copied by cp.async
template <typename T>
__host__ __device__ constexpr int raw_bytes(bool vec) {
  return sizeof(T) == 1 && vec ? BN * KB : 0;
}

// Four values v[0..3] in each lane of a quad -> lane q holds the max over
// the quad of v[q] (a transposing butterfly: 3 shuffles for 4 maxima)
__device__ __forceinline__ float quad_transpose_max(const float (&v)[4],
                                                    int q) {
  const bool odd = q & 1, upper = q & 2;
  const float r0 = fmaxf(odd ? v[1] : v[0],
                         __shfl_xor_sync(0xffffffffu, odd ? v[0] : v[1], 1));
  const float r1 = fmaxf(odd ? v[3] : v[2],
                         __shfl_xor_sync(0xffffffffu, odd ? v[2] : v[3], 1));
  return fmaxf(upper ? r1 : r0,
               __shfl_xor_sync(0xffffffffu, upper ? r0 : r1, 2));
}

// The group maxima of one 64 x 128 accumulator tile into m1. acc[4j + 2h +
// e] is item 8j + 2(lane % 4) + e of row `row` + 8h (the thread's rows of
// the warp's 16), so every group lies in one lane quad: G = 4 is the item
// pairs of lanes 2p and 2p+1; for G >= 8 the thread folds its G/8 octets,
// then each lane of the quad ends up with the whole max of its own group
// and the quad writes 4 consecutive groups of a row.
template <int G>
__device__ __forceinline__ void store_group_max(const float (&acc)[64],
                                                float* __restrict__ m1,
                                                int64_t n_groups,
                                                int64_t g_tile, int row,
                                                int nq, int lane) {
  const int q = lane % 4;
  auto put = [&](int r, int64_t g, float m) {
    if (r < nq && g < n_groups) m1[(int64_t)r * n_groups + g] = m;
  };
  if constexpr (G == 4) {
#pragma unroll
    for (int j = 0; j < 16; j += 2)
#pragma unroll
      for (int h = 0; h < 2; ++h) {
        float a = fmaxf(acc[4 * j + 2 * h], acc[4 * j + 2 * h + 1]);
        float b = fmaxf(acc[4 * j + 4 + 2 * h], acc[4 * j + 5 + 2 * h]);
        a = fmaxf(a, __shfl_xor_sync(0xffffffffu, a, 1));
        b = fmaxf(b, __shfl_xor_sync(0xffffffffu, b, 1));
        // lane q takes octet j + (q & 1), its group q >> 1
        put(row + 8 * h, g_tile + 2 * (j + (q & 1)) + (q >> 1),
            (q & 1) ? b : a);
      }
  } else {
    constexpr int OCT = G / 8, L = 16 / OCT;   // groups per row of a tile
    float m[2][L];
#pragma unroll
    for (int h = 0; h < 2; ++h)
#pragma unroll
      for (int l = 0; l < L; ++l) {
        float x = -INFINITY;
#pragma unroll
        for (int o = 0; o < OCT; ++o)
          x = fmaxf(x, fmaxf(acc[4 * (l * OCT + o) + 2 * h],
                             acc[4 * (l * OCT + o) + 2 * h + 1]));
        m[h][l] = x;
      }
    if constexpr (L >= 4) {
#pragma unroll
      for (int h = 0; h < 2; ++h)
#pragma unroll
        for (int b = 0; b < L; b += 4) {
          const float v[4] = {m[h][b], m[h][b + 1], m[h][b + 2], m[h][b + 3]};
          put(row + 8 * h, g_tile + b + q, quad_transpose_max(v, q));
        }
    } else {
      // G = 64: two groups a row; the quad takes both rows at once
      const float v[4] = {m[0][0], m[0][1], m[1][0], m[1][1]};
      put(row + 8 * (q >> 1), g_tile + (q & 1), quad_transpose_max(v, q));
    }
  }
}

// W consumer warpgroups of 64 * SUB queries each, then one producer
// warpgroup
template <typename T, int W, int SUB>
__global__ void __launch_bounds__((W + 1) * 128, 1)
grouped_score_max_tc(const __nv_bfloat16* __restrict__ q,
                     const T* __restrict__ v, const float* __restrict__ sqn,
                     float* __restrict__ m1, int nq, int64_t n_pad, int D,
                     int group, int64_t num_items, int n_qtiles,
                     int n_runs, int stages, bool vec, bool stream_q) {
  constexpr int BM = 64 * W * SUB;
  extern __shared__ __align__(16) uint8_t smem_raw[];
  const uint32_t raw = smem_u32(smem_raw);
  const uint32_t base = (raw + 1023) & ~1023u;   // swizzle atoms: 1024 B
  const int nkb = (D + KB - 1) / KB;
  const int raw_stage = raw_bytes<T>(vec);
  // resident: nkb K-blocks of BM query rows, then the ring; streamed: each
  // stage holds an item tile's K-block and after it the same K-block of the
  // BM query rows
  const uint32_t q_tile = base;
  const uint32_t ring = q_tile + (stream_q ? 0 : nkb * BM * ROW);
  const int sstride = STAGE + (stream_q ? BM * ROW : 0);
  const uint32_t codes = ring + stages * sstride;  // raw uint8 stages
  const uint32_t bars = codes + stages * raw_stage;   // full[], empty[]
  auto full = [&](int s) { return bars + 8 * s; };
  auto empty = [&](int s) { return bars + 8 * (stages + s); };

  const int tid = threadIdx.x;
  // work units (query tile, run of item tiles), unit u = run * n_qtiles +
  // query tile; block b takes units b, b + gridDim.x, ...: the blocks of a
  // run work on the same item tiles at the same time
  const int64_t n_itiles = (n_pad + BN - 1) / BN;
  const int64_t per_run = (n_itiles + n_runs - 1) / n_runs;
  const int n_units = n_qtiles * n_runs;
  auto tiles = [&](int u, int64_t& t0, int64_t& t1) {
    t0 = (u / n_qtiles) * per_run;
    t1 = min(n_itiles, t0 + per_run);
    if (t1 < t0) t1 = t0;
  };

  if (tid == 0) {
    for (int s = 0; s < stages; ++s) {
      mbar_init(full(s), PT);   // one producer half fills a stage
      mbar_init(empty(s), W);   // one arrival per consumer warpgroup
    }
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
  }
  __syncthreads();

  if (tid >= W * 128) {
    // ---- producer: the two halves fill alternate steps of the ring; a
    // thread always copies chunk `ch` of rows lt/8 + 8i of a stage. With two
    // accumulator tiles a consumer thread needs more registers than the
    // launch gives: the producer hands most of its own over (64 x 128 +
    // 216 x 256 fit the SM's 65,536).
    if constexpr (SUB == 2)
      asm volatile("setmaxnreg.dec.sync.aligned.u32 64;\n");
    const int pt = tid - W * 128;
    const int half = pt / PT, lt = pt % PT;
    const int ch = lt % 8;
    // the block's steps in order (unit by unit; a step is one K-block of an
    // item tile), this half taking every other one: fn(step, query tile,
    // item tile, K-block)
    auto each_step = [&](auto&& fn) {
      int64_t n = 0;
      for (int u = blockIdx.x; u < n_units; u += gridDim.x) {
        int64_t t0, t1;
        tiles(u, t0, t1);
        for (int64_t j = 0; j < (t1 - t0) * nkb; ++j, ++n)
          if ((n & 1) == half)
            fn(n, u % n_qtiles, t0 + j / nkb, (int)(j % nkb));
      }
    };
    // streamed query rows: chunk ch of the K-block's rows lt/8 + 8i, beside
    // the stage's items
    auto query_rows = [&](int s, int qt, int kb, auto&& put) {
      const uint32_t a = ring + s * sstride + STAGE;
      const int d0 = kb * KB + ch * 8;
#pragma unroll 4
      for (int i = 0; i < BM / 8; ++i) {
        const int r = lt / 8 + 8 * i, qi = qt * BM + r;
        put(swz(a, r, ch), q + (int64_t)qi * D, d0, qi < nq && d0 < D);
      }
    };
    if (!vec) {
      // rows read element by element, through registers
      each_step([&](int64_t n, int qt, int64_t it, int kb) {
        const int s = (int)(n % stages);
        mbar_wait(empty(s), (uint32_t)((n / stages) & 1) ^ 1u);
#pragma unroll 4
        for (int i = 0; i < 16; ++i) {
          const int64_t item = it * BN + lt / 8 + 8 * i;
          st_shared16(swz(ring + s * sstride, lt / 8 + 8 * i, ch),
                      to_bf16(chunk8(v + item * D, kb * KB + ch * 8, D,
                                     item < n_pad, false)));
        }
        if (stream_q)
          query_rows(s, qt, kb, [&](uint32_t dst, const __nv_bfloat16* row,
                                    int d0, bool in) {
            st_shared16(dst, chunk8(row, d0, D, in, false));
          });
        fence_async_shared();
        mbar_arrive(full(s));
      });
    } else {
      // cp.async, up to `depth` steps in flight per half: a step is handed
      // to the consumers once this thread's own copies of it have landed
      // (and, for codes, been widened into the ring by this same thread).
      // bf16: chunk ch of rows lt/8 + 8i; codes: 16 codes (16 bytes, two
      // chunks of the widened row) c16 of rows lt/4 + 16i.
      const int depth = stages >= 6 ? 3 : 1;   // deadlock-free: 2(d-1) < S
      const int c16 = lt % 4;
      auto finish = [&](int64_t n) {
        const int s = (int)(n % stages);
        if (sizeof(T) == 1) {
          const uint8_t* stage_codes =
              smem_raw + (codes - raw) + s * raw_stage;
#pragma unroll
          for (int i0 = 0; i0 < 8; i0 += 4) {   // 4 loads ahead of the stores
            uint4 x[4];
#pragma unroll
            for (int i = 0; i < 4; ++i)
              x[i] = *reinterpret_cast<const uint4*>(
                  stage_codes + (lt / 4 + 16 * (i0 + i)) * KB + c16 * 16);
#pragma unroll
            for (int i = 0; i < 4; ++i) {
              const int r = lt / 4 + 16 * (i0 + i);
              st_shared16(swz(ring + s * sstride, r, 2 * c16),
                          to_bf16(make_uint2(x[i].x, x[i].y)));
              st_shared16(swz(ring + s * sstride, r, 2 * c16 + 1),
                          to_bf16(make_uint2(x[i].z, x[i].w)));
            }
          }
        }
        fence_async_shared();
        mbar_arrive(full(s));
      };
      int64_t oldest = half;
      int pending = 0;
      each_step([&](int64_t n, int qt, int64_t it, int kb) {
        const int s = (int)(n % stages);
        mbar_wait(empty(s), (uint32_t)((n / stages) & 1) ^ 1u);
        if (stream_q)
          query_rows(s, qt, kb, [&](uint32_t dst, const __nv_bfloat16* row,
                                    int d0, bool in) {
            cp_async(dst, in ? row + d0 : q, in);
          });
        if (sizeof(T) == 1) {
          const int d0 = kb * KB + c16 * 16;
#pragma unroll
          for (int i = 0; i < 8; ++i) {
            const int r = lt / 4 + 16 * i;
            const int64_t item = it * BN + r;
            const bool in = item < n_pad && d0 < D;
            cp_async(codes + s * raw_stage + r * KB + c16 * 16,
                     in ? v + item * D + d0 : v, in);
          }
        } else {
          const int d0 = kb * KB + ch * 8;
#pragma unroll 4   // 16 live addresses would not fit the producer's 64
          for (int i = 0; i < 16; ++i) {
            const int r = lt / 8 + 8 * i;
            const int64_t item = it * BN + r;
            const bool in = item < n_pad && d0 < D;
            cp_async(swz(ring + s * sstride, r, ch),
                     in ? v + item * D + d0 : v, in);
          }
        }
        cp_async_commit();
        if (++pending == depth) {
          if (depth == 3) cp_async_wait<2>(); else cp_async_wait<0>();
          finish(oldest);
          oldest += 2;
          --pending;
        }
      });
      cp_async_wait<0>();
      for (; pending > 0; --pending, oldest += 2) finish(oldest);
    }
  } else {
    // ---- consumers: warpgroup w multiplies its 64 * SUB queries (SUB
    // accumulator tiles of 64 rows) with every stage
    if constexpr (SUB == 2)
      asm volatile("setmaxnreg.inc.sync.aligned.u32 216;\n");
    const int w = tid / 128, wt = tid % 128;
    const int warp = wt / 32, lane = tid % 32;
    const uint32_t a_base = q_tile + w * 64 * SUB * ROW;
    const int64_t n_groups = n_pad / group;
    const int r0 = warp * 16 + lane / 4;     // the thread's rows r0, r0 + 8
    float acc[SUB][64];
#pragma unroll
    for (int u = 0; u < SUB; ++u)
#pragma unroll
      for (int i = 0; i < 64; ++i) acc[u][i] = 0.f;
    int64_t n = 0;
    for (int unit = blockIdx.x; unit < n_units; unit += gridDim.x) {
      int64_t t0, t1;
      tiles(unit, t0, t1);
      const int qt = unit % n_qtiles;
      if (!stream_q) {
        // this warpgroup's query rows, once the last unit's products are
        // read
        bar_sync(1 + w, 128);
        for (int e = wt; e < 64 * SUB * nkb * 8; e += 128) {
          const int r = w * 64 * SUB + e / (nkb * 8), c = e % (nkb * 8);
          const int qi = qt * BM + r;
          st_shared16(swz(q_tile + (c / 8) * BM * ROW, r, c % 8),
                      chunk8(q + (int64_t)qi * D, c * 8, D, qi < nq, vec));
        }
        fence_async_shared();
        bar_sync(1 + w, 128);
      }
      for (int64_t it = t0; it < t1; ++it) {
        int prev = 0;
        for (int kb = 0; kb < nkb; ++kb, ++n) {
          const int s = (int)(n % stages);
          mbar_wait(full(s), (uint32_t)((n / stages) & 1));
          wgmma_fence();
          const uint32_t b = ring + s * sstride;
          const uint32_t a = stream_q ? b + STAGE + w * 64 * SUB * ROW
                                    : a_base + kb * BM * ROW;
          // the whole K-block: dims past D are zeros on both sides
#pragma unroll
          for (int kk = 0; kk < 4; ++kk)
#pragma unroll
            for (int u = 0; u < SUB; ++u)
              wgmma_m64n128k16(acc[u], desc(a + u * 64 * ROW + 32 * kk),
                               desc(b + 32 * kk), kb > 0 || kk > 0);
          wgmma_commit();
          if (kb > 0) {
            wgmma_wait<1>();               // the previous stage is read
            if (wt == 0) mbar_arrive(empty(prev));
          }
          prev = s;
        }
        wgmma_wait<0>();
        if (wt == 0) mbar_arrive(empty(prev));

        // epilogue: acc[u][4j + 2h + e] is item 8j + 2(lane % 4) + e of row
        // 64u + r0 + 8h
        const int64_t item0 = it * BN + 2 * (lane % 4);
        const int64_t g_tile = it * BN / group;
#pragma unroll
        for (int u = 0; u < SUB; ++u) {
          if (sqn != nullptr) {
#pragma unroll
            for (int j = 0; j < 16; ++j)
#pragma unroll
              for (int e = 0; e < 2; ++e) {
                const int64_t item = item0 + 8 * j + e;
                const float sq = item < n_pad ? __ldg(sqn + item) : 0.f;
                acc[u][4 * j + e] = 2.f * acc[u][4 * j + e] - sq;
                acc[u][4 * j + 2 + e] = 2.f * acc[u][4 * j + 2 + e] - sq;
              }
          }
          if (it * BN + BN > num_items) {
#pragma unroll
            for (int j = 0; j < 16; ++j)
#pragma unroll
              for (int e = 0; e < 2; ++e)
                if (item0 + 8 * j + e >= num_items) {
                  acc[u][4 * j + e] = NEG;
                  acc[u][4 * j + 2 + e] = NEG;
                }
          }
          const int row = qt * BM + (w * SUB + u) * 64 + r0;
          const auto& a = acc[u];
          const int64_t ng = n_groups, gt = g_tile;
          switch (group) {
            case 4: store_group_max<4>(a, m1, ng, gt, row, nq, lane); break;
            case 8: store_group_max<8>(a, m1, ng, gt, row, nq, lane); break;
            case 16: store_group_max<16>(a, m1, ng, gt, row, nq, lane); break;
            case 32: store_group_max<32>(a, m1, ng, gt, row, nq, lane); break;
            default: store_group_max<64>(a, m1, ng, gt, row, nq, lane);
          }
        }
      }
    }
  }
}

int sm_count() {
  static int n = 0;
  if (n == 0) {
    int dev = 0;
    cudaGetDevice(&dev);
    cudaDeviceGetAttribute(&n, cudaDevAttrMultiProcessorCount, dev);
  }
  return n;
}

template <typename T, int W, int SUB>
cudaError_t launch_w(const __nv_bfloat16* q, const T* v, const float* sqn,
                     float* m1, int nq, int64_t n_pad, int d, int group,
                     int64_t num_items, int stages, size_t bytes, bool vec,
                     bool streamed, cudaStream_t stream) {
  auto kernel = grouped_score_max_tc<T, W, SUB>;
  static bool sized = false;   // the dynamic shared memory limit, once
  if (!sized) {
    int dev = 0, optin = 0;
    cudaGetDevice(&dev);
    cudaDeviceGetAttribute(&optin, cudaDevAttrMaxSharedMemoryPerBlockOptin,
                           dev);
    const cudaError_t e = cudaFuncSetAttribute(
        kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, optin);
    if (e != cudaSuccess) return e;
    sized = true;
  }
  constexpr int BM = 64 * W * SUB;
  const int n_qtiles = (nq + BM - 1) / BM;
  const int64_t n_itiles = (n_pad + BN - 1) / BN;
  // one block per SM; runs of item tiles such that the (query tile, run)
  // units are a multiple of the blocks (lcm(blocks, n_qtiles) units), so
  // every SM gets the same work
  const int sms = sm_count();
  int g = sms, r = n_qtiles;
  while (r != 0) { const int t = g % r; g = r; r = t; }   // gcd
  const int64_t runs = std::min<int64_t>(n_itiles, sms / g);
  const int64_t units = (int64_t)n_qtiles * runs;
  if (units > 0x7fffffffLL) return cudaErrorInvalidConfiguration;
  const int blocks = (int)std::min<int64_t>(sms, units);
  kernel<<<blocks, (W + 1) * 128, bytes, stream>>>(
      q, v, sqn, m1, nq, n_pad, d, group, num_items, n_qtiles, (int)runs,
      stages, vec, streamed);
  return cudaGetLastError();
}

template <typename T>
cudaError_t launch_tc(const __nv_bfloat16* q, const void* vecs,
                      const float* sqn, float* m1, int nq, int64_t n_pad,
                      int d, int group, int64_t num_items,
                      cudaStream_t stream) {
  if (nq == 0 || n_pad == 0) return cudaSuccess;
  int dev = 0, optin = 0;
  cudaGetDevice(&dev);
  cudaDeviceGetAttribute(&optin, cudaDevAttrMaxSharedMemoryPerBlockOptin,
                         dev);
  const T* v = static_cast<const T*>(vecs);
  const size_t nkb = (d + KB - 1) / KB;
  // 16-byte copies: 8 bf16 values or 16 codes never straddle D
  const bool vec = d % (16 / sizeof(T)) == 0 && d % 8 == 0 &&
                   reinterpret_cast<uintptr_t>(q) % 16 == 0 &&
                   reinterpret_cast<uintptr_t>(v) % 16 == 0;
  // 256 queries a block (two warpgroups of two 64-row tiles) halve the
  // corpus reads of 64; Q <= 128 takes 64. The query tile stays resident
  // while it leaves room for a ring of 4 stages (2 at 64 queries): D up to
  // 256-320 at 256 queries, 1280-1536 at 64; past that each stage carries
  // its K-block of the query rows beside the items, for any D.
  const bool big = nq > 128;
  const size_t bm = big ? 256 : 64;
  const size_t fixed = 1024 + 16 * MAX_STAGES;   // alignment slack, barriers
  size_t q_bytes = nkb * bm * ROW;               // the resident query tile
  size_t per_stage = STAGE + raw_bytes<T>(vec);
  bool streamed = fixed + q_bytes + (big ? 4 : 2) * per_stage > (size_t)optin;
  if (streamed) {
    q_bytes = 0;
    per_stage += bm * ROW;
  }
  const int stages = (int)std::min<size_t>(
      MAX_STAGES, (optin - fixed - q_bytes) / per_stage);
  const size_t bytes = fixed + q_bytes + stages * per_stage;
  if (big)
    return launch_w<T, 2, 2>(q, v, sqn, m1, nq, n_pad, d, group, num_items,
                             stages, bytes, vec, streamed, stream);
  return launch_w<T, 1, 1>(q, v, sqn, m1, nq, n_pad, d, group, num_items,
                           stages, bytes, vec, streamed, stream);
}

}  // namespace tc
}  // namespace

// queries [nq, d]: f32 for an f32 corpus (vec_dtype 0), bf16 for a bf16 (1)
// or uint8 (2) corpus; vecs [n_pad, d]; sq_norms [n_pad] f32 or null;
// m1 [nq, n_pad / group] f32. group must be 4, 8, 16, 32 or 64 and divide
// n_pad. Returns a cudaError_t.
extern "C" int rf_grouped_score_max(const void* queries, const void* vecs,
                                    int vec_dtype, const float* sq_norms,
                                    float* m1, int nq, int64_t n_pad, int d,
                                    int group, int64_t num_items,
                                    void* stream) {
  if (group != 4 && group != 8 && group != 16 && group != 32 && group != 64)
    return (int)cudaErrorInvalidValue;
  if (n_pad % group != 0 || d < 1) return (int)cudaErrorInvalidValue;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const auto* qb = static_cast<const __nv_bfloat16*>(queries);
  if (vec_dtype == 0)
    return (int)launch_f32(static_cast<const float*>(queries),
                           static_cast<const float*>(vecs), sq_norms, m1, nq,
                           n_pad, d, group, num_items, s);
  if (vec_dtype == 1)
    return (int)tc::launch_tc<__nv_bfloat16>(qb, vecs, sq_norms, m1, nq, n_pad,
                                             d, group, num_items, s);
  if (vec_dtype == 2)
    return (int)tc::launch_tc<uint8_t>(qb, vecs, sq_norms, m1, nq, n_pad, d,
                                       group, num_items, s);
  return (int)cudaErrorInvalidValue;
}

extern "C" const char* rf_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}
