// The row-sharded lookup of a dim group whose bags are all sum-pooled
// (parallel/sharded_embedding.py:pool_local_bags), run on each rank of the
// mesh axis that row-shards the table. Rank r holds logical rows
// [start, start + rows) of the table; every rank sees the global batch's
// fused ids [n_examples, cols], cut into bags by a descriptor (bag j:
// columns [start_j, start_j + len_j), its ids at or below pad_j masked, as
// pool_sequence(..., ids > 0, Sum) masks a slot's pads):
//
//   gather_owned: out [n_examples * cols, dim] in the table's dtype, each
//     id's row where this rank owns it, zero elsewhere. Each id has one
//     owner, so a reduce-scatter of it (x + 0 = x) gives each rank its own
//     examples' rows exactly, in the table's dtype (half the bytes of
//     float32 rows at bf16, and a reduce-scatter in place of an
//     all-reduce), and the rank pools them as the single table's lookup
//     does, to the same bits.
//   pooled_grad: the transpose of the pooling and the exchange. From the
//     all-gathered pooled gradient g [n_examples, n_bags, dim] float32,
//     each block row that a valid owned id names gets the sum in float32
//     of g[bag] over the ids that name it (each term rounded to the
//     gradient's dtype first, as the unpooled gather's cast to float32
//     rounds each id's gradient), rounded once to the gradient's dtype and
//     written (the caller zero-fills the rest of the block's gradient).
//
// Replaces: no TPU kernel. The JAX package looks up unpooled rows on each
// shard and all-reduces them in float32 (parallel/sharded_embedding.py);
// the port did the same and moved every global id's f32 row through NCCL
// twice a step (7.18 GB each way at DLRM-DCNv2's batch), then
// differentiated the unpooled rows.
//
// Bound: bytes. gather_owned reads the ids and the owned rows and writes
// every id's row (at DLRM-DCNv2's global batch, 65536 x 214 ids of 256-byte
// bf16 rows: 3.6 GB); pooled_grad reads the ids and the pooled gradient
// rows its owned ids name, and writes each touched block row once.
//
// Design.
//   gather_owned_kernel: one thread a 16-byte word of the output (or a
//     smaller word where the row or a pointer is not 16-byte aligned); a
//     foreign id's row is zeros, read from nowhere.
//   pooled_grad, a fixed pipeline (the structure of row_grad_combine.cu,
//   with an index in place of per-id gradient rows):
//     1. pooled_keys_kernel: one key a position: the owned valid id's block
//        row, or `rows` (a sentinel that sorts last) for a foreign or pad
//        id; its payload the position's bag (example x n_bags + bag);
//     2. CUB's radix sort of the (key, bag) pairs over the key's bits
//        (stable: equal keys keep batch order);
//     3. pooled_sum_kernel: one warp a span of kSpan sorted positions sums
//        g[bag] of each position (rounded to the gradient's dtype) in
//        order, in float32. A run that starts and ends in the span is
//        written to its block row, rounded once; the part of a run carried
//        in from an earlier span goes to the span's carry row; a run that
//        starts in the span and goes on past it is left to the fix-up.
//        Sentinel keys end the work: foreign ids cost a sort slot and
//        nothing more;
//     4. pooled_fixup_kernel: one block a span whose last run goes on past
//        it: its eight warps sum, each a contiguous stretch in order, the
//        run's rows in the span and the carry rows of the spans it covers,
//        then the eight partials in warp order, and write the row. A Zipf
//        hot row's run of 500,000 ids is ~2,000 carry rows, spread over
//        eight warps.
//   No float atomics: the same inputs give the same bits. The bag
//   descriptors travel as a kernel parameter (__grid_constant__): nothing
//   is copied from the host, nothing is read back, and the calls capture
//   into a CUDA graph.

#include <cub/device/device_radix_sort.cuh>
#include <cuda_runtime.h>
#include <stdint.h>

#include "row_io.cuh"

namespace {

constexpr int kMaxBags = 256;       // descriptors in one call's parameter
constexpr int kThreads = 256;       // threads a block (8 warps)
constexpr int kWarps = kThreads / 32;
constexpr int kBatch = 4;           // gradient rows in flight a warp
constexpr int kSpan = 256;          // sorted positions a warp sums
constexpr int kTile = 256;          // columns a warp sums at a time
constexpr unsigned kFull = 0xffffffffu;

struct Bags {
  int32_t start[kMaxBags];
  int32_t len[kMaxBags];
  int32_t pad[kMaxBags];
  int32_t count;
};

// x rounded to T's precision (one id's gradient term in the block's dtype)
template <typename T>
__device__ __forceinline__ float as_dtype(float x);
template <>
__device__ __forceinline__ float as_dtype<float>(float x) {
  return x;
}
template <>
__device__ __forceinline__ float as_dtype<__nv_bfloat16>(float x) {
  return __bfloat162float(__float2bfloat16_rn(x));
}

// A word of `Bytes` bytes (16: a 16-byte vector)
template <int Bytes>
struct Word;
template <>
struct Word<16> {
  using T = uint4;
  static __device__ __forceinline__ T zero() { return make_uint4(0, 0, 0, 0); }
};
template <>
struct Word<8> {
  using T = uint2;
  static __device__ __forceinline__ T zero() { return make_uint2(0, 0); }
};
template <>
struct Word<4> {
  using T = uint32_t;
  static __device__ __forceinline__ T zero() { return 0u; }
};
template <>
struct Word<2> {
  using T = uint16_t;
  static __device__ __forceinline__ T zero() { return 0; }
};

template <int Bytes>
__global__ void __launch_bounds__(kThreads)
gather_owned_kernel(const typename Word<Bytes>::T* __restrict__ table,
                    int64_t rows, int64_t start,
                    const int32_t* __restrict__ ids, int64_t n, int words,
                    typename Word<Bytes>::T* __restrict__ out) {
  const int64_t total = n * words;
  for (int64_t t = (int64_t)blockIdx.x * blockDim.x + threadIdx.x; t < total;
       t += (int64_t)gridDim.x * blockDim.x) {
    const int64_t p = t / words;
    const int k = (int)(t - p * words);
    const int64_t local = (int64_t)__ldg(ids + p) - start;
    out[t] = local >= 0 && local < rows ? table[local * words + k]
                                        : Word<Bytes>::zero();
  }
}

__global__ void __launch_bounds__(kThreads)
pooled_keys_kernel(const __grid_constant__ Bags bags, int64_t rows,
                   int64_t start, const int32_t* __restrict__ ids,
                   int64_t n_bags_total, int cols,
                   uint32_t* __restrict__ keys, int32_t* __restrict__ pay) {
  const int64_t w = ((int64_t)blockIdx.x * blockDim.x + threadIdx.x) >> 5;
  const int lane = threadIdx.x & 31;
  if (w >= n_bags_total) return;
  const int64_t b = w / bags.count;
  const int j = (int)(w - b * bags.count);
  const int64_t p0 = b * cols + bags.start[j];
  const int32_t pad = bags.pad[j];
  for (int i = lane; i < bags.len[j]; i += 32) {
    const int32_t id = __ldg(ids + p0 + i);
    const int64_t local = (int64_t)id - start;
    const bool mine = id > pad && local >= 0 && local < rows;
    keys[p0 + i] = mine ? (uint32_t)local : (uint32_t)rows;
    pay[p0 + i] = (int32_t)w;
  }
}

// A lane's 8 elements of a row's column tile: 8 consecutive columns
// (VEC8, 16-byte words) or columns lane + 32 k; 0 past the width
template <typename T, bool VEC8>
__device__ __forceinline__ void load_tile(const T* row, int col0, int width,
                                          int lane, float* v) {
  if (VEC8) {
    const int c = col0 + lane * 8;
    if (c < width) {
      Elt<T>::load8(row + c, v);
    } else {
#pragma unroll
      for (int k = 0; k < 8; ++k) v[k] = 0.f;
    }
  } else {
#pragma unroll
    for (int k = 0; k < 8; ++k) {
      const int c = col0 + lane + 32 * k;
      v[k] = c < width ? Elt<T>::load(row + c) : 0.f;
    }
  }
}

template <typename T, bool VEC8>
__device__ __forceinline__ void store_tile(T* row, int col0, int width,
                                           int lane, const float* v) {
  if (VEC8) {
    const int c = col0 + lane * 8;
    if (c < width) Elt<T>::store8(row + c, v);
  } else {
#pragma unroll
    for (int k = 0; k < 8; ++k) {
      const int c = col0 + lane + 32 * k;
      if (c < width) Elt<T>::store(row + c, v[k]);
    }
  }
}

// A finished segment of span c's sums: the part of a run carried in from an
// earlier span goes to the span's carry row, a whole run to its block row
template <typename T, bool VEC8>
__device__ __forceinline__ void flush(bool carried, uint32_t key, int64_t c,
                                      int col0, int dim, int lane,
                                      const float* acc, float* carry, T* grad) {
  if (carried) {
    store_tile<float, VEC8>(carry + c * dim, col0, dim, lane, acc);
  } else {
    store_tile<T, VEC8>(grad + (int64_t)key * dim, col0, dim, lane, acc);
  }
}

template <typename T, bool VEC8>
__global__ void __launch_bounds__(kThreads)
pooled_sum_kernel(const uint32_t* __restrict__ keys,
                  const int32_t* __restrict__ pay, int64_t n, uint32_t rows,
                  const float* __restrict__ g, int dim,
                  float* __restrict__ carry, T* __restrict__ grad) {
  const int64_t c = ((int64_t)blockIdx.x * blockDim.x + threadIdx.x) >> 5;
  const int lane = threadIdx.x & 31;
  const int64_t p0 = c * kSpan;
  if (p0 >= n) return;
  const uint32_t first = keys[p0];
  if (first == rows) return;        // every later key is the sentinel too
  const bool cont = p0 > 0 && keys[p0 - 1] == first;
  const int64_t p_end = min(p0 + kSpan, n);
  const uint32_t after = p_end < n ? keys[p_end] : rows;
  for (int col0 = 0; col0 < dim; col0 += kTile) {
    float acc[8];
#pragma unroll
    for (int k = 0; k < 8; ++k) acc[k] = 0.f;
    uint32_t seg = first;
    bool seg_cont = cont;
    bool done = false;
    for (int64_t r0 = p0; r0 < p_end && !done; r0 += 32) {
      const int cnt = (int)min((int64_t)32, p_end - r0);
      const uint32_t key = lane < cnt ? keys[r0 + lane] : rows;
      const int32_t src = lane < cnt ? pay[r0 + lane] : 0;
      for (int j0 = 0; j0 < cnt && !done; j0 += kBatch) {
        float v[kBatch][8];
        uint32_t kq[kBatch];
#pragma unroll
        for (int q = 0; q < kBatch; ++q) {
          const int j = j0 + q;
          kq[q] = __shfl_sync(kFull, key, j & 31);
          const int32_t s = __shfl_sync(kFull, src, j & 31);
          if (j < cnt && kq[q] != rows) {
            load_tile<float, VEC8>(g + (int64_t)s * dim, col0, dim, lane,
                                   v[q]);
#pragma unroll
            for (int k = 0; k < 8; ++k) v[q][k] = as_dtype<T>(v[q][k]);
          }
        }
#pragma unroll
        for (int q = 0; q < kBatch; ++q) {
          if (j0 + q >= cnt || kq[q] == rows) {
            done = true;
            break;
          }
          if (kq[q] != seg) {
            flush<T, VEC8>(seg_cont, seg, c, col0, dim, lane, acc, carry, grad);
#pragma unroll
            for (int k = 0; k < 8; ++k) acc[k] = 0.f;
            seg = kq[q];
            seg_cont = false;
          }
#pragma unroll
          for (int k = 0; k < 8; ++k) acc[k] = __fadd_rn(acc[k], v[q][k]);
        }
      }
    }
    // the span's last run: a carried part, or whole, or open past the span
    // (the fix-up of this span writes it)
    if (seg_cont || seg != after)
      flush<T, VEC8>(seg_cont, seg, c, col0, dim, lane, acc, carry, grad);
  }
}

// First position in [lo, hi) whose key exceeds `key` (keys ascend)
__device__ __forceinline__ int64_t upper_bound(const uint32_t* keys,
                                               int64_t lo, int64_t hi,
                                               uint32_t key) {
  while (lo < hi) {
    const int64_t mid = lo + (hi - lo) / 2;
    if (keys[mid] <= key) lo = mid + 1; else hi = mid;
  }
  return lo;
}

// First position in [lo, hi) whose key is not below `key`
__device__ __forceinline__ int64_t lower_bound(const uint32_t* keys,
                                               int64_t lo, int64_t hi,
                                               uint32_t key) {
  while (lo < hi) {
    const int64_t mid = lo + (hi - lo) / 2;
    if (keys[mid] < key) lo = mid + 1; else hi = mid;
  }
  return lo;
}

template <typename T, bool VEC8>
__global__ void __launch_bounds__(kThreads)
pooled_fixup_kernel(const uint32_t* __restrict__ keys,
                    const int32_t* __restrict__ pay, int64_t n, uint32_t rows,
                    const float* __restrict__ g, int dim,
                    const float* __restrict__ carry, T* __restrict__ grad) {
  __shared__ float part[kWarps][kTile];
  __shared__ int64_t range[2];
  const int64_t c = blockIdx.x;
  const int64_t p0 = c * kSpan;
  const int64_t p_end = min(p0 + kSpan, n);
  if (p_end >= n) return;               // no position after the span
  const uint32_t key = keys[p_end - 1];
  if (key == rows || keys[p_end] != key) return;   // its last run ends here
  if (keys[p0] == key && p0 > 0 && keys[p0 - 1] == key)
    return;                             // a run carried through the span
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  if (threadIdx.x == 0) {
    range[0] = lower_bound(keys, p0, p_end, key);        // the run's head
    range[1] = (upper_bound(keys, p_end, n, key) - 1) / kSpan;  // last span
  }
  __syncthreads();
  const int64_t head = range[0], last = range[1];
  // items: the run's positions in this span, then spans c+1 .. last's
  // carry rows
  const int64_t n_head = p_end - head;
  const int64_t total = n_head + (last - c);
  const int64_t lo = total * warp / kWarps, hi = total * (warp + 1) / kWarps;
  T* out = grad + (int64_t)key * dim;
  for (int col0 = 0; col0 < dim; col0 += kTile) {
    float acc[8];
#pragma unroll
    for (int k = 0; k < 8; ++k) acc[k] = 0.f;
    for (int64_t i0 = lo; i0 < hi; i0 += kBatch) {
      float v[kBatch][8];
#pragma unroll
      for (int q = 0; q < kBatch; ++q) {
        const int64_t i = i0 + q;
        if (i < hi && i < n_head) {
          load_tile<float, VEC8>(g + (int64_t)pay[head + i] * dim, col0, dim,
                                 lane, v[q]);
#pragma unroll
          for (int k = 0; k < 8; ++k) v[q][k] = as_dtype<T>(v[q][k]);
        } else if (i < hi) {
          load_tile<float, VEC8>(carry + (c + 1 + i - n_head) * dim, col0,
                                 dim, lane, v[q]);
        }
      }
#pragma unroll
      for (int q = 0; q < kBatch; ++q)
        if (i0 + q < hi)
#pragma unroll
          for (int k = 0; k < 8; ++k) acc[k] = __fadd_rn(acc[k], v[q][k]);
    }
#pragma unroll
    for (int k = 0; k < 8; ++k)
      part[warp][VEC8 ? lane * 8 + k : lane + 32 * k] = acc[k];
    __syncthreads();
    const int col = col0 + threadIdx.x;
    if (col < dim) {
      float s = 0.f;
#pragma unroll
      for (int w = 0; w < kWarps; ++w) s = __fadd_rn(s, part[w][threadIdx.x]);
      Elt<T>::store(out + col, s);
    }
    __syncthreads();
  }
}

Bags read_bags(const int32_t* desc, int count) {
  Bags bags;
  bags.count = count;
  for (int j = 0; j < count; ++j) {
    bags.start[j] = desc[3 * j];
    bags.len[j] = desc[3 * j + 1];
    bags.pad[j] = desc[3 * j + 2];
  }
  return bags;
}

unsigned warp_blocks(int64_t warps) {
  return (unsigned)((warps + kWarps - 1) / kWarps);
}

template <int Bytes>
cudaError_t gather(const void* table, int64_t rows, int64_t start,
                   const int32_t* ids, int64_t n, int row_bytes, void* out,
                   cudaStream_t stream) {
  using W = typename Word<Bytes>::T;
  const int words = row_bytes / Bytes;
  const int64_t need = (n * words + kThreads - 1) / kThreads;
  const int64_t blocks = need < ((int64_t)1 << 20) ? need : (int64_t)1 << 20;
  gather_owned_kernel<Bytes><<<(unsigned)blocks, kThreads, 0, stream>>>(
      static_cast<const W*>(table), rows, start, ids, n, words,
      static_cast<W*>(out));
  return cudaGetLastError();
}

template <typename T, bool VEC8>
cudaError_t sums(const uint32_t* keys, const int32_t* pay, int64_t n,
                 uint32_t rows, const float* g, int dim, float* carry,
                 void* grad, cudaStream_t stream) {
  const int64_t spans = (n + kSpan - 1) / kSpan;
  T* out = static_cast<T*>(grad);
  pooled_sum_kernel<T, VEC8><<<warp_blocks(spans), kThreads, 0, stream>>>(
      keys, pay, n, rows, g, dim, carry, out);
  cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess) return err;
  pooled_fixup_kernel<T, VEC8><<<(unsigned)spans, kThreads, 0, stream>>>(
      keys, pay, n, rows, g, dim, carry, out);
  return cudaGetLastError();
}

cudaError_t sort_pairs(void* temp, size_t* temp_bytes, const uint32_t* keys_in,
                       uint32_t* keys_out, const int32_t* pay_in,
                       int32_t* pay_out, int n, int end_bit,
                       cudaStream_t stream) {
  return cub::DeviceRadixSort::SortPairs(temp, *temp_bytes, keys_in, keys_out,
                                         pay_in, pay_out, n, 0, end_bit,
                                         stream);
}

}  // namespace

// table: this rank's block [rows, row_bytes]; ids: [n] int32 global logical
// ids; word: the copy word in bytes (16, 8, 4 or 2), dividing row_bytes and
// both pointers; out: [n, row_bytes], each owned id's row, zeros for the
// rest. Launches on `stream`; returns a cudaError_t.
extern "C" int rf_gather_owned(const void* table, int64_t rows,
                               int64_t start, const int32_t* ids, int64_t n,
                               int row_bytes, int word, void* out,
                               void* stream) {
  if (n < 1 || row_bytes < 1 || row_bytes % word)
    return (int)cudaErrorInvalidValue;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  switch (word) {
    case 16:
      return (int)gather<16>(table, rows, start, ids, n, row_bytes, out, s);
    case 8:
      return (int)gather<8>(table, rows, start, ids, n, row_bytes, out, s);
    case 4:
      return (int)gather<4>(table, rows, start, ids, n, row_bytes, out, s);
    case 2:
      return (int)gather<2>(table, rows, start, ids, n, row_bytes, out, s);
    default:
      return (int)cudaErrorInvalidValue;
  }
}

// Scratch bytes of the radix sort of n (key, bag) pairs over bits
// [0, end_bit). Returns a cudaError_t.
extern "C" int rf_pooled_grad_temp_bytes(int64_t n, int end_bit,
                                         int64_t* bytes) {
  size_t b = 0;
  cudaError_t err = sort_pairs(nullptr, &b, nullptr, nullptr, nullptr,
                               nullptr, (int)n, end_bit, 0);
  *bytes = (int64_t)b;
  return (int)err;
}

// g: [n_examples, n_bags, dim] float32; ids: [n_examples, cols] int32
// global logical ids; desc: n_bags x 3 int32 on the host (start column,
// length, pad id), the bags tiling the columns; rows, start: the block's
// logical rows and its first; end_bit: the bits of `rows`; grad: the
// block's gradient [rows, dim] (bf16: grad_bf16 = 1, else f32), its
// touched rows written;
// vec8: dim % 8 == 0 and g and grad 16-byte aligned; keys_in/keys_out,
// pay_in/pay_out: n_examples x cols uint32 / int32; temp: the sort's
// scratch; carry: ceil(n_examples x cols / 256) x dim float32. Launches on
// `stream` and returns a cudaError_t; allocates nothing and does not
// synchronise.
extern "C" int rf_pooled_grad(const float* g, const int32_t* ids,
                              int64_t n_examples, int cols,
                              const int32_t* desc, int n_bags, int64_t rows,
                              int dim, int64_t start, int end_bit, void* grad,
                              int grad_bf16, int vec8, uint32_t* keys_in,
                              uint32_t* keys_out, int32_t* pay_in,
                              int32_t* pay_out, void* temp, int64_t temp_bytes,
                              float* carry, void* stream) {
  const int64_t n = n_examples * cols;
  if (n_bags < 1 || n_bags > kMaxBags || dim < 1 || n < 1 || n > INT32_MAX ||
      rows < 1 || rows >= ((int64_t)1 << end_bit) || end_bit > 32)
    return (int)cudaErrorInvalidValue;
  const Bags bags = read_bags(desc, n_bags);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const int64_t total = n_examples * n_bags;
  pooled_keys_kernel<<<warp_blocks(total), kThreads, 0, s>>>(
      bags, rows, start, ids, total, cols, keys_in, pay_in);
  cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess) return (int)err;
  size_t tb = (size_t)temp_bytes;
  if ((err = sort_pairs(temp, &tb, keys_in, keys_out, pay_in, pay_out, (int)n,
                        end_bit, s)) != cudaSuccess)
    return (int)err;
  const uint32_t r = (uint32_t)rows;
  if (grad_bf16)
    return vec8 ? (int)sums<__nv_bfloat16, true>(keys_out, pay_out, n, r, g,
                                                 dim, carry, grad, s)
                : (int)sums<__nv_bfloat16, false>(keys_out, pay_out, n, r, g,
                                                  dim, carry, grad, s);
  return vec8 ? (int)sums<float, true>(keys_out, pay_out, n, r, g, dim, carry,
                                       grad, s)
              : (int)sums<float, false>(keys_out, pay_out, n, r, g, dim, carry,
                                        grad, s);
}

extern "C" const char* rf_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}
