// The duplicate-combining stage of the split table update, over every split
// table of a step in one call: for each table t, from its stored-row ids
// ids_t [N_t] (any order, duplicates allowed) and row gradients g_t [N_t, W_t]
// (float32 or bfloat16),
//
//   uid_t [N_t]:       its distinct rows in ascending order, then the
//                      distinct out-of-range ids rows_t + i;
//   summed_t [N_t, W_t] float32: each distinct row's gradients summed in
//                      float32 in batch order, zero rows past the last;
//   valid_t [N_t], n_valid_t (one int32 on the card);
//
// what scatter_add_rows and sparse_adagrad_apply take. An id outside
// [0, rows_t) counts as row rows_t, which those kernels skip.
//
// Replaces: no TPU kernel. The JAX package sorts and segment-sums each
// table in XLA (train/optimizers.py: split_table_update, segment_row_grads);
// the port ran that as some twenty PyTorch operations a table (a radix sort,
// a gather of the gradients, a cast, the compaction, a zero fill and an
// index_add_ by float atomics): launch latency times twenty times the
// number of tables, and atomics whose order changed from run to run.
//
// Bound: bytes, and at the trainer's sizes launch latency. Each id's
// gradient row is read once and each distinct row's sum written once, with
// the zero padding: at bench_recall (87,040 ids, 512-byte bf16 rows, two
// tables) ~45 MB read, ~89 MB written, ~40 us at 3.35 TB/s; at Dcn/Criteo
// (13,312 ids in 23 tables) a few MB, so the launches decide.
//
// Design, one fixed pipeline whatever the tables:
//   1. combine_keys_kernel: one composite key per id, the table's index
//      above the row's bits, and its position in the concatenated ids;
//   2. CUB's radix sort of the (key, position) pairs over the key's bits
//      only (stable: equal keys keep batch order). Each table then occupies
//      its own static range of the sorted order;
//   3. combine_heads_kernel: one warp per chunk of 32 sorted positions (a
//      chunk never spans two tables) counts the run heads in it;
//   4. combine_scan_kernel: one block scans the chunks' counts, per table:
//      each chunk's first run index, each table's n_valid;
//   5. combine_sum_kernel: one warp per chunk sums its positions' gradient
//      rows, read in place through the sorted positions (no gathered copy,
//      no cast pass), in float32 in sorted order, and writes each run's
//      partial where the run starts in the chunk to its output row, and the
//      partial of a run carried in from an earlier chunk to the chunk's
//      carry row. The work is split by positions, not by runs: a Zipf hot
//      row's run of 10,000 ids spreads over 300 warps instead of
//      serialising one;
//   6. combine_fixup_kernel: per chunk, the valid flags, the padding's uids
//      and zero rows; and where a run crosses chunks, one block adds its
//      carry rows to its output row in a fixed order (eight warps each sum
//      a contiguous stretch of the chunks in order, then the eight partials
//      in warp order). No float atomics: the same inputs give the same bits.
// The tables' descriptors travel as a kernel parameter (__grid_constant__),
// so nothing is copied from the host and the call captures into a CUDA
// graph; nothing is read back.

#include <cub/block/block_scan.cuh>
#include <cub/device/device_radix_sort.cuh>
#include <cuda_runtime.h>
#include <stdint.h>

#include "row_io.cuh"

namespace {

constexpr int kMaxTables = 64;      // descriptors in one call's parameter
constexpr int kChunk = 32;          // sorted positions a chunk (one warp)
constexpr int kTile = 256;          // columns a warp sums at a time
constexpr int kWarps = 8;           // warps a block (256 threads)
constexpr int kBatch = 4;           // gradient rows in flight a warp
constexpr int kScanThreads = 1024;
constexpr int kScanItems = 4;
constexpr int32_t kCountMask = 0xff;      // heads[c]: the chunk's head count,
constexpr int32_t kFirstHead = 1 << 8;    // and whether its first position is one
constexpr int kBf16 = 1, kVec8 = 2;       // TableDesc::flags
constexpr unsigned kFull = 0xffffffffu;

struct TableDesc {
  const int32_t* ids;
  const void* g;
  int64_t summed_off;   // floats into summed
  int64_t carry_off;    // floats into carry
  int32_t n, off, rows, width, chunk0, flags;
};

struct Tables {
  TableDesc t[kMaxTables];
  int32_t count;
};

// The table whose chunks hold chunk c (chunk0 ascends; every table has one)
__device__ __forceinline__ int table_of(const Tables& d, int64_t c) {
  int t = 0;
  for (int i = 1; i < d.count; ++i)
    if (c >= d.t[i].chunk0) t = i;
  return t;
}

__device__ __forceinline__ int64_t chunks_of(const TableDesc& td) {
  return (td.n + kChunk - 1) / kChunk;
}

template <typename Key>
__global__ void combine_keys_kernel(const __grid_constant__ Tables d,
                                    int64_t n_chunks, int row_bits,
                                    Key* __restrict__ keys,
                                    int32_t* __restrict__ pos) {
  const int64_t c = ((int64_t)blockIdx.x * blockDim.x + threadIdx.x) >> 5;
  const int lane = threadIdx.x & 31;
  if (c >= n_chunks) return;
  const int t = table_of(d, c);
  const TableDesc& td = d.t[t];
  const int64_t p = (c - td.chunk0) * kChunk + lane;
  if (p >= td.n) return;
  int32_t id = __ldg(td.ids + p);
  if (id < 0 || id >= td.rows) id = td.rows;
  const int64_t i = td.off + p;
  keys[i] = ((Key)t << row_bits) | (Key)id;
  pos[i] = (int32_t)i;
}

// Whether sorted position p of table td starts a run (warp-uniform loads)
template <typename Key>
__device__ __forceinline__ Key chunk_key(const TableDesc& td, const Key* keys,
                                         int64_t p0, int lane, int cnt,
                                         bool* head) {
  const int64_t i = td.off + p0 + lane;
  const Key key = lane < cnt ? keys[i] : (Key)0;
  Key prev = __shfl_up_sync(kFull, key, 1);
  if (lane == 0 && p0 > 0) prev = keys[i - 1];
  *head = lane < cnt && ((lane == 0 && p0 == 0) || key != prev);
  return key;
}

template <typename Key>
__global__ void combine_heads_kernel(const __grid_constant__ Tables d,
                                     int64_t n_chunks,
                                     const Key* __restrict__ keys,
                                     int32_t* __restrict__ heads) {
  const int64_t c = ((int64_t)blockIdx.x * blockDim.x + threadIdx.x) >> 5;
  const int lane = threadIdx.x & 31;
  if (c >= n_chunks) return;
  const TableDesc& td = d.t[table_of(d, c)];
  const int64_t p0 = (c - td.chunk0) * kChunk;
  const int cnt = (int)min((int64_t)kChunk, td.n - p0);
  bool head;
  chunk_key<Key>(td, keys, p0, lane, cnt, &head);
  const unsigned m = __ballot_sync(kFull, head);
  if (lane == 0) heads[c] = __popc(m) | ((m & 1u) ? kFirstHead : 0);
}

// One block: base[c] = the runs before chunk c over every table (a table's
// own run index of chunk c's first run is base[c] - base[its chunk0]);
// n_valid[t]
__global__ void __launch_bounds__(kScanThreads)
combine_scan_kernel(const __grid_constant__ Tables d, int64_t n_chunks,
                    const int32_t* __restrict__ heads,
                    int32_t* __restrict__ base,
                    int32_t* __restrict__ n_valid) {
  using Scan = cub::BlockScan<int32_t, kScanThreads>;
  __shared__ typename Scan::TempStorage tmp;
  int32_t carried = 0;
  for (int64_t tile = 0; tile < n_chunks;
       tile += (int64_t)kScanThreads * kScanItems) {
    int32_t v[kScanItems];
#pragma unroll
    for (int k = 0; k < kScanItems; ++k) {
      const int64_t c = tile + (int64_t)threadIdx.x * kScanItems + k;
      v[k] = c < n_chunks ? (heads[c] & kCountMask) : 0;
    }
    int32_t total;
    Scan(tmp).ExclusiveSum(v, v, total);
#pragma unroll
    for (int k = 0; k < kScanItems; ++k) {
      const int64_t c = tile + (int64_t)threadIdx.x * kScanItems + k;
      if (c < n_chunks) base[c] = carried + v[k];
    }
    carried += total;
    __syncthreads();
  }
  const int t = threadIdx.x;
  if (t < d.count)
    n_valid[t] = (t + 1 < d.count ? base[d.t[t + 1].chunk0] : carried) -
                 base[d.t[t].chunk0];
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

template <bool VEC8>
__device__ __forceinline__ void store_tile(float* row, int col0, int width,
                                           int lane, const float* v) {
  if (VEC8) {
    const int c = col0 + lane * 8;
    if (c < width) Elt<float>::store8(row + c, v);
  } else {
#pragma unroll
    for (int k = 0; k < 8; ++k) {
      const int c = col0 + lane + 32 * k;
      if (c < width) row[c] = v[k];
    }
  }
}

// One chunk's sums: m the chunk's head mask, src each lane's sorted
// position's index into the table's rows, r0 the chunk's first run index
template <typename T, bool VEC8>
__device__ __forceinline__ void sum_chunk(const T* __restrict__ g, int width,
                                          int cnt, unsigned m, int32_t src,
                                          int32_t r0, float* __restrict__ out,
                                          float* __restrict__ carry, int lane) {
  for (int col0 = 0; col0 < width; col0 += kTile) {
    float acc[8];
#pragma unroll
    for (int k = 0; k < 8; ++k) acc[k] = 0.f;
    int run = 0;     // the lane where the open run starts in the chunk
    for (int j0 = 0; j0 < cnt; j0 += kBatch) {
      float v[kBatch][8];
#pragma unroll
      for (int q = 0; q < kBatch; ++q) {
        const int32_t s = __shfl_sync(kFull, src, (j0 + q) & 31);
        if (j0 + q < cnt)
          load_tile<T, VEC8>(g + (int64_t)s * width, col0, width, lane, v[q]);
      }
#pragma unroll
      for (int q = 0; q < kBatch; ++q) {
        const int j = j0 + q;
        if (j >= cnt) break;
        if (j > 0 && ((m >> j) & 1u)) {
          const int32_t r = r0 + __popc(m & ((1u << run) - 1u));
          store_tile<VEC8>(((m >> run) & 1u) ? out + (int64_t)r * width : carry,
                           col0, width, lane, acc);
#pragma unroll
          for (int k = 0; k < 8; ++k) acc[k] = 0.f;
          run = j;
        }
#pragma unroll
        for (int k = 0; k < 8; ++k) acc[k] = __fadd_rn(acc[k], v[q][k]);
      }
    }
    const int32_t r = r0 + __popc(m & ((1u << run) - 1u));
    store_tile<VEC8>(((m >> run) & 1u) ? out + (int64_t)r * width : carry, col0,
                     width, lane, acc);
  }
}

template <typename Key>
__global__ void combine_sum_kernel(const __grid_constant__ Tables d,
                                   int64_t n_chunks, int row_bits,
                                   const Key* __restrict__ keys,
                                   const int32_t* __restrict__ pos,
                                   const int32_t* __restrict__ base,
                                   float* __restrict__ summed,
                                   float* __restrict__ carry,
                                   int32_t* __restrict__ uid) {
  const int64_t c = ((int64_t)blockIdx.x * blockDim.x + threadIdx.x) >> 5;
  const int lane = threadIdx.x & 31;
  if (c >= n_chunks) return;
  const TableDesc& td = d.t[table_of(d, c)];
  const int64_t p0 = (c - td.chunk0) * kChunk;
  const int cnt = (int)min((int64_t)kChunk, td.n - p0);
  bool head;
  const Key key = chunk_key<Key>(td, keys, p0, lane, cnt, &head);
  const unsigned m = __ballot_sync(kFull, head);
  const int32_t r0 = base[c] - base[td.chunk0];
  if (head)
    uid[td.off + r0 + __popc(m & ((1u << lane) - 1u))] =
        (int32_t)(key & (((Key)1 << row_bits) - 1));
  // the sorted position's index into the table's own ids and gradients
  const int32_t src = lane < cnt ? pos[td.off + p0 + lane] - td.off : 0;
  float* out = summed + td.summed_off;
  float* car = carry + td.carry_off + (c - td.chunk0) * td.width;
  switch (td.flags) {
    case 0:
      sum_chunk<float, false>(static_cast<const float*>(td.g), td.width, cnt, m,
                              src, r0, out, car, lane);
      break;
    case kVec8:
      sum_chunk<float, true>(static_cast<const float*>(td.g), td.width, cnt, m,
                             src, r0, out, car, lane);
      break;
    case kBf16:
      sum_chunk<__nv_bfloat16, false>(static_cast<const __nv_bfloat16*>(td.g),
                                      td.width, cnt, m, src, r0, out, car, lane);
      break;
    default:
      sum_chunk<__nv_bfloat16, true>(static_cast<const __nv_bfloat16*>(td.g),
                                     td.width, cnt, m, src, r0, out, car, lane);
  }
}

// One block a chunk: valid, the padding's uids and zero rows for output rows
// [p0, p0 + cnt) of its table; then, where the run open at the end of the
// chunk before continues into this one, that run's carries added in order
__global__ void __launch_bounds__(kWarps * 32)
combine_fixup_kernel(const __grid_constant__ Tables d,
                     const int32_t* __restrict__ heads,
                     const int32_t* __restrict__ base,
                     const int32_t* __restrict__ n_valid,
                     float* __restrict__ summed,
                     const float* __restrict__ carry,
                     int32_t* __restrict__ uid, uint8_t* __restrict__ valid) {
  __shared__ float part[kWarps][kTile];
  __shared__ unsigned long long last_part;
  const int64_t c = blockIdx.x;
  const int t = table_of(d, c);
  const TableDesc& td = d.t[t];
  const int width = td.width;
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int64_t p0 = (c - td.chunk0) * kChunk;
  const int64_t p1 = min(p0 + kChunk, (int64_t)td.n);
  const int64_t nv = n_valid[t];
  float* out = summed + td.summed_off;
  for (int64_t r = p0 + threadIdx.x; r < p1; r += blockDim.x) {
    valid[td.off + r] = r < nv;
    if (r >= nv) uid[td.off + r] = (int32_t)(td.rows + r);
  }
  // the padding's zeros bypass L2's keep-set (streaming stores), which
  // holds the sums for kernels 2-3 next
  for (int64_t r = max(p0, nv) + warp; r < p1; r += kWarps) {
    float* row = out + r * width;
    if ((width & 3) == 0) {
      for (int col = lane * 4; col < width; col += 128)
        __stcs(reinterpret_cast<float4*>(row + col),
               make_float4(0.f, 0.f, 0.f, 0.f));
    } else {
      for (int col = lane; col < width; col += 32) __stcs(row + col, 0.f);
    }
  }

  const int32_t h = heads[c];
  if (c == td.chunk0 || (h & kFirstHead) || !(heads[c - 1] & kCountMask))
    return;
  // the run is the last of chunk c - 1; its carries are chunks c .. last:
  // it ends in the first chunk that holds a head, or that the table's last
  // chunk or a chunk whose first position starts a run follows
  const int64_t end = td.chunk0 + chunks_of(td) - 1;
  if (threadIdx.x == 0) last_part = (unsigned long long)end;
  __syncthreads();
  for (int64_t k0 = c; k0 <= end; k0 += blockDim.x) {
    const int64_t k = k0 + threadIdx.x;
    const bool stop = k <= end && ((heads[k] & kCountMask) || k == end ||
                                   (heads[k + 1] & kFirstHead));
    if (stop) atomicMin(&last_part, (unsigned long long)k);
    if (__syncthreads_or(stop)) break;
  }
  const int64_t n_parts = (int64_t)last_part - c + 1;
  const int64_t r =
      base[c - 1] - base[td.chunk0] + (heads[c - 1] & kCountMask) - 1;
  const int64_t lo = c + n_parts * warp / kWarps;
  const int64_t hi = c + n_parts * (warp + 1) / kWarps;
  const float* rows = carry + td.carry_off;      // chunk k's: k - chunk0
  for (int col0 = 0; col0 < width; col0 += kTile) {
    float acc[8];
#pragma unroll
    for (int k = 0; k < 8; ++k) acc[k] = 0.f;
    for (int64_t k0 = lo; k0 < hi; k0 += kBatch) {
      float v[kBatch][8];
#pragma unroll
      for (int q = 0; q < kBatch; ++q)
        if (k0 + q < hi)
          load_tile<float, false>(rows + (k0 + q - td.chunk0) * width, col0,
                                  width, lane, v[q]);
#pragma unroll
      for (int q = 0; q < kBatch; ++q)
        if (k0 + q < hi)
#pragma unroll
          for (int k = 0; k < 8; ++k) acc[k] = __fadd_rn(acc[k], v[q][k]);
    }
#pragma unroll
    for (int k = 0; k < 8; ++k) part[warp][lane + 32 * k] = acc[k];
    __syncthreads();
    const int col = col0 + threadIdx.x;
    if (col < width) {
      float s = out[r * width + col];
#pragma unroll
      for (int w = 0; w < kWarps; ++w) s = __fadd_rn(s, part[w][threadIdx.x]);
      out[r * width + col] = s;
    }
    __syncthreads();
  }
}

template <typename Key>
cudaError_t sort_pairs(void* temp, size_t* temp_bytes, const void* keys_in,
                       void* keys_out, const int32_t* pos_in, int32_t* pos_out,
                       int n, int end_bit, cudaStream_t stream) {
  return cub::DeviceRadixSort::SortPairs(
      temp, *temp_bytes, static_cast<const Key*>(keys_in),
      static_cast<Key*>(keys_out), pos_in, pos_out, n, 0, end_bit, stream);
}

template <typename Key>
cudaError_t run(const Tables& d, int64_t n_total, int64_t n_chunks,
                int row_bits, int end_bit, void* keys_in, void* keys_out,
                int32_t* pos_in, int32_t* pos_out, void* temp,
                size_t temp_bytes, int32_t* heads, int32_t* base,
                int32_t* n_valid, float* summed, float* carry, int32_t* uid,
                uint8_t* valid, cudaStream_t stream) {
  const int threads = kWarps * 32;
  const unsigned warp_blocks = (unsigned)((n_chunks + kWarps - 1) / kWarps);
  cudaError_t err;
  combine_keys_kernel<Key><<<warp_blocks, threads, 0, stream>>>(
      d, n_chunks, row_bits, static_cast<Key*>(keys_in), pos_in);
  if ((err = cudaGetLastError()) != cudaSuccess) return err;
  if ((err = sort_pairs<Key>(temp, &temp_bytes, keys_in, keys_out, pos_in,
                             pos_out, (int)n_total, end_bit, stream)) !=
      cudaSuccess)
    return err;
  const Key* sorted = static_cast<const Key*>(keys_out);
  combine_heads_kernel<Key><<<warp_blocks, threads, 0, stream>>>(
      d, n_chunks, sorted, heads);
  if ((err = cudaGetLastError()) != cudaSuccess) return err;
  combine_scan_kernel<<<1, kScanThreads, 0, stream>>>(d, n_chunks, heads, base,
                                                      n_valid);
  if ((err = cudaGetLastError()) != cudaSuccess) return err;
  combine_sum_kernel<Key><<<warp_blocks, threads, 0, stream>>>(
      d, n_chunks, row_bits, sorted, pos_out, base, summed, carry, uid);
  if ((err = cudaGetLastError()) != cudaSuccess) return err;
  combine_fixup_kernel<<<(unsigned)n_chunks, threads, 0, stream>>>(
      d, heads, base, n_valid, summed, carry, uid, valid);
  return cudaGetLastError();
}

}  // namespace

// Scratch bytes of the radix sort of n pairs (key64: 64-bit keys, else 32)
// over bits [0, end_bit). Returns a cudaError_t.
extern "C" int rf_combine_temp_bytes(int64_t n, int key64, int end_bit,
                                     int64_t* bytes) {
  size_t b = 0;
  cudaError_t err =
      key64 ? sort_pairs<unsigned long long>(nullptr, &b, nullptr, nullptr,
                                             nullptr, nullptr, (int)n, end_bit,
                                             0)
            : sort_pairs<unsigned int>(nullptr, &b, nullptr, nullptr, nullptr,
                                       nullptr, (int)n, end_bit, 0);
  *bytes = (int64_t)b;
  return (int)err;
}

// desc: count x 10 int64 per table, in ops/cuda/row_grad_combine.py's order
// (ids, g, summed_off, carry_off, n, off, rows, width, chunk0, flags);
// keys_in/keys_out: n_total keys of 8 bytes (key64) or 4; pos_in/pos_out:
// n_total int32; temp: the sort's scratch; heads, base: n_chunks int32;
// n_valid: count int32; summed, carry: float32 at the descriptors' offsets;
// uid: n_total int32; valid: n_total bytes. Launches on `stream` and
// returns a cudaError_t; allocates nothing and does not synchronise.
extern "C" int rf_combine_row_grads(const int64_t* desc, int count,
                                    int row_bits, int key64, int end_bit,
                                    int64_t n_total, int64_t n_chunks,
                                    void* keys_in, void* keys_out,
                                    int32_t* pos_in, int32_t* pos_out,
                                    void* temp, int64_t temp_bytes,
                                    int32_t* heads, int32_t* base,
                                    int32_t* n_valid, float* summed,
                                    float* carry, int32_t* uid, uint8_t* valid,
                                    void* stream) {
  if (count < 1 || count > kMaxTables || n_total < 1 || n_total > INT32_MAX)
    return (int)cudaErrorInvalidValue;
  Tables d;
  d.count = count;
  for (int i = 0; i < count; ++i) {
    const int64_t* e = desc + 10 * i;
    TableDesc& td = d.t[i];
    td.ids = reinterpret_cast<const int32_t*>(e[0]);
    td.g = reinterpret_cast<const void*>(e[1]);
    td.summed_off = e[2];
    td.carry_off = e[3];
    td.n = (int32_t)e[4];
    td.off = (int32_t)e[5];
    td.rows = (int32_t)e[6];
    td.width = (int32_t)e[7];
    td.chunk0 = (int32_t)e[8];
    td.flags = (int32_t)e[9];
  }
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  return key64 ? (int)run<unsigned long long>(
                     d, n_total, n_chunks, row_bits, end_bit, keys_in,
                     keys_out, pos_in, pos_out, temp, (size_t)temp_bytes,
                     heads, base, n_valid, summed, carry, uid, valid, s)
               : (int)run<unsigned int>(
                     d, n_total, n_chunks, row_bits, end_bit, keys_in,
                     keys_out, pos_in, pos_out, temp, (size_t)temp_bytes,
                     heads, base, n_valid, summed, carry, uid, valid, s);
}

extern "C" const char* rf_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}
