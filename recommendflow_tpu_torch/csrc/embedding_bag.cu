// Row gather and row scatter-add for the stacked embedding tables.
//
// gather_rows: out[n, :] = table[ids[n], :].
//
// Replaces: recommendflow_tpu/ops/pallas/embedding_bag.py, gather_rows
// (the Pallas DMA-pipelined row gather), and the XLA take under
// ops/embedding.py:gather_group that the JAX package runs on its main path.
//
// Bound: bytes. The kernel does no arithmetic; it reads N row ids, the rows
// they name and writes N rows. At the bench_ranking dim-32 bf16 group
// (106,496 ids a batch of 2048, 64-byte rows, ~106k of them unique) that is
// 6.8 MB of rows read + 6.8 MB written + 0.43 MB of ids, 4.2 us at the H100
// SXM's 3.35 TB/s; at the bench_recall dim-64 group (87,040 ids, 128-byte
// rows) 6.4 us; the trainer's split gather of 512-byte stored rows at
// bench_ranking 33 us.
//
// Design: the kernel copies bytes and knows nothing of the element type, so
// any dtype is bit-identical to the plain gather. A row is split into
// `unit`-byte words (the largest of 16, 8, 4, 2, 1 that divides the row and
// both base pointers); one thread moves one word, so a 64-byte row is an
// eighth of a warp and neighbouring threads touch neighbouring addresses of
// the same row. A grid-stride loop over at most 64 blocks of 256 an SM (the
// SM count read from the device). Row ids are read through the read-only
// cache; all offsets are 64-bit (the bench_ranking table is 2.5 GB).
//
// Warp-owned runs of 32 ids (one id load a lane, handed on by __shfl_sync,
// every row load of a run in flight, no divide, one resident wave, L1-
// bypassing loads and streaming stores) and Hopper's bulk copies were
// measured against this loop on the H100 and were not faster beyond the
// spread of single calls (PERF.md, section 6): the time is a launch, two
// dependent memory round trips (the id, then the row) and the DRAM's rate
// for scattered 64-512-byte rows, not the copy loop.
//
// Every id is checked against the table's rows on the card: an id outside
// [0, rows) stops the kernel with a device-side assert before its row is
// read (as PyTorch's own index kernels do), so an unchecked launch never
// reads past the table. The wrapper raises IndexError on the host first on
// a direct call; the model paths check each batch's ids on the host before
// they are copied to the card and launch without the host check.
//
// The TPU kernel's bf16 byte-view workaround (a Mosaic DMA limit) and its
// padded tail (ids past N re-read row 0) have no counterpart here: the grid
// covers exactly N * row_bytes / unit words.

#undef NDEBUG
#include <assert.h>
#include <cuda_runtime.h>
#include <stdint.h>

#include <algorithm>

#include "row_io.cuh"

namespace {

constexpr int kMaxDevices = 64;
constexpr int kThreads = 256;
constexpr int kBlocksPerSm = 64;

// The current device's SM count (cached per device).
cudaError_t device_sms(int* sms) {
  static int cache[kMaxDevices] = {};
  int dev = 0;
  cudaError_t e = cudaGetDevice(&dev);
  if (e != cudaSuccess) return e;
  if (dev >= kMaxDevices) return cudaErrorInvalidDevice;
  if (cache[dev] == 0) {
    e = cudaDeviceGetAttribute(&cache[dev], cudaDevAttrMultiProcessorCount,
                               dev);
    if (e != cudaSuccess) return e;
  }
  *sms = cache[dev];
  return cudaSuccess;
}

template <typename W>
__global__ void gather_rows_kernel(const W* __restrict__ table,
                                   const int32_t* __restrict__ ids,
                                   W* __restrict__ out, int64_t n_words,
                                   int64_t words_per_row, int64_t rows) {
  const int64_t stride = (int64_t)gridDim.x * blockDim.x;
  for (int64_t i = (int64_t)blockIdx.x * blockDim.x + threadIdx.x;
       i < n_words; i += stride) {
    const int64_t row = i / words_per_row;
    const int64_t w = i - row * words_per_row;
    const int64_t src = (int64_t)__ldg(ids + row);
    if (src < 0 || src >= rows) {
      assert(!"gather_rows: id outside [0, rows) of the table");
    }
    out[i] = __ldg(table + src * words_per_row + w);
  }
}

template <typename W>
cudaError_t launch(const void* table, const int32_t* ids, void* out,
                   int64_t n, int64_t row_bytes, int64_t rows,
                   cudaStream_t stream) {
  int sms = 0;
  const cudaError_t e = device_sms(&sms);
  if (e != cudaSuccess) return e;
  const int64_t words_per_row = row_bytes / (int64_t)sizeof(W);
  const int64_t n_words = n * words_per_row;
  const int64_t blocks = std::min<int64_t>(
      (int64_t)sms * kBlocksPerSm, (n_words + kThreads - 1) / kThreads);
  gather_rows_kernel<W><<<(unsigned)blocks, kThreads, 0, stream>>>(
      static_cast<const W*>(table), ids, static_cast<W*>(out), n_words,
      words_per_row, rows);
  return cudaGetLastError();
}

// ---------------------------------------------------------------------------
// scatter_add_rows: table[ids[n], :] += grads[n, :] for n < *n_valid.
//
// Replaces: recommendflow_tpu/ops/pallas/embedding_bag.py, scatter_add_rows
// (the Pallas DMA read-modify-write scatter of take_rows' backward), and the
// sorted XLA scatter-add of train/optimizers.py:split_table_update's "dense"
// strategy.
//
// Bound: bytes. Each valid id reads its f32 gradient row and its table row
// and writes the table row back; for the bench_recall dim-64 bf16 table
// (512-byte stored rows, ~77k unique rows a batch) that is ~1.5 KB a row,
// ~40 us at 3.35 TB/s.
//
// Design: the ids are unique (the caller sums duplicates first), so rows
// never collide and no atomics are needed: the result is bit-reproducible.
// One warp owns one row; a lane moves 8 elements at a time (a 16-byte word
// of a bf16 row, two of an f32 row; the f32 gradient in two 16-byte words),
// adds in f32 and rounds once to the table's type. n_valid is read from
// device memory, so the caller never waits for the unique count: warps at
// or past it return at once, and ids outside [0, rows) are dropped (the
// caller pads with such ids), as a JAX scatter with mode="drop" does.

template <typename T, bool VEC8>
__global__ void scatter_add_rows_kernel(const int32_t* __restrict__ ids,
                                        const float* __restrict__ grads,
                                        T* __restrict__ table,
                                        const int32_t* __restrict__ n_valid,
                                        int64_t n, int64_t rows,
                                        int64_t width) {
  const int64_t i = ((int64_t)blockIdx.x * blockDim.x + threadIdx.x) >> 5;
  const int lane = threadIdx.x & 31;
  if (i >= n || i >= (int64_t)__ldg(n_valid)) return;
  const int64_t row = (int64_t)__ldg(ids + i);
  if (row < 0 || row >= rows) return;
  T* dst = table + row * width;
  const float* src = grads + i * width;
  if (VEC8) {
    for (int64_t c = (int64_t)lane * 8; c < width; c += 32 * 8) {
      float t[8], g[8];
      Elt<T>::load8(dst + c, t);
      Elt<float>::load8(src + c, g);
#pragma unroll
      for (int k = 0; k < 8; ++k) t[k] = __fadd_rn(t[k], g[k]);
      Elt<T>::store8(dst + c, t);
    }
  } else {
    for (int64_t c = lane; c < width; c += 32)
      Elt<T>::store(dst + c, __fadd_rn(Elt<T>::load(dst + c), __ldg(src + c)));
  }
}

template <typename T>
cudaError_t launch_scatter(const int32_t* ids, const float* grads, void* table,
                           const int32_t* n_valid, int64_t n, int64_t rows,
                           int64_t width, int vec8, cudaStream_t stream) {
  if (n == 0) return cudaSuccess;
  const int threads = 256;                       // 8 rows a block
  const int64_t blocks = (n * 32 + threads - 1) / threads;
  T* t = static_cast<T*>(table);
  if (vec8)
    scatter_add_rows_kernel<T, true><<<(unsigned)blocks, threads, 0, stream>>>(
        ids, grads, t, n_valid, n, rows, width);
  else
    scatter_add_rows_kernel<T, false><<<(unsigned)blocks, threads, 0, stream>>>(
        ids, grads, t, n_valid, n, rows, width);
  return cudaGetLastError();
}

}  // namespace

// table: [rows, row_bytes] bytes; ids: [n] int32 in [0, rows) (a device-side
// assert otherwise); out: [n, row_bytes]. unit is the word size in bytes (16,
// 8, 4, 2 or 1); row_bytes and both pointers must be multiples of it.
// Returns a cudaError_t.
extern "C" int rf_gather_rows(const void* table, const int32_t* ids,
                              void* out, int64_t n, int64_t row_bytes,
                              int64_t rows, int unit, void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (unit <= 0 || row_bytes % unit != 0 ||
      reinterpret_cast<uintptr_t>(table) % unit != 0 ||
      reinterpret_cast<uintptr_t>(out) % unit != 0)
    return (int)cudaErrorInvalidValue;
  if (n == 0) return (int)cudaSuccess;
  switch (unit) {
    case 16: return (int)launch<uint4>(table, ids, out, n, row_bytes, rows, s);
    case 8: return (int)launch<uint2>(table, ids, out, n, row_bytes, rows, s);
    case 4:
      return (int)launch<uint32_t>(table, ids, out, n, row_bytes, rows, s);
    case 2:
      return (int)launch<uint16_t>(table, ids, out, n, row_bytes, rows, s);
    case 1:
      return (int)launch<uint8_t>(table, ids, out, n, row_bytes, rows, s);
    default: return (int)cudaErrorInvalidValue;
  }
}

// ids: [n] int32; grads: [n, width] float32; table: [rows, width] of dtype
// (0 float32, 1 bfloat16), updated in place; n_valid: one int32 in device
// memory. vec8 = 1 when width is a multiple of 8 and all three base pointers
// are 16-byte aligned. Returns a cudaError_t.
extern "C" int rf_scatter_add_rows(const int32_t* ids, const float* grads,
                                   void* table, const int32_t* n_valid,
                                   int64_t n, int64_t rows, int64_t width,
                                   int dtype, int vec8, void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  switch (dtype) {
    case 0: return (int)launch_scatter<float>(ids, grads, table, n_valid, n,
                                              rows, width, vec8, s);
    case 1: return (int)launch_scatter<__nv_bfloat16>(ids, grads, table,
                                                      n_valid, n, rows, width,
                                                      vec8, s);
    default: return (int)cudaErrorInvalidValue;
  }
}

extern "C" const char* rf_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}
