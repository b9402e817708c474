// Row gather and row scatter-add for the stacked embedding tables.
//
// gather_rows: out[n, :] = table[ids[n], :].
//
// Replaces: recommendflow_tpu/ops/pallas/embedding_bag.py, gather_rows
// (the Pallas DMA-pipelined row gather), and the XLA take under
// ops/embedding.py:gather_group that the JAX package runs on its main path.
//
// Bound: bytes. The kernel does no arithmetic; it reads N row ids, N rows of
// row_bytes from the table and writes N rows. For the bench_recall dim-64 bf16
// group (87,040 ids per batch of 1024, 128-byte rows) that is 11.1 MB read +
// 11.1 MB written + 0.35 MB of ids, about 6.8 us at the H100 SXM's 3.35 TB/s.
//
// Design: the kernel copies bytes and knows nothing of the element type, so
// f32 and bf16 tables (and the result) are bit-identical to the plain
// gather. A row is split into `unit`-byte words (16 bytes when the row width
// and both base pointers allow it); one thread moves one word, so a 128-byte
// row is a quarter of a warp and neighbouring threads touch neighbouring
// addresses of the same row. Row ids are read through the read-only cache;
// all offsets are 64-bit (rows * row_bytes exceeds 2^31 on the ranking
// config). Range checking of ids is the wrapper's job.
//
// The TPU kernel's bf16 byte-view workaround (a Mosaic DMA limit) and its
// padded tail (ids past N re-read row 0) have no counterpart here: the grid
// covers exactly N * row_bytes / unit words.

#include <cuda_runtime.h>
#include <stdint.h>

#include "row_io.cuh"

namespace {

template <typename W>
__global__ void gather_rows_kernel(const W* __restrict__ table,
                                   const int32_t* __restrict__ ids,
                                   W* __restrict__ out, int64_t n_words,
                                   int64_t words_per_row) {
  const int64_t stride = (int64_t)gridDim.x * blockDim.x;
  for (int64_t i = (int64_t)blockIdx.x * blockDim.x + threadIdx.x;
       i < n_words; i += stride) {
    const int64_t row = i / words_per_row;
    const int64_t w = i - row * words_per_row;
    const int64_t src = (int64_t)__ldg(ids + row);
    out[i] = __ldg(table + src * words_per_row + w);
  }
}

template <typename W>
cudaError_t launch(const void* table, const int32_t* ids, void* out,
                   int64_t n, int64_t row_bytes, cudaStream_t stream) {
  const int64_t words_per_row = row_bytes / (int64_t)sizeof(W);
  const int64_t n_words = n * words_per_row;
  if (n_words == 0) return cudaSuccess;
  const int threads = 256;
  // enough blocks for every word, capped; the grid-stride loop covers the
  // rest (at most 132 SMs x 16 resident blocks are in flight anyway)
  int64_t blocks = (n_words + threads - 1) / threads;
  if (blocks > 132 * 64) blocks = 132 * 64;
  gather_rows_kernel<W><<<(unsigned)blocks, threads, 0, stream>>>(
      static_cast<const W*>(table), ids, static_cast<W*>(out), n_words,
      words_per_row);
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

// table: [rows, row_bytes] bytes; ids: [n] int32 in [0, rows); out: [n,
// row_bytes]. unit is the word size in bytes (16, 8, 4, 2 or 1); row_bytes
// and both pointers must be multiples of it. Returns a cudaError_t.
extern "C" int rf_gather_rows(const void* table, const int32_t* ids,
                              void* out, int64_t n, int64_t row_bytes,
                              int unit, void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  switch (unit) {
    case 16: return (int)launch<uint4>(table, ids, out, n, row_bytes, s);
    case 8: return (int)launch<uint2>(table, ids, out, n, row_bytes, s);
    case 4: return (int)launch<uint32_t>(table, ids, out, n, row_bytes, s);
    case 2: return (int)launch<uint16_t>(table, ids, out, n, row_bytes, s);
    case 1: return (int)launch<uint8_t>(table, ids, out, n, row_bytes, s);
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
