// Row gather for the stacked embedding tables: out[n, :] = table[ids[n], :].
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

extern "C" const char* rf_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}
