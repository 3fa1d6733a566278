// gather_rows.cu — the row gather out[e] = table[ids[e]] for Hopper (sm_90a).
//
// Replaces hydragnn_tpu/ops/segment_pallas.py:_bcast_kernel (reached through
// _bcast_kernel_call, gather_rows_sorted_fast and gather_rows_local_fast).
// Each output row is a copy of its table row, bit for bit, for any element
// type and width. An id outside [0, n_rows) gives a zero row (the TPU
// kernel's sentinel rows), never an out-of-bounds read.
//
// "Sorted" and "local" ids are one kernel here. The TPU needed a window
// plan per edge chunk so that a one-hot MXU matmul could stream the table
// rows a chunk touches; a Hopper thread reads its row directly, and the
// id order only changes how often L2 hits.
//
// What bounds it on this card: bytes. The least time is
// (E·4 + E·W·s [table rows read] + E·W·s [out written]) / 3.35 TB/s, with
// the table read counted once per distinct row at best.
//
// What the design does about it: a row is moved as the widest vector
// (16, 8, 4, 2 or 1 bytes) that divides its byte width, one vector per
// thread, neighbouring threads on neighbouring addresses — 16 bytes a
// thread at H = 128 f32 or bf16. No arithmetic touches the bits.

#include "common.cuh"

namespace {

template <typename V>
__global__ void gather_rows_kernel(const V* __restrict__ table, const int32_t* __restrict__ ids,
                                   long long n_ids, long long n_rows, int vpr,
                                   V* __restrict__ out) {
  const long long i = (long long)blockIdx.x * blockDim.x + threadIdx.x;
  if (i >= n_ids * vpr) return;
  const long long e = i / vpr;
  const int c = (int)(i - e * vpr);
  const long long r = ids[e];
  V val{};
  if (r >= 0 && r < n_rows) val = table[r * vpr + c];
  out[i] = val;
}

template <typename V>
void launch(const void* table, const void* ids, long long n_ids, long long n_rows,
            long long row_bytes, void* out, cudaStream_t stream) {
  const int vpr = (int)(row_bytes / (long long)sizeof(V));
  const long long total = n_ids * vpr;
  gather_rows_kernel<V><<<(unsigned)((total + kThreads - 1) / kThreads), kThreads, 0, stream>>>(
      (const V*)table, (const int32_t*)ids, n_ids, n_rows, vpr, (V*)out);
}

}  // namespace

// row_bytes: bytes per table row (width x element size). table and out
// must be aligned to the vector chosen (PyTorch's allocations are).
// Returns cudaGetLastError() after the launch (0 = success).
extern "C" int hg_gather_rows(const void* table, const void* ids, long long n_ids,
                              long long n_rows, long long row_bytes, void* out, void* stream) {
  if (n_rows < 0 || n_ids < 0 || row_bytes <= 0) return (int)cudaErrorInvalidValue;
  if (n_ids == 0) return 0;
  cudaStream_t s = (cudaStream_t)stream;
  const uintptr_t align = (uintptr_t)table | (uintptr_t)out;
  if (row_bytes % 16 == 0 && align % 16 == 0) {
    launch<uint4>(table, ids, n_ids, n_rows, row_bytes, out, s);
  } else if (row_bytes % 8 == 0 && align % 8 == 0) {
    launch<uint2>(table, ids, n_ids, n_rows, row_bytes, out, s);
  } else if (row_bytes % 4 == 0 && align % 4 == 0) {
    launch<uint32_t>(table, ids, n_ids, n_rows, row_bytes, out, s);
  } else if (row_bytes % 2 == 0 && align % 2 == 0) {
    launch<uint16_t>(table, ids, n_ids, n_rows, row_bytes, out, s);
  } else {
    launch<uint8_t>(table, ids, n_ids, n_rows, row_bytes, out, s);
  }
  return (int)cudaGetLastError();
}
