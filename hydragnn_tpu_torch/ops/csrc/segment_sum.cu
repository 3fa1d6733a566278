// segment_sum.cu — the sorted segment sum for Hopper (sm_90a).
//
// Replaces hydragnn_tpu/ops/segment_pallas.py:_sum_kernel (reached through
// _csr_kernel_call(family=False), segment_sum_pallas and segment_sum_fast).
// For segment ids sorted ascending it gives, per row n and column f,
//
//   out[n, f] = Σ data[e, f]   over the edges e of row n with mask[e] set
//
// accumulated in float32 for float32 and bfloat16 data alike; rows with no
// such edge are 0. Masked edges are skipped, not multiplied by 0. Ids
// outside [0, n_rows) belong to no row: their edges are never walked.
//
// What bounds it on this card: bytes. Each data element is read once and
// takes one add; the least time is
// (E·W·sizeof(data) + E·4 [+ E·1 mask] + N·W·4) / 3.35 TB/s.
//
// What the design does about it:
//   - CSR row pointers come from a one-thread-per-edge pass over the sorted
//     ids (common.cuh), so no search and no atomics.
//   - Each output element has one owner thread that walks its row's edges in
//     order: two launches are bitwise equal, and the sum is the plain
//     sequential float32 sum (__fadd_rn, never contracted), the same
//     roundings as index_add_ on the host.
//   - Lanes run along the columns (coalesced reads of one edge row); rows
//     narrower than a warp share it (common.cuh:lanes_log2).
// The TPU mechanics of the original (one-hot MXU matmuls, the 3-term bf16
// split of f32 data, CE-aligned DMA windows) have no counterpart here.

#include "common.cuh"

namespace {

template <typename T>
__global__ void segment_sum_kernel(const T* __restrict__ data, const uint8_t* __restrict__ mask,
                                   const int32_t* __restrict__ ptr, long long n_rows, int w,
                                   int lpr_log2, float* __restrict__ out) {
  const int lpr = 1 << lpr_log2;
  const int lane = threadIdx.x & (lpr - 1);
  const long long row =
      (long long)blockIdx.x * (blockDim.x >> lpr_log2) + (threadIdx.x >> lpr_log2);
  if (row >= n_rows) return;
  const int32_t lo = ptr[row];
  const int32_t hi = ptr[row + 1];
  for (int f = lane; f < w; f += lpr) {
    float s = 0.f;
    for (int32_t e = lo; e < hi; ++e) {
      if (mask != nullptr && !mask[e]) continue;
      s = __fadd_rn(s, to_f32<T>(data[(size_t)e * w + f]));
    }
    out[(size_t)row * w + f] = s;
  }
}

template <typename T>
void launch(const void* data, const void* ids, const void* mask, long long n_edges,
            long long n_rows, int w, void* row_ptr, void* out, cudaStream_t stream) {
  launch_row_ptr(ids, n_edges, n_rows, row_ptr, stream);
  const int lpr_log2 = lanes_log2(w);
  const long long rows_per_block = kThreads >> lpr_log2;
  const long long blocks = (n_rows + rows_per_block - 1) / rows_per_block;
  segment_sum_kernel<T><<<(unsigned)blocks, kThreads, 0, stream>>>(
      (const T*)data, (const uint8_t*)mask, (const int32_t*)row_ptr, n_rows, w, lpr_log2,
      (float*)out);
}

}  // namespace

// dtype: 0 = float32, 1 = bfloat16. mask may be null (every edge counts).
// row_ptr: n_rows + 1 int32 of scratch, zero-filled by the caller.
// Returns cudaGetLastError() after the launches (0 = success).
extern "C" int hg_segment_sum(const void* data, int dtype, const void* ids, const void* mask,
                              long long n_edges, long long n_rows, int w, void* row_ptr,
                              void* out, void* stream) {
  if (n_rows <= 0 || w <= 0 || n_edges < 0) return (int)cudaErrorInvalidValue;
  cudaStream_t s = (cudaStream_t)stream;
  if (dtype == 0) {
    launch<float>(data, ids, mask, n_edges, n_rows, w, row_ptr, out, s);
  } else if (dtype == 1) {
    launch<__nv_bfloat16>(data, ids, mask, n_edges, n_rows, w, row_ptr, out, s);
  } else {
    return (int)cudaErrorInvalidValue;
  }
  return (int)cudaGetLastError();
}
