// pna_aggregate.cu — the PNA aggregation forward for Hopper (sm_90a).
//
// Replaces hydragnn_tpu/ops/segment_pallas.py:_family_kernel (reached
// through _csr_kernel_call(family=True)) and, in the same pass, the XLA
// segment_max over [v, -v] that hydragnn_tpu/ops/segment_pallas.py:
// _pna_aggregate pairs with it. For receivers sorted ascending it gives,
// per receiver row n and feature f, over the edges e of row n with
// mask[e] set:
//
//   sum[n, f]      = Σ v[e, f]            float32 accumulation
//   sumsq[n, f]    = Σ v[e, f]²           float32 accumulation
//   cnt[n]         = number of such edges float32
//   both[n, f]     = max v[e, f]          in v's type
//   both[n, H + f] = max -v[e, f]         in v's type
//
// with both = 0 where the row has no such edge (or where the maximum is at
// or below the type's lowest finite value, as the reference's empty-clean
// does). Masked edges are skipped, not multiplied by 0: padding edges point
// at a padding node, and a masked value must not reach a maximum.
//
// What bounds it on this card: bytes. Each v element is read once and takes
// part in 2 adds, 1 multiply and 2 comparisons; even at H = 128 that is
// about one operation per byte read, far below the H100's ~20 float32
// operations per byte of its 3.35 TB/s. The least time is
// (E·H·sizeof(v) + E·4 + E·1 + N·H·8 + N·4 + N·2H·sizeof(v)) / 3.35 TB/s.
//
// What the design does about it:
//   - v is read once, for all four statistics (the TPU read it twice: once
//     in the kernel, once in XLA's scatter-max).
//   - Each receiver row belongs to one group of LPR lanes (LPR = the power
//     of two at or above H, at most 128). Lanes run along the feature axis,
//     so one warp reads 32 consecutive values of one edge row: coalesced.
//     Narrow rows (conv_0 has H = 1) pack many receiver rows per warp
//     instead of idling lanes.
//   - CSR row pointers come from a one-thread-per-edge pass over the sorted
//     receivers (no search, no atomics). Each output element has one owner
//     thread that walks its row's edges in order, so two runs are bitwise
//     equal and the sums are the plain sequential float32 sums.
//   - Sums are written with __fadd_rn/__fmul_rn so the compiler does not
//     contract them into fused multiply-adds: the kernel then does the same
//     roundings as the plain PyTorch version.
// The TPU mechanics of the original (one-hot MXU matmuls, the 3-term bf16
// split, 128-lane padding, double-buffered DMA) have no counterpart here.

#include "common.cuh"

namespace {

template <typename T>
__global__ void pna_aggregate_kernel(const T* __restrict__ v, const uint8_t* __restrict__ mask,
                                     const int32_t* __restrict__ ptr, long long n_rows, int h,
                                     int lpr_log2, float lowest, float* __restrict__ sum,
                                     float* __restrict__ sumsq, float* __restrict__ cnt,
                                     T* __restrict__ both) {
  const int lpr = 1 << lpr_log2;
  const int lane = threadIdx.x & (lpr - 1);
  const long long row =
      (long long)blockIdx.x * (blockDim.x >> lpr_log2) + (threadIdx.x >> lpr_log2);
  if (row >= n_rows) return;
  const int32_t lo = ptr[row];
  const int32_t hi = ptr[row + 1];
  if (lane == 0) {
    int c = 0;
    for (int32_t e = lo; e < hi; ++e) c += (mask == nullptr || mask[e]) ? 1 : 0;
    cnt[row] = (float)c;
  }
  for (int f = lane; f < h; f += lpr) {
    float s = 0.f, sq = 0.f;
    float mx = -INFINITY, mn = -INFINITY;
    for (int32_t e = lo; e < hi; ++e) {
      if (mask != nullptr && !mask[e]) continue;
      const float x = to_f32<T>(v[(size_t)e * h + f]);
      const float nx = -x;
      s = __fadd_rn(s, x);
      sq = __fadd_rn(sq, __fmul_rn(x, x));
      // NaN is sticky, as in the reference's max
      if (x > mx || x != x) mx = x;
      if (nx > mn || nx != nx) mn = nx;
    }
    const size_t o = (size_t)row * h + f;
    sum[o] = s;
    sumsq[o] = sq;
    const size_t ob = (size_t)row * 2 * h + f;
    both[ob] = from_f32<T>(mx <= lowest ? 0.f : mx);
    both[ob + h] = from_f32<T>(mn <= lowest ? 0.f : mn);
  }
}

template <typename T>
void launch(const void* v, const void* recv, const void* mask, long long n_edges,
            long long n_rows, int h, void* row_ptr, void* sum, void* sumsq, void* cnt,
            void* both, float lowest, cudaStream_t stream) {
  launch_row_ptr(recv, n_edges, n_rows, row_ptr, stream);
  const int lpr_log2 = lanes_log2(h);
  const long long rows_per_block = kThreads >> lpr_log2;
  const long long blocks = (n_rows + rows_per_block - 1) / rows_per_block;
  pna_aggregate_kernel<T><<<(unsigned)blocks, kThreads, 0, stream>>>(
      (const T*)v, (const uint8_t*)mask, (const int32_t*)row_ptr, n_rows, h, lpr_log2, lowest,
      (float*)sum, (float*)sumsq, (float*)cnt, (T*)both);
}

}  // namespace

// dtype: 0 = float32, 1 = bfloat16. mask may be null (every edge valid).
// row_ptr: n_rows + 1 int32 of scratch, zero-filled by the caller.
// Returns cudaGetLastError() after the launches (0 = success).
extern "C" int hg_pna_aggregate_fwd(const void* v, int dtype, const void* recv,
                                    const void* mask, long long n_edges, long long n_rows,
                                    int h, void* row_ptr, void* sum, void* sumsq, void* cnt,
                                    void* both, void* stream) {
  if (n_rows <= 0 || h <= 0 || n_edges < 0) return (int)cudaErrorInvalidValue;
  cudaStream_t s = (cudaStream_t)stream;
  if (dtype == 0) {
    launch<float>(v, recv, mask, n_edges, n_rows, h, row_ptr, sum, sumsq, cnt, both,
                  lowest_of(0), s);
  } else if (dtype == 1) {
    launch<__nv_bfloat16>(v, recv, mask, n_edges, n_rows, h, row_ptr, sum, sumsq, cnt, both,
                          lowest_of(1), s);
  } else {
    return (int)cudaErrorInvalidValue;
  }
  return (int)cudaGetLastError();
}
