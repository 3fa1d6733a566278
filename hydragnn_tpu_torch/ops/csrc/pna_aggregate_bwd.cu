// pna_aggregate_bwd.cu — the backward of the PNA aggregation for Hopper
// (sm_90a): two kernels, B6 (tie counts) and B7 (the edge gradient).
//
// Replaces hydragnn_tpu/ops/segment_pallas.py:_pna_bwd_count_kernel (K1)
// and :_pna_bwd_grad_kernel (K2), reached through _pna_bwd_kernels from
// the custom VJP of pna_aggregate. The forward (pna_aggregate.cu) gave,
// per receiver row n over its unmasked edges, sum, sumsq and
// both = [max v | max -v] (empty rows cleaned to 0). For receivers sorted
// ascending, per row n, column c < H and edge e of row n:
//
//   B6  cnt[n, c]     = #{unmasked e : v[e, c] == both[n, c]}
//       cnt[n, H + c] = #{unmasked e : -v[e, c] == both[n, H + c]}
//
//   B7  share_x = T(g_both[n, c] / max(cnt[n, c], 1))          (f32 divide)
//       share_n = T(g_both[n, H + c] / max(cnt[n, H + c], 1))
//       grad[e, c] = T( T(g_sum) + 2·v·T(g_sumsq)
//                       + [v == both[n, c]]·share_x
//                       - [-v == both[n, H + c]]·share_n )     unmasked e
//       grad[e, c] = 0                                          masked e
//
// T is v's type (float32 or bfloat16): the cotangent table and the shares
// are cast to it before use, as the reference casts them, and the sum is
// formed in float32 and cast once at the end, as its K2 does. Every
// compare runs in float32 on values of v's type, which is exact.
//
// Masked edges are skipped outright, never tested by value: the padding
// node's `both` is cleaned to 0 and a masked edge may carry v = 0.
//
// What bounds them on this card: bytes. B6 reads v once and writes
// [N, 2H] float32 counts; B7 reads v and the node tables once and writes
// the [E, H] gradient. A handful of float operations per element, far
// below the H100's ~20 float32 operations per byte of its 3.35 TB/s.
//
// What the design does about it:
//   - The rows are CSR rows of the sorted receivers: both kernels read the
//     row pointers the forward (pna_aggregate.cu) built, so the backward
//     builds none. Each (row, column) has one owner thread that walks its
//     row's edges in order: no atomics, no search, two launches bitwise
//     equal.
//   - Lanes run along the columns, so a warp reads 32 consecutive values
//     of one edge row (coalesced); narrow rows (conv_0 has H = 1) pack
//     many receiver rows into one warp (common.cuh:lanes_log2).
//   - B7's owner loads its row's node values (g_sum, g_sumsq, both, g_both,
//     cnt) once and forms the shares itself: no [E, 2H] tie mask and no
//     [N, 6H] stacked table ever reach device memory.
//   - Arithmetic is written with __fmul_rn/__fadd_rn/__fsub_rn/__fdiv_rn so
//     the compiler does not contract it into fused multiply-adds; the
//     kernel then rounds where the plain PyTorch version rounds.
// The TPU mechanics of the original (K1's one-hot MXU matmul against node
// blocks, K2's windowed gather of a stacked [N, 6H] table, 128-lane
// padding) have no counterpart here.

#include "common.cuh"

namespace {

template <typename T>
__global__ void pna_bwd_count_kernel(const T* __restrict__ v, const uint8_t* __restrict__ mask,
                                     const int32_t* __restrict__ ptr, long long n_rows, int h,
                                     int lpr_log2, const T* __restrict__ both,
                                     float* __restrict__ cnt) {
  const int lpr = 1 << lpr_log2;
  const int lane = threadIdx.x & (lpr - 1);
  const long long row =
      (long long)blockIdx.x * (blockDim.x >> lpr_log2) + (threadIdx.x >> lpr_log2);
  if (row >= n_rows) return;
  const int32_t lo = ptr[row];
  const int32_t hi = ptr[row + 1];
  const size_t ob = (size_t)row * 2 * h;
  for (int c = lane; c < h; c += lpr) {
    const float mx = to_f32<T>(both[ob + c]);
    const float mn = to_f32<T>(both[ob + h + c]);
    int cx = 0, cn = 0;
    for (int32_t e = lo; e < hi; ++e) {
      if (mask != nullptr && !mask[e]) continue;
      const float x = to_f32<T>(v[(size_t)e * h + c]);
      cx += (x == mx) ? 1 : 0;
      cn += (-x == mn) ? 1 : 0;
    }
    cnt[ob + c] = (float)cx;
    cnt[ob + h + c] = (float)cn;
  }
}

template <typename T>
__global__ void pna_bwd_grad_kernel(const T* __restrict__ v, const uint8_t* __restrict__ mask,
                                    const int32_t* __restrict__ ptr, long long n_rows,
                                    long long n_edges, int h, int lpr_log2,
                                    const float* __restrict__ g_sum,
                                    const float* __restrict__ g_sumsq,
                                    const T* __restrict__ both, const T* __restrict__ g_both,
                                    const float* __restrict__ cnt, T* __restrict__ grad) {
  const int lpr = 1 << lpr_log2;
  const int lane = threadIdx.x & (lpr - 1);
  const long long row =
      (long long)blockIdx.x * (blockDim.x >> lpr_log2) + (threadIdx.x >> lpr_log2);
  if (row >= n_rows) return;
  const int32_t lo = ptr[row];
  const int32_t hi = ptr[row + 1];
  // edges whose receiver lies outside [0, n_rows) belong to no row; the
  // first and last rows' owners write their gradient (0)
  const long long z_lo = (row == 0) ? 0 : lo;
  const long long z_hi = (row == n_rows - 1) ? n_edges : hi;
  const size_t on = (size_t)row * h;
  const size_t ob = (size_t)row * 2 * h;
  for (int c = lane; c < h; c += lpr) {
    const float gs = to_f32<T>(from_f32<T>(g_sum[on + c]));
    const float gss = to_f32<T>(from_f32<T>(g_sumsq[on + c]));
    const float mx = to_f32<T>(both[ob + c]);
    const float mn = to_f32<T>(both[ob + h + c]);
    const float shx = to_f32<T>(from_f32<T>(
        __fdiv_rn(to_f32<T>(g_both[ob + c]), fmaxf(cnt[ob + c], 1.f))));
    const float shn = to_f32<T>(from_f32<T>(
        __fdiv_rn(to_f32<T>(g_both[ob + h + c]), fmaxf(cnt[ob + h + c], 1.f))));
    for (long long e = z_lo; e < z_hi; ++e) {
      const size_t o = (size_t)e * h + c;
      if (e < lo || e >= hi || (mask != nullptr && !mask[e])) {
        grad[o] = from_f32<T>(0.f);
        continue;
      }
      const float x = to_f32<T>(v[o]);
      float g = __fadd_rn(gs, __fmul_rn(__fmul_rn(2.f, x), gss));
      g = __fadd_rn(g, (x == mx) ? shx : 0.f);
      g = __fsub_rn(g, (-x == mn) ? shn : 0.f);
      grad[o] = from_f32<T>(g);
    }
  }
}

inline void grid_of(long long n_rows, int h, int* lpr_log2, unsigned* blocks) {
  *lpr_log2 = lanes_log2(h);
  const long long rows_per_block = kThreads >> *lpr_log2;
  *blocks = (unsigned)((n_rows + rows_per_block - 1) / rows_per_block);
}

template <typename T>
void launch_count(const void* v, const void* mask, long long n_rows, int h, const void* both,
                  const void* row_ptr, void* cnt, cudaStream_t stream) {
  int lpr_log2;
  unsigned blocks;
  grid_of(n_rows, h, &lpr_log2, &blocks);
  pna_bwd_count_kernel<T><<<blocks, kThreads, 0, stream>>>(
      (const T*)v, (const uint8_t*)mask, (const int32_t*)row_ptr, n_rows, h, lpr_log2,
      (const T*)both, (float*)cnt);
}

template <typename T>
void launch_grad(const void* v, const void* mask, long long n_edges, long long n_rows, int h,
                 const void* g_sum, const void* g_sumsq, const void* both, const void* g_both,
                 const void* cnt, const void* row_ptr, void* grad, cudaStream_t stream) {
  int lpr_log2;
  unsigned blocks;
  grid_of(n_rows, h, &lpr_log2, &blocks);
  pna_bwd_grad_kernel<T><<<blocks, kThreads, 0, stream>>>(
      (const T*)v, (const uint8_t*)mask, (const int32_t*)row_ptr, n_rows, n_edges, h, lpr_log2,
      (const float*)g_sum, (const float*)g_sumsq, (const T*)both, (const T*)g_both,
      (const float*)cnt, (T*)grad);
}

}  // namespace

// B6. dtype: 0 = float32, 1 = bfloat16 (v and both). mask may be null
// (every edge valid). row_ptr: the n_rows + 1 int32 CSR row pointers of
// the sorted receivers (ptr[r] = first edge whose receiver is >= r, as
// common.cuh:csr_row_ptr_kernel builds them). cnt: [n_rows, 2h] float32.
// Returns cudaGetLastError() after the launch (0 = success).
extern "C" int hg_pna_bwd_count(const void* v, int dtype, const void* mask, long long n_rows,
                                int h, const void* both, const void* row_ptr, void* cnt,
                                void* stream) {
  if (n_rows <= 0 || h <= 0) return (int)cudaErrorInvalidValue;
  cudaStream_t s = (cudaStream_t)stream;
  if (dtype == 0) {
    launch_count<float>(v, mask, n_rows, h, both, row_ptr, cnt, s);
  } else if (dtype == 1) {
    launch_count<__nv_bfloat16>(v, mask, n_rows, h, both, row_ptr, cnt, s);
  } else {
    return (int)cudaErrorInvalidValue;
  }
  return (int)cudaGetLastError();
}

// B7. v, both, g_both and grad in dtype; g_sum, g_sumsq [n_rows, h] and
// cnt [n_rows, 2h] float32. Same conventions as B6; n_edges is v's row
// count (edges outside every row get a zero gradient).
extern "C" int hg_pna_bwd_grad(const void* v, int dtype, const void* mask, long long n_edges,
                               long long n_rows, int h, const void* g_sum, const void* g_sumsq,
                               const void* both, const void* g_both, const void* cnt,
                               const void* row_ptr, void* grad, void* stream) {
  if (n_rows <= 0 || h <= 0 || n_edges < 0) return (int)cudaErrorInvalidValue;
  cudaStream_t s = (cudaStream_t)stream;
  if (dtype == 0) {
    launch_grad<float>(v, mask, n_edges, n_rows, h, g_sum, g_sumsq, both, g_both, cnt, row_ptr,
                       grad, s);
  } else if (dtype == 1) {
    launch_grad<__nv_bfloat16>(v, mask, n_edges, n_rows, h, g_sum, g_sumsq, both, g_both, cnt,
                               row_ptr, grad, s);
  } else {
    return (int)cudaErrorInvalidValue;
  }
  return (int)cudaGetLastError();
}
