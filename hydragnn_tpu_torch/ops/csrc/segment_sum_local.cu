// segment_sum_local.cu — the windowed segment sum for Hopper (sm_90a).
//
// Replaces hydragnn_tpu/ops/segment_pallas.py:_sum_local_kernel (reached
// through segment_sum_local_pallas and segment_sum_local_fast). The ids are
// unsorted but local: row block i (rows [i·B, (i+1)·B), B = the block size
// the window plan's shape implies, ops/segment_sum_local.py:local_block_rows)
// has all its edges inside the edge-position window [win[0, i], win[1, i]).
// It gives, per row n and column f,
//
//   out[n, f] = Σ data[e, f]  over the edges e with ids[e] = n
//
// accumulated in float32 for float32 and bfloat16 data. Windows may overlap;
// an edge of another block inside a window is skipped by its id.
//
// What bounds it on this card: bytes. The least time is
// (E·H·sizeof(data) + E·4 + N·H·4 [+ the window plan]) / 3.35 TB/s: every
// edge row read once, every output row written once.
//
// What the design does:
//   - One thread block per (row block, column tile). Its threads run along
//     the columns, and thread t owns column t of a [B, FT] float32
//     accumulator in dynamic shared memory (B = 128 rows x FT = 128 columns
//     x 4 bytes = 64 KB at the flagship's shapes, above the 48 KB default,
//     hence cudaFuncSetAttribute; wider blocks halve FT to stay within
//     96 KB). All threads walk the window's edges in
//     order; the edge's id picks the accumulator row. No atomics: each
//     accumulator cell has one owner that adds in edge order, so two
//     launches are bitwise equal and equal the sequential float32 sum
//     (index_add_ on the host).
//   - The loop loads U = 8 edges' ids and values before it adds them, so
//     each thread keeps eight reads in flight.
//   - Narrow rows (conv_0, H = 1) leave most of a warp idle: the window scan
//     is then latency-bound, not byte-bound.
// Whether the card wants the windows at all (against the sender_perm sort,
// or atomics) is ROADMAP B4's open question, answered by timing.

#include "common.cuh"

namespace {

constexpr int kUnroll = 8;
constexpr int kMaxSmem = 96 * 1024;

template <typename T>
__global__ void segment_sum_local_kernel(const T* __restrict__ data,
                                         const int32_t* __restrict__ ids,
                                         const int32_t* __restrict__ win, long long n_edges,
                                         int n_blocks, int block_rows, long long n_rows, int h,
                                         float* __restrict__ out) {
  extern __shared__ float acc[];  // [block_rows, blockDim.x]
  const int ft = blockDim.x;
  const int t = threadIdx.x;
  const int f = blockIdx.y * ft + t;
  const int blk = blockIdx.x;
  const long long row0 = (long long)blk * block_rows;
  if (f >= h) return;  // whole columns only: no thread reads another's cells
  for (int r = 0; r < block_rows; ++r) acc[r * ft + t] = 0.f;
  long long lo = win[blk];
  long long hi = win[n_blocks + blk];
  lo = lo < 0 ? 0 : lo;
  hi = hi > n_edges ? n_edges : hi;
  long long e = lo;
  for (; e + kUnroll <= hi; e += kUnroll) {
    long long r[kUnroll];
    float x[kUnroll];
#pragma unroll
    for (int u = 0; u < kUnroll; ++u) r[u] = (long long)ids[e + u] - row0;
#pragma unroll
    for (int u = 0; u < kUnroll; ++u) x[u] = to_f32<T>(data[(size_t)(e + u) * h + f]);
#pragma unroll
    for (int u = 0; u < kUnroll; ++u) {
      if (r[u] >= 0 && r[u] < block_rows) {
        float* cell = &acc[r[u] * ft + t];
        *cell = __fadd_rn(*cell, x[u]);
      }
    }
  }
  for (; e < hi; ++e) {
    const long long r = (long long)ids[e] - row0;
    if (r >= 0 && r < block_rows) {
      float* cell = &acc[r * ft + t];
      *cell = __fadd_rn(*cell, to_f32<T>(data[(size_t)e * h + f]));
    }
  }
  for (int r = 0; r < block_rows; ++r) {
    const long long row = row0 + r;
    if (row < n_rows) out[row * h + f] = acc[r * ft + t];
  }
}

template <typename T>
int launch(const void* data, const void* ids, const void* win, long long n_edges, int n_blocks,
           int block_rows, long long n_rows, int h, void* out, cudaStream_t stream) {
  int ft = 1 << lanes_log2(h);
  while (ft > 1 && (long long)block_rows * ft * 4 > kMaxSmem) ft >>= 1;
  const long long smem = (long long)block_rows * ft * 4;
  if (smem > kMaxSmem) return (int)cudaErrorInvalidValue;
  // raise the kernel's dynamic shared memory limit once, at the first
  // launch (never inside a CUDA graph capture, which replays launches only)
  static bool limit_set = false;
  if (!limit_set) {
    cudaError_t err = cudaFuncSetAttribute(segment_sum_local_kernel<T>,
                                           cudaFuncAttributeMaxDynamicSharedMemorySize, kMaxSmem);
    if (err != cudaSuccess) return (int)err;
    limit_set = true;
  }
  dim3 grid((unsigned)n_blocks, (unsigned)((h + ft - 1) / ft));
  segment_sum_local_kernel<T><<<grid, ft, (size_t)smem, stream>>>(
      (const T*)data, (const int32_t*)ids, (const int32_t*)win, n_edges, n_blocks, block_rows,
      n_rows, h, (float*)out);
  return (int)cudaGetLastError();
}

}  // namespace

// dtype: 0 = float32, 1 = bfloat16. win: int32 [2, n_blocks] (row 0 the
// window starts, row 1 the ends). block_rows x n_blocks >= n_rows.
// Returns a cudaError_t (0 = success).
extern "C" int hg_segment_sum_local(const void* data, int dtype, const void* ids,
                                    const void* win, long long n_edges, int n_blocks,
                                    int block_rows, long long n_rows, int h, void* out,
                                    void* stream) {
  if (n_rows <= 0 || h <= 0 || n_edges < 0 || n_blocks <= 0 || block_rows <= 0 ||
      (long long)n_blocks * block_rows < n_rows)
    return (int)cudaErrorInvalidValue;
  cudaStream_t s = (cudaStream_t)stream;
  if (dtype == 0)
    return launch<float>(data, ids, win, n_edges, n_blocks, block_rows, n_rows, h, out, s);
  if (dtype == 1)
    return launch<__nv_bfloat16>(data, ids, win, n_edges, n_blocks, block_rows, n_rows, h, out,
                                 s);
  return (int)cudaErrorInvalidValue;
}
