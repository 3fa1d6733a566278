// gather_stats.cu — the fused gather and K-group statistics for Hopper
// (sm_90a).
//
// Replaces hydragnn_tpu/ops/segment_pallas.py:_gather_stats_kernel (reached
// through _gather_stats_call and gather_presum_stats). With v = table[ids],
// m = mask, and the edge slots cut into groups of K consecutive slots
// (g = e / K), it gives, per group g and column f:
//
//   stats[g, f]      = Σ m·v[e, f]             float32 accumulation
//   stats[g, H + f]  = Σ m·v[e, f]²            float32 accumulation
//   both[g, f]       = max (m ? v[e, f] : lowest)    in the table's type
//   both[g, H + f]   = max (m ? -v[e, f] : lowest)   in the table's type
//
// where lowest is the type's lowest finite value. An all-masked group keeps
// `lowest` in both halves: it is NOT cleaned to 0 here (unlike
// pna_aggregate.cu). The clean happens after the E/K segment max
// (graph/segment.py:segment_max, models/convs.py), exactly as in the JAX
// package. A masked slot never reads the table.
//
// What bounds it on this card: bytes. The least time is
// (E·4 + E·1 + [the table rows read] + (E/K)·2H·4 + (E/K)·2H·sizeof(table))
// / 3.35 TB/s — the [E, H] gather v is never written to device memory.
//
// What the design does about it:
//   - One owner thread per (group, column) walks the group's K slots in
//     order: two launches are bitwise equal, sums are the plain sequential
//     float32 sums (__fadd_rn / __fmul_rn, never contracted to FMAs).
//   - Lanes run along the columns, so a warp reads consecutive values of
//     one gathered table row; narrow tables (conv_0, H = 1) pack many
//     groups per warp (common.cuh:lanes_log2).
//   - NaN is sticky in the maxima, as in the reference's max.

#include "common.cuh"

namespace {

template <typename T>
__global__ void gather_stats_kernel(const T* __restrict__ table, const int32_t* __restrict__ ids,
                                    const uint8_t* __restrict__ mask, long long n_groups,
                                    long long n_rows, int h, int k, int lpr_log2, float lowest,
                                    float* __restrict__ stats, T* __restrict__ both) {
  const int lpr = 1 << lpr_log2;
  const int lane = threadIdx.x & (lpr - 1);
  const long long g =
      (long long)blockIdx.x * (blockDim.x >> lpr_log2) + (threadIdx.x >> lpr_log2);
  if (g >= n_groups) return;
  const long long e0 = g * k;
  for (int f = lane; f < h; f += lpr) {
    float s = 0.f, sq = 0.f;
    float mx = -INFINITY, mn = -INFINITY;
    for (int j = 0; j < k; ++j) {
      const long long e = e0 + j;
      float x = lowest, nx = lowest;
      const long long r = ids[e];
      if (mask[e] && r >= 0 && r < n_rows) {
        x = to_f32<T>(table[r * h + f]);
        nx = -x;
        s = __fadd_rn(s, x);
        sq = __fadd_rn(sq, __fmul_rn(x, x));
      }
      if (x > mx || x != x) mx = x;
      if (nx > mn || nx != nx) mn = nx;
    }
    const size_t o = (size_t)g * 2 * h + f;
    stats[o] = s;
    stats[o + h] = sq;
    both[o] = from_f32<T>(mx);
    both[o + h] = from_f32<T>(mn);
  }
}

template <typename T>
void launch(const void* table, const void* ids, const void* mask, long long n_groups,
            long long n_rows, int h, int k, float lowest, void* stats, void* both,
            cudaStream_t stream) {
  const int lpr_log2 = lanes_log2(h);
  const long long groups_per_block = kThreads >> lpr_log2;
  const long long blocks = (n_groups + groups_per_block - 1) / groups_per_block;
  gather_stats_kernel<T><<<(unsigned)blocks, kThreads, 0, stream>>>(
      (const T*)table, (const int32_t*)ids, (const uint8_t*)mask, n_groups, n_rows, h, k,
      lpr_log2, lowest, (float*)stats, (T*)both);
}

}  // namespace

// dtype: 0 = float32, 1 = bfloat16. ids and mask hold n_groups x k slots.
// Returns cudaGetLastError() after the launch (0 = success).
extern "C" int hg_gather_stats(const void* table, int dtype, const void* ids, const void* mask,
                               long long n_groups, long long n_rows, int h, int k, void* stats,
                               void* both, void* stream) {
  if (n_rows <= 0 || h <= 0 || k <= 0 || n_groups < 0) return (int)cudaErrorInvalidValue;
  if (n_groups == 0) return 0;
  cudaStream_t s = (cudaStream_t)stream;
  if (dtype == 0) {
    launch<float>(table, ids, mask, n_groups, n_rows, h, k, lowest_of(0), stats, both, s);
  } else if (dtype == 1) {
    launch<__nv_bfloat16>(table, ids, mask, n_groups, n_rows, h, k, lowest_of(1), stats, both,
                          s);
  } else {
    return (int)cudaErrorInvalidValue;
  }
  return (int)cudaGetLastError();
}
