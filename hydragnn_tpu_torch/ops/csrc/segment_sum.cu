// segment_sum.cu — the sorted segment sum for Hopper (sm_90a).
//
// Replaces hydragnn_tpu/ops/segment_pallas.py:_sum_kernel (reached through
// _csr_kernel_call(family=False), segment_sum_pallas and segment_sum_fast).
// For segment ids sorted ascending it gives, per row n and column f,
//
//   out[n, f] = Σ data[e, f]   over the edges e < bound of row n with mask[e] set
//
// accumulated in float32 for float32 and bfloat16 data alike; rows with no
// such edge are 0. Masked edges are skipped, not multiplied by 0. Ids
// outside [0, n_rows) belong to no row: their edges are never walked.
// `bound` is *real_rows, read on the device (clamped to [0, n_edges]), or
// n_edges without it: the caller's promise that no data row at or past it
// adds anything (they are zero, masked, or their row's result is not
// read), so the walk stops there. A batch's masked tail (the run of slots
// at the padding node past edge_occupancy) is then never read.
//
// What bounds it on this card: bytes. Each data element is read once and
// takes one add; the least time is
// (bound·W·sizeof(data) + bound·4 [+ bound·1 mask] + N·W·4) / 3.35 TB/s.
// What held the first port back was latency and skew, not bytes: one thread
// per (row, column) walked its row one load at a time, and a long row (the
// masked tail, 14,745 K-group rows at the training loop's batch of 128)
// was one chain of dependent loads while the card idled.
//
// What the design does:
//   - CSR row pointers come from a one-thread-per-edge pass over the sorted
//     ids (common.cuh), so no search and no atomics. Sorted ids write every
//     entry, so the scratch needs no fill; the walk clamps each row's range
//     to [0, bound] all the same.
//   - A lane group of G = 2^g lanes owns a row (a warp from 32 vectors up,
//     32 / G rows a warp below); each lane owns a vector of V bytes of
//     columns (16 where the row's bytes and the data's address allow:
//     common.cuh:row_vector_bytes) and issues U row loads (8, or 4 for
//     wide vectors) before it adds any of them. A CTA takes 8 warps' rows
//     at a time, and a grid of kCtasPerSm CTAs an SM walks the row tiles.
//   - A row with more than kLong edges (below the bound) is left by its
//     group to the whole CTA, after the tile's short rows: the CTA streams
//     the row's contiguous data through a ring of kStages shared-memory
//     tiles by cp.async (kStages - 1 tiles in flight) with each edge's mask
//     byte beside it, and each thread owns a column (or a few) of the row
//     and adds its tiles' values from shared memory in edge order.
//   - Every output element has one accumulator, fed in edge order with
//     __fadd_rn (never contracted): two launches are bitwise equal, and the
//     sum is the plain sequential float32 sum, the same roundings as
//     index_add_ on the host. No atomics.
// The TPU mechanics of the original (one-hot MXU matmuls, the 3-term bf16
// split of f32 data, CE-aligned DMA windows) have no counterpart here.

#include "common.cuh"

namespace {

constexpr int kWarps = 8;
constexpr int kCtaThreads = kWarps * 32;
constexpr int kCtasPerSm = 3;    // the grid: this many CTAs an SM (the launch bounds' register cap)
constexpr int kLong = 64;        // a row's edges above which the CTA streams it
constexpr int kStages = 4;       // the long-row ring's tiles
constexpr int kStageBytes = 8192;  // one tile
constexpr int kTileEdges = 1024;   // at most edges a tile (its mask bytes)

// The whole CTA sums long row `row` over edges [lo, hi): columns in chunks
// of at most kStageBytes, each chunk's edges in tiles through the ring.
template <typename T, int V>
__device__ __forceinline__ void long_row(const T* __restrict__ data, const uint8_t* __restrict__ mask,
                                         long long row, long long lo, long long hi, int w, int nv,
                                         unsigned char (*ring)[kStageBytes], uint8_t (*ring_mask)[kTileEdges],
                                         float* __restrict__ out) {
  constexpr int kMaxE = kStageBytes / (int)sizeof(T) / kCtaThreads;  // a thread's columns a chunk
  const char* db = reinterpret_cast<const char*>(data);
  const size_t row_bytes = (size_t)w * sizeof(T);
  const int chunk_v = nv < kStageBytes / V ? nv : kStageBytes / V;
  const long long ne_all = hi - lo;
  for (int cv0 = 0; cv0 < nv; cv0 += chunk_v) {
    const int ncv = nv - cv0 < chunk_v ? nv - cv0 : chunk_v;  // this chunk's vectors
    const int cbytes = ncv * V;
    const int ce = cbytes / (int)sizeof(T);                   // and its columns
    int te = kStageBytes / cbytes;                            // edges a tile
    te = te > kTileEdges ? kTileEdges : te;
    const long long tiles = (ne_all + te - 1) / te;
    auto issue = [&](long long t) {
      const int slot = (int)(t % kStages);
      const long long e0 = lo + t * te;
      const int ne = ne_all - t * te < te ? (int)(ne_all - t * te) : te;
      for (int p = threadIdx.x; p < ne * ncv; p += kCtaThreads) {
        const int u = p / ncv;
        const int q = p - u * ncv;
        const char* src = db + (size_t)(e0 + u) * row_bytes + (size_t)(cv0 + q) * V;
        unsigned char* dst = ring[slot] + u * cbytes + q * V;
        if constexpr (V >= 4)
          copy_async<V>(dst, src);
        else
          *reinterpret_cast<uint16_t*>(dst) = *reinterpret_cast<const uint16_t*>(src);
      }
      for (int p = threadIdx.x; p < ne; p += kCtaThreads) ring_mask[slot][p] = mask == nullptr ? 1 : mask[e0 + p];
    };
    float acc[kMaxE];
#pragma unroll
    for (int j = 0; j < kMaxE; ++j) acc[j] = 0.f;
    for (int t = 0; t < kStages - 1; ++t) {
      if (t < tiles) issue(t);
      copy_async_commit();
    }
    for (long long t = 0; t < tiles; ++t) {
      copy_async_wait<kStages - 2>();  // this thread's copies of tile t have landed
      __syncthreads();                 // everyone's have; tile t - 1 is summed
      if (t + kStages - 1 < tiles) issue(t + kStages - 1);
      copy_async_commit();
      const int slot = (int)(t % kStages);
      const T* buf = reinterpret_cast<const T*>(ring[slot]);
      const uint8_t* mb = ring_mask[slot];
      const int ne = ne_all - t * te < te ? (int)(ne_all - t * te) : te;
#pragma unroll
      for (int j = 0; j < kMaxE; ++j) {
        const int c = threadIdx.x + j * kCtaThreads;
        if (c >= ce) break;
        for (int u = 0; u < ne; ++u)
          if (mb[u]) acc[j] = __fadd_rn(acc[j], to_f32<T>(buf[(size_t)u * ce + c]));
      }
    }
    copy_async_wait<0>();
    __syncthreads();  // the ring is free for the next chunk or row
    float* dst = out + (size_t)row * w + (size_t)cv0 * (V / sizeof(T));
#pragma unroll
    for (int j = 0; j < kMaxE; ++j) {
      const int c = threadIdx.x + j * kCtaThreads;
      if (c < ce) dst[c] = acc[j];
    }
  }
}

// nv: the row's vectors of V bytes. A lane group of 2^g_log2 lanes sums a
// row; 32 >> g_log2 groups share a warp. A lane owns vectors c0 + q·G + gl
// (q < VPL) of a pass; wider rows take further passes over the row.
template <typename T, int V, int VPL>
__global__ void __launch_bounds__(kCtaThreads, kCtasPerSm)
    segment_sum_kernel(const T* __restrict__ data, const uint8_t* __restrict__ mask,
                       const int32_t* __restrict__ ptr, const int32_t* __restrict__ real_rows,
                       long long n_edges, long long n_rows, int w, int g_log2, float* __restrict__ out) {
  constexpr int EPV = V / (int)sizeof(T);
  constexpr int U = VPL * EPV <= 4 ? 8 : 4;
  __shared__ __align__(16) unsigned char ring[kStages][kStageBytes];
  __shared__ uint8_t ring_mask[kStages][kTileEdges];
  __shared__ int long_rows[kCtaThreads];
  __shared__ int n_long;

  const int warp = threadIdx.x >> 5;
  const int lane = threadIdx.x & 31;
  const int G = 1 << g_log2;
  const int groups = kWarps * (32 >> g_log2);  // rows a tile
  const int grp = warp * (32 >> g_log2) + (lane >> g_log2);
  const int gl = lane & (G - 1);
  const size_t row_bytes = (size_t)w * sizeof(T);
  const int nv = (int)(row_bytes / V);
  const char* db = reinterpret_cast<const char*>(data);
  const long long bound = edge_bound(real_rows, n_edges);
  const long long tiles = (n_rows + groups - 1) / groups;

  for (long long tile = blockIdx.x; tile < tiles; tile += gridDim.x) {
    if (threadIdx.x == 0) n_long = 0;
    __syncthreads();
    const long long row = tile * groups + grp;
    long long lo = 0, hi = 0;
    if (row < n_rows) {
      hi = ptr[row + 1];
      hi = hi < 0 ? 0 : (hi < bound ? hi : bound);
      lo = ptr[row];
      lo = lo < 0 ? 0 : (lo < hi ? lo : hi);
    }
    if (row < n_rows && hi - lo > kLong) {
      if (gl == 0) long_rows[atomicAdd(&n_long, 1)] = grp;
    } else if (row < n_rows) {
      for (int c0 = 0; c0 < nv; c0 += G * VPL) {
        float acc[VPL][EPV];
#pragma unroll
        for (int q = 0; q < VPL; ++q)
#pragma unroll
          for (int i = 0; i < EPV; ++i) acc[q][i] = 0.f;
        for (long long e = lo; e < hi; e += U) {
          bool live[U];
#pragma unroll
          for (int u = 0; u < U; ++u) live[u] = e + u < hi && (mask == nullptr || mask[e + u]);
          float v[U][VPL][EPV];
#pragma unroll
          for (int u = 0; u < U; ++u)
#pragma unroll
            for (int q = 0; q < VPL; ++q) {
              const int col = c0 + q * G + gl;
#pragma unroll
              for (int i = 0; i < EPV; ++i) v[u][q][i] = 0.f;
              if (live[u] && col < nv) load_vec<T, V>(db + (size_t)(e + u) * row_bytes + (size_t)col * V, v[u][q]);
            }
#pragma unroll
          for (int u = 0; u < U; ++u) {
            if (!live[u]) continue;
#pragma unroll
            for (int q = 0; q < VPL; ++q)
#pragma unroll
              for (int i = 0; i < EPV; ++i) acc[q][i] = __fadd_rn(acc[q][i], v[u][q][i]);
          }
        }
#pragma unroll
        for (int q = 0; q < VPL; ++q) {
          const int col = c0 + q * G + gl;
          if (col < nv) store_f32<EPV>(out + (size_t)row * w + (size_t)col * EPV, acc[q]);
        }
      }
    }
    __syncthreads();
    const int nl = n_long;  // the same in every thread
    for (int k = 0; k < nl; ++k) {
      const long long r = tile * groups + long_rows[k];
      long long rhi = ptr[r + 1];
      rhi = rhi < bound ? rhi : bound;
      const long long rlo = ptr[r];
      long_row<T, V>(data, mask, r, rlo < 0 ? 0 : rlo, rhi, w, nv, ring, ring_mask, out);
    }
  }
}

template <typename T, int V>
int launch_v(const void* data, const void* mask, const void* row_ptr, const void* real_rows,
             long long n_edges, long long n_rows, int w, void* out, cudaStream_t stream) {
  if constexpr (V < (int)sizeof(T)) {
    return (int)cudaErrorInvalidValue;
  } else {
    const int nv = (int)((long long)w * sizeof(T) / V);
    const int g_log2 = nv >= 32 ? 5 : lanes_log2(nv);
    const long long groups = (long long)kWarps * (32 >> g_log2);
    const long long tiles = (n_rows + groups - 1) / groups;
    const long long cap = (long long)sm_count() * kCtasPerSm;
    const unsigned grid = (unsigned)(tiles < cap ? tiles : cap);
    const T* d = (const T*)data;
    const uint8_t* m = (const uint8_t*)mask;
    const int32_t* p = (const int32_t*)row_ptr;
    const int32_t* b = (const int32_t*)real_rows;
    if (nv <= 32)
      segment_sum_kernel<T, V, 1><<<grid, kCtaThreads, 0, stream>>>(d, m, p, b, n_edges, n_rows, w, g_log2,
                                                                     (float*)out);
    else
      segment_sum_kernel<T, V, 2><<<grid, kCtaThreads, 0, stream>>>(d, m, p, b, n_edges, n_rows, w, g_log2,
                                                                     (float*)out);
    return (int)cudaGetLastError();
  }
}

template <typename T>
int launch(const void* data, const void* ids, const void* mask, const void* real_rows, long long n_edges,
           long long n_rows, int w, void* row_ptr, void* out, cudaStream_t stream) {
  launch_row_ptr(ids, n_edges, n_rows, row_ptr, stream);
  switch (row_vector_bytes((long long)w * sizeof(T), (uintptr_t)data, (int)sizeof(T))) {
    case 16:
      return launch_v<T, 16>(data, mask, row_ptr, real_rows, n_edges, n_rows, w, out, stream);
    case 8:
      return launch_v<T, 8>(data, mask, row_ptr, real_rows, n_edges, n_rows, w, out, stream);
    case 4:
      return launch_v<T, 4>(data, mask, row_ptr, real_rows, n_edges, n_rows, w, out, stream);
    default:
      return launch_v<T, 2>(data, mask, row_ptr, real_rows, n_edges, n_rows, w, out, stream);
  }
}

}  // namespace

// dtype: 0 = float32, 1 = bfloat16. mask may be null (every edge counts);
// real_rows may be null (the walk's bound is n_edges), else one int32 on
// the device. row_ptr: n_rows + 1 int32 of scratch (its contents are not
// read). Returns cudaGetLastError() after the launches (0 = success).
extern "C" int hg_segment_sum(const void* data, int dtype, const void* ids, const void* mask,
                              const void* real_rows, long long n_edges, long long n_rows, int w,
                              void* row_ptr, void* out, void* stream) {
  if (n_rows <= 0 || w <= 0 || n_edges < 0) return (int)cudaErrorInvalidValue;
  cudaStream_t s = (cudaStream_t)stream;
  if (dtype == 0)
    return launch<float>(data, ids, mask, real_rows, n_edges, n_rows, w, row_ptr, out, s);
  if (dtype == 1)
    return launch<__nv_bfloat16>(data, ids, mask, real_rows, n_edges, n_rows, w, row_ptr, out, s);
  return (int)cudaErrorInvalidValue;
}
