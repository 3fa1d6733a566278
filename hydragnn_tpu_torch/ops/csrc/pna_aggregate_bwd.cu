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
//       grad[e, c] = 0                                          otherwise
//
// T is v's type (float32 or bfloat16): the cotangent table and the shares
// are cast to it before use, as the reference casts them, and the sum is
// formed in float32 and cast once at the end, as its K2 does. Every
// compare runs in float32 on values of v's type, which is exact.
//
// An edge takes part when it is unmasked, lies below the bound and has a
// receiver in [0, N). Masked edges are skipped outright, never tested by
// value: the padding node's `both` is cleaned to 0 and a masked edge may
// carry v = 0. The optional bound (*real_edges, read on the device and
// clamped to [0, n_edges], common.cuh:edge_bound) is the caller's promise
// that every edge at or past it is masked (a batch's tail past its
// edge_occupancy): B6 never walks those edges, and B7 writes their zero
// gradient without reading them.
//
// What bounds them on this card: bytes. B6 reads v once and writes
// [N, 2H] float32 counts; B7 reads v and the node tables once and writes
// the [E, H] gradient. A handful of float operations per element, far
// below the H100's ~20 float32 operations per byte of its 3.35 TB/s.
//
// What the design does about it:
//   - B7 is edge-parallel, as the reference's K2 runs a grid over edge
//     chunks: grad[e] depends only on v[e] and on its receiver's node row.
//     A warp takes 32 consecutive edges, reads their receivers and mask
//     bytes with one coalesced load each, and hands them round by
//     __shfl_sync. Lanes run along 16-byte vectors of an edge row (4
//     elements a lane at most; a row under 32 vectors packs several edges
//     in a warp, one per slot of lanes), and each lane issues 8 edges' row
//     loads before it forms any of them. A lane keeps its receiver's node
//     values (g_sum, g_sumsq, both and the two shares, formed in the
//     thread) in registers and reloads them only when the receiver
//     changes: the receivers are sorted, so that is once a run. Edges that
//     take no part get a zero vector, and v is not read for them.
//   - B6 gives every row of at most kLongRow edges below the bound one
//     owner, which counts it alone, with no atomics: the common case. The
//     owner walks as B5's forward does (pna_aggregate.cu): a warp a row
//     with 16-byte vectors a lane, one coalesced mask load and a ballot
//     per 32 slots and 8 row loads in flight (the thread-per-column walk
//     of PR 4 issued one 4-byte load at a time); at H = 1 a group of 8
//     lanes a row (common.cuh:group_walk). A longer row gets zeros from
//     its owner, and a second kernel splits it over CTAs of kLongRow edges
//     each: the CTA's warps walk their share the same way and add their
//     nonzero counts to the zeros by atomicAdd. Counts are integers:
//     float32 sums of them are
//     exact below 2^24 in any order, so two launches stay bitwise equal.
//     No CTA walks more than kLongRow edges of a row, whatever its length.
//   - Arithmetic is written with __fmul_rn/__fadd_rn/__fsub_rn/__fdiv_rn so
//     the compiler does not contract it into fused multiply-adds; the
//     kernel then rounds where the plain PyTorch version rounds.
// The TPU mechanics of the original (K1's one-hot MXU matmul against node
// blocks, K2's windowed gather of a stacked [N, 6H] table, 128-lane
// padding) have no counterpart here.

#include "common.cuh"

namespace {

constexpr int kWarps = kThreads / 32;
// B6: rows of more edges than this (below the bound) are split over CTAs
constexpr int kLongRow = 1024;
// row loads a lane issues before it uses any
constexpr int kInFlight = 8;

// The bytes a lane loads of an edge row: the widest of 4 elements, 2 or 1
// that divides the row's bytes and every T pointer (`align_t`, their
// bitwise or) and whose float32 counterpart (4 bytes an element) divides
// every float32 table's address (`align_f32`).
inline int lane_vector_bytes(long long row_bytes, uintptr_t align_t, uintptr_t align_f32, int elem) {
  int v = 4 * elem;
  while (v > elem && (row_bytes % v != 0 || align_t % v != 0 || align_f32 % (v / elem * 4) != 0)) v >>= 1;
  return v;
}

// log2 of the lanes that hold one edge row: the power of two at or above
// its vector count, at most 32
inline int slot_log2(int nv) {
  int l = 0;
  while ((1 << l) < nv && l < 5) ++l;
  return l;
}

// ---- B6 ----------------------------------------------------------------

// The end of a row's walk by its owner: its end cut at the bound, and lo
// (no walk) for a row of more than kLongRow edges below the bound, whose
// counts pna_bwd_count_long_kernel adds to the zeros its owner writes.
__device__ __forceinline__ long long owned_end(long long lo, long long hi, const int32_t* real_edges,
                                               long long n_edges) {
  const long long bound = edge_bound(real_edges, n_edges);
  hi = hi < bound ? hi : bound;
  return (hi < lo || hi - lo > kLongRow) ? lo : hi;
}

// The warp's walk of slots [lo, hi) of one row, as B5's warp kernel walks
// a row (pna_aggregate.cu): lane `lane` owns the vectors c0 + p·32 + lane
// (p < VPL, below nv) of V bytes; one coalesced mask load and a
// __ballot_sync per 32 slots, U row loads in flight before any compare.
// Adds the ties with mx (of v) and mn (of -v) to cx and cn (a lane's
// vectors past nv compare zeros: their counts are not results).
template <typename T, int V, int VPL>
__device__ __forceinline__ void count_walk(const char* __restrict__ vb, const uint8_t* __restrict__ mask,
                                           long long lo, long long hi, size_t row_bytes, int c0, int nv,
                                           const float (&mx)[VPL][V / sizeof(T)],
                                           const float (&mn)[VPL][V / sizeof(T)], int (&cx)[VPL][V / sizeof(T)],
                                           int (&cn)[VPL][V / sizeof(T)]) {
  constexpr int EPV = V / (int)sizeof(T);
  constexpr int U = VPL * EPV <= 4 ? kInFlight : kInFlight / 2;
  const int lane = threadIdx.x & 31;
  for (long long base = lo; base < hi; base += 32) {
    const long long e = base + lane;
    unsigned live = __ballot_sync(kFullWarp, e < hi && (mask == nullptr || mask[e]));
    while (live) {
      int k[U];
#pragma unroll
      for (int u = 0; u < U; ++u) {
        k[u] = live ? __ffs(live) - 1 : -1;
        live &= live - 1u;
      }
      float x[U][VPL][EPV];
#pragma unroll
      for (int u = 0; u < U; ++u)
#pragma unroll
        for (int p = 0; p < VPL; ++p) {
          const int col = c0 + p * 32 + lane;
#pragma unroll
          for (int i = 0; i < EPV; ++i) x[u][p][i] = 0.f;
          if (k[u] >= 0 && col < nv)
            load_vec<T, V>(vb + (size_t)(base + k[u]) * row_bytes + (size_t)col * V, x[u][p]);
        }
#pragma unroll
      for (int u = 0; u < U; ++u) {
        if (k[u] < 0) continue;
#pragma unroll
        for (int p = 0; p < VPL; ++p)
#pragma unroll
          for (int i = 0; i < EPV; ++i) {
            cx[p][i] += (x[u][p][i] == mx[p][i]) ? 1 : 0;
            cn[p][i] += (-x[u][p][i] == mn[p][i]) ? 1 : 0;
          }
      }
    }
  }
}

// Row r's maxima for the lane's vectors c0 + p·32 + lane (0 past nv), and
// zeroed counts.
template <typename T, int V, int VPL>
__device__ __forceinline__ void count_start(const T* __restrict__ both, long long r, size_t row_bytes, int c0,
                                            int nv, float (&mx)[VPL][V / sizeof(T)],
                                            float (&mn)[VPL][V / sizeof(T)], int (&cx)[VPL][V / sizeof(T)],
                                            int (&cn)[VPL][V / sizeof(T)]) {
  const int lane = threadIdx.x & 31;
  const char* bb = reinterpret_cast<const char*>(both) + (size_t)r * 2 * row_bytes;
#pragma unroll
  for (int p = 0; p < VPL; ++p) {
    const int col = c0 + p * 32 + lane;
#pragma unroll
    for (int i = 0; i < (int)(V / sizeof(T)); ++i) mx[p][i] = mn[p][i] = 0.f, cx[p][i] = cn[p][i] = 0;
    if (col < nv) {
      load_vec<T, V>(bb + (size_t)col * V, mx[p]);
      load_vec<T, V>(bb + row_bytes + (size_t)col * V, mn[p]);
    }
  }
}

// The owner walk of rows of 2 columns or more: one warp a row
// (count_walk). The counts leave as float vectors.
template <typename T, int V, int VPL>
__global__ void __launch_bounds__(kThreads)
    pna_bwd_count_kernel(const T* __restrict__ v, const uint8_t* __restrict__ mask,
                         const int32_t* __restrict__ ptr, const int32_t* __restrict__ real_edges,
                         long long n_edges, long long n_rows, int h, int nv, const T* __restrict__ both,
                         float* __restrict__ cnt) {
  constexpr int EPV = V / (int)sizeof(T);
  const int lane = threadIdx.x & 31;
  const long long row = (long long)blockIdx.x * kWarps + (threadIdx.x >> 5);
  if (row >= n_rows) return;  // the whole warp
  const long long lo = ptr[row];
  const long long hi = owned_end(lo, ptr[row + 1], real_edges, n_edges);
  const size_t row_bytes = (size_t)h * sizeof(T);
  for (int c0 = 0; c0 < nv; c0 += 32 * VPL) {
    float mx[VPL][EPV], mn[VPL][EPV];
    int cx[VPL][EPV], cn[VPL][EPV];
    count_start<T, V, VPL>(both, row, row_bytes, c0, nv, mx, mn, cx, cn);
    count_walk<T, V, VPL>(reinterpret_cast<const char*>(v), mask, lo, hi, row_bytes, c0, nv, mx, mn, cx, cn);
#pragma unroll
    for (int p = 0; p < VPL; ++p) {
      const int col = c0 + p * 32 + lane;
      if (col >= nv) continue;
      float fx[EPV], fn[EPV];
#pragma unroll
      for (int i = 0; i < EPV; ++i) fx[i] = (float)cx[p][i], fn[i] = (float)cn[p][i];
      const size_t o = (size_t)row * 2 * h + (size_t)col * EPV;
      store_f32<EPV>(cnt + o, fx);
      store_f32<EPV>(cnt + o + h, fn);
    }
  }
}

// The owner walk of rows of one column (conv_0): common.cuh:group_walk, a
// group of 8 lanes a row, as B5's H = 1 kernel.
template <typename T>
__global__ void __launch_bounds__(kThreads)
    pna_bwd_count_h1_kernel(const T* __restrict__ v, const uint8_t* __restrict__ mask,
                            const int32_t* __restrict__ ptr, const int32_t* __restrict__ real_edges,
                            long long n_edges, long long n_rows, const T* __restrict__ both,
                            float* __restrict__ cnt) {
  const long long row = ((long long)blockIdx.x * kThreads + threadIdx.x) / kGroup;
  const bool own = row < n_rows;  // the warp's other rows still shuffle
  long long lo = 0, hi = 0;
  float mx = 0.f, mn = 0.f;
  if (own) {
    lo = ptr[row];
    hi = owned_end(lo, ptr[row + 1], real_edges, n_edges);
    mx = to_f32<T>(both[2 * row]);
    mn = to_f32<T>(both[2 * row + 1]);
  }
  int cx = 0, cn = 0;
  group_walk(
      lo, hi,
      [&](long long e, float& m) -> bool {
        if (e >= hi) return false;
        if (mask != nullptr && !mask[e]) return false;
        m = to_f32<T>(v[e]);
        return true;
      },
      [&](float x) {
        cx += (x == mx) ? 1 : 0;
        cn += (-x == mn) ? 1 : 0;
      });
  if (own && (threadIdx.x & (kGroup - 1)) == 0) {
    cnt[2 * row] = (float)cx;
    cnt[2 * row + 1] = (float)cn;
  }
}

// The long rows: CTA b takes edges [b·kLongRow, (b + 1)·kLongRow) below
// the bound. A row longer than kLongRow that meets the chunk contains its
// first or its last edge, so the receivers there are the only candidates.
// Each warp walks its eighth of the row's part of the chunk (count_walk)
// and adds its nonzero counts to the zeros the owner wrote.
template <typename T, int V>
__global__ void __launch_bounds__(kThreads)
    pna_bwd_count_long_kernel(const T* __restrict__ v, const uint8_t* __restrict__ mask,
                              const int32_t* __restrict__ recv, const int32_t* __restrict__ ptr,
                              const int32_t* __restrict__ real_edges, long long n_edges,
                              long long n_rows, int h, int nv, const T* __restrict__ both,
                              float* __restrict__ cnt) {
  constexpr int EPV = V / (int)sizeof(T);
  const int lane = threadIdx.x & 31;
  const int warp = threadIdx.x >> 5;
  const long long bound = edge_bound(real_edges, n_edges);
  const long long c_lo = (long long)blockIdx.x * kLongRow;
  if (c_lo >= bound) return;  // the whole CTA
  const long long c_hi = c_lo + kLongRow < bound ? c_lo + kLongRow : bound;
  const size_t row_bytes = (size_t)h * sizeof(T);
  const long long ends[2] = {recv[c_lo], recv[c_hi - 1]};
  for (int k = 0; k < 2; ++k) {
    const long long r = ends[k];
    if (k == 1 && r == ends[0]) break;
    if (r < 0 || r >= n_rows) continue;
    const long long lo = ptr[r];
    long long hi = ptr[r + 1];
    if (hi > bound) hi = bound;
    if (hi - lo <= kLongRow) continue;  // its owner counted it
    const long long a = lo > c_lo ? lo : c_lo;
    const long long b = hi < c_hi ? hi : c_hi;
    const long long share = (b - a + kWarps - 1) / kWarps;
    const long long w_lo = a + warp * share;
    const long long w_hi = w_lo + share < b ? w_lo + share : b;
    for (int c0 = 0; c0 < nv; c0 += 32) {
      float mx[1][EPV], mn[1][EPV];
      int cx[1][EPV], cn[1][EPV];
      count_start<T, V, 1>(both, r, row_bytes, c0, nv, mx, mn, cx, cn);
      count_walk<T, V, 1>(reinterpret_cast<const char*>(v), mask, w_lo, w_hi, row_bytes, c0, nv, mx, mn, cx, cn);
      if (c0 + lane >= nv) continue;  // an idle lane's counts are of zeros
      const size_t o = (size_t)r * 2 * h + (size_t)(c0 + lane) * EPV;
#pragma unroll
      for (int i = 0; i < EPV; ++i) {
        if (cx[0][i] != 0) atomicAdd(cnt + o + i, (float)cx[0][i]);
        if (cn[0][i] != 0) atomicAdd(cnt + o + h + i, (float)cn[0][i]);
      }
    }
  }
}

// ---- B7 ----------------------------------------------------------------

// A warp takes edges [32·w, 32·w + 32). Lanes form slots of 2^g_log2 lanes
// (one edge row a slot, lane `sub` of a slot owning the vectors
// c0 + sub); a round covers R = 32 >> g_log2 consecutive edges, one a
// slot, and the warp runs 2^g_log2 rounds, U of them at a time.
template <typename T, int V>
__global__ void __launch_bounds__(kThreads)
    pna_bwd_grad_kernel(const T* __restrict__ v, const uint8_t* __restrict__ mask,
                        const int32_t* __restrict__ recv, const int32_t* __restrict__ real_edges,
                        long long n_edges, long long n_rows, int h, int nv, int g_log2,
                        const float* __restrict__ g_sum, const float* __restrict__ g_sumsq,
                        const T* __restrict__ both, const T* __restrict__ g_both,
                        const float* __restrict__ cnt, T* __restrict__ grad) {
  constexpr int EPV = V / (int)sizeof(T);
  constexpr int U = kInFlight;
  const int lane = threadIdx.x & 31;
  const int G = 1 << g_log2;  // lanes a slot, and rounds a warp
  const int R = 32 >> g_log2;  // slots a warp, and edges a round
  const int slot = lane >> g_log2;
  const int sub = lane & (G - 1);
  const long long base = ((long long)blockIdx.x * kWarps + (threadIdx.x >> 5)) * 32;
  if (base >= n_edges) return;  // the whole warp
  const long long bound = edge_bound(real_edges, n_edges);
  const size_t row_bytes = (size_t)h * sizeof(T);
  const char* vb = reinterpret_cast<const char*>(v);
  char* gb = reinterpret_cast<char*>(grad);

  // the warp's 32 edges: lane l holds edge base + l's receiver, or -1
  // where that edge takes no part
  int r_lane = -1;
  {
    const long long e = base + lane;
    if (e < bound && (mask == nullptr || mask[e])) {
      const int r = recv[e];
      if (r >= 0 && r < n_rows) r_lane = r;
    }
  }
  for (int c0 = 0; c0 < nv; c0 += G) {
    const int col = c0 + sub;
    const bool on = col < nv;
    long long cur = -1;  // the receiver whose node values the lane holds
    float gs[EPV], gss[EPV], mx[EPV], mn[EPV], shx[EPV], shn[EPV];
    for (int q0 = 0; q0 < G; q0 += U) {
      int r[U];
      float x[U][EPV];
#pragma unroll
      for (int u = 0; u < U; ++u) {
        const int j = (q0 + u) * R + slot;  // below 32 for every round q0 + u < G
        r[u] = (q0 + u < G) ? __shfl_sync(kFullWarp, r_lane, j & 31) : -1;
#pragma unroll
        for (int i = 0; i < EPV; ++i) x[u][i] = 0.f;
        if (r[u] >= 0 && on) load_vec<T, V>(vb + (size_t)(base + j) * row_bytes + (size_t)col * V, x[u]);
      }
#pragma unroll
      for (int u = 0; u < U; ++u) {
        const long long e = base + (q0 + u) * R + slot;
        if (q0 + u >= G || e >= n_edges || !on) continue;
        float g[EPV];
        if (r[u] < 0) {
#pragma unroll
          for (int i = 0; i < EPV; ++i) g[i] = 0.f;
        } else {
          if (r[u] != cur) {
            cur = r[u];
            const size_t on_ = (size_t)cur * h + (size_t)col * EPV;
            const size_t ob = (size_t)cur * 2 * h + (size_t)col * EPV;
            float gbx[EPV], gbn[EPV], cx[EPV], cn[EPV];
            load_f32<EPV>(g_sum + on_, gs);
            load_f32<EPV>(g_sumsq + on_, gss);
            load_vec<T, V>(reinterpret_cast<const char*>(both + ob), mx);
            load_vec<T, V>(reinterpret_cast<const char*>(both + ob + h), mn);
            load_vec<T, V>(reinterpret_cast<const char*>(g_both + ob), gbx);
            load_vec<T, V>(reinterpret_cast<const char*>(g_both + ob + h), gbn);
            load_f32<EPV>(cnt + ob, cx);
            load_f32<EPV>(cnt + ob + h, cn);
#pragma unroll
            for (int i = 0; i < EPV; ++i) {
              gs[i] = to_f32<T>(from_f32<T>(gs[i]));
              gss[i] = to_f32<T>(from_f32<T>(gss[i]));
              shx[i] = to_f32<T>(from_f32<T>(__fdiv_rn(gbx[i], fmaxf(cx[i], 1.f))));
              shn[i] = to_f32<T>(from_f32<T>(__fdiv_rn(gbn[i], fmaxf(cn[i], 1.f))));
            }
          }
#pragma unroll
          for (int i = 0; i < EPV; ++i) {
            const float xi = x[u][i];
            float gi = __fadd_rn(gs[i], __fmul_rn(__fmul_rn(2.f, xi), gss[i]));
            gi = __fadd_rn(gi, (xi == mx[i]) ? shx[i] : 0.f);
            gi = __fsub_rn(gi, (-xi == mn[i]) ? shn[i] : 0.f);
            g[i] = gi;
          }
        }
        store_vec<T, V>(gb + (size_t)e * row_bytes + (size_t)col * V, g);
      }
    }
  }
}

// ---- launches ----------------------------------------------------------

template <typename T, int V>
int launch_count_v(const void* v, const void* mask, const void* recv, const void* row_ptr,
                   const void* real_edges, long long n_edges, long long n_rows, int h, const void* both,
                   void* cnt, cudaStream_t stream) {
  if constexpr (V < (int)sizeof(T)) {
    return (int)cudaErrorInvalidValue;
  } else {
    const int nv = (int)((long long)h * sizeof(T) / V);
    if (h == 1) {
      const long long rows_per_block = kThreads / kGroup;
      pna_bwd_count_h1_kernel<T><<<(unsigned)((n_rows + rows_per_block - 1) / rows_per_block), kThreads, 0,
                                   stream>>>((const T*)v, (const uint8_t*)mask, (const int32_t*)row_ptr,
                                             (const int32_t*)real_edges, n_edges, n_rows, (const T*)both,
                                             (float*)cnt);
    } else {
      const unsigned blocks = (unsigned)((n_rows + kWarps - 1) / kWarps);
      if (nv <= 32)
        pna_bwd_count_kernel<T, V, 1><<<blocks, kThreads, 0, stream>>>(
            (const T*)v, (const uint8_t*)mask, (const int32_t*)row_ptr, (const int32_t*)real_edges, n_edges,
            n_rows, h, nv, (const T*)both, (float*)cnt);
      else
        pna_bwd_count_kernel<T, V, 2><<<blocks, kThreads, 0, stream>>>(
            (const T*)v, (const uint8_t*)mask, (const int32_t*)row_ptr, (const int32_t*)real_edges, n_edges,
            n_rows, h, nv, (const T*)both, (float*)cnt);
    }
    const int rc = (int)cudaGetLastError();
    if (rc != 0 || n_edges == 0) return rc;
    const long long blocks = (n_edges + kLongRow - 1) / kLongRow;
    pna_bwd_count_long_kernel<T, V><<<(unsigned)blocks, kThreads, 0, stream>>>(
        (const T*)v, (const uint8_t*)mask, (const int32_t*)recv, (const int32_t*)row_ptr,
        (const int32_t*)real_edges, n_edges, n_rows, h, nv, (const T*)both, (float*)cnt);
    return (int)cudaGetLastError();
  }
}

template <typename T>
int launch_count(const void* v, const void* mask, const void* recv, const void* real_edges,
                 long long n_edges, long long n_rows, int h, const void* both, const void* row_ptr,
                 void* cnt, cudaStream_t stream) {
  // the counts leave as vectors of up to 4 floats: the wrapper's own
  // allocation, aligned far beyond that
  if ((uintptr_t)cnt % 16 != 0) return (int)cudaErrorMisalignedAddress;
  switch (lane_vector_bytes((long long)h * sizeof(T), (uintptr_t)v | (uintptr_t)both, 0, (int)sizeof(T))) {
    case 16:
      return launch_count_v<T, 16>(v, mask, recv, row_ptr, real_edges, n_edges, n_rows, h, both, cnt, stream);
    case 8:
      return launch_count_v<T, 8>(v, mask, recv, row_ptr, real_edges, n_edges, n_rows, h, both, cnt, stream);
    case 4:
      return launch_count_v<T, 4>(v, mask, recv, row_ptr, real_edges, n_edges, n_rows, h, both, cnt, stream);
    case 2:
      return launch_count_v<T, 2>(v, mask, recv, row_ptr, real_edges, n_edges, n_rows, h, both, cnt, stream);
    default:
      return (int)cudaErrorMisalignedAddress;
  }
}

template <typename T, int V>
int launch_grad_v(const void* v, const void* mask, const void* recv, const void* real_edges,
                  long long n_edges, long long n_rows, int h, const void* g_sum, const void* g_sumsq,
                  const void* both, const void* g_both, const void* cnt, void* grad, cudaStream_t stream) {
  if constexpr (V < (int)sizeof(T)) {
    return (int)cudaErrorInvalidValue;
  } else {
    const int nv = (int)((long long)h * sizeof(T) / V);
    const long long blocks = (n_edges + 32 * kWarps - 1) / (32 * kWarps);
    pna_bwd_grad_kernel<T, V><<<(unsigned)blocks, kThreads, 0, stream>>>(
        (const T*)v, (const uint8_t*)mask, (const int32_t*)recv, (const int32_t*)real_edges, n_edges,
        n_rows, h, nv, slot_log2(nv), (const float*)g_sum, (const float*)g_sumsq, (const T*)both,
        (const T*)g_both, (const float*)cnt, (T*)grad);
    return (int)cudaGetLastError();
  }
}

template <typename T>
int launch_grad(const void* v, const void* mask, const void* recv, const void* real_edges,
                long long n_edges, long long n_rows, int h, const void* g_sum, const void* g_sumsq,
                const void* both, const void* g_both, const void* cnt, void* grad, cudaStream_t stream) {
  if (n_edges == 0) return 0;
  const uintptr_t align_t = (uintptr_t)v | (uintptr_t)both | (uintptr_t)g_both | (uintptr_t)grad;
  const uintptr_t align_f32 = (uintptr_t)g_sum | (uintptr_t)g_sumsq | (uintptr_t)cnt;
  switch (lane_vector_bytes((long long)h * sizeof(T), align_t, align_f32, (int)sizeof(T))) {
    case 16:
      return launch_grad_v<T, 16>(v, mask, recv, real_edges, n_edges, n_rows, h, g_sum, g_sumsq, both, g_both,
                                  cnt, grad, stream);
    case 8:
      return launch_grad_v<T, 8>(v, mask, recv, real_edges, n_edges, n_rows, h, g_sum, g_sumsq, both, g_both,
                                 cnt, grad, stream);
    case 4:
      return launch_grad_v<T, 4>(v, mask, recv, real_edges, n_edges, n_rows, h, g_sum, g_sumsq, both, g_both,
                                 cnt, grad, stream);
    case 2:
      return launch_grad_v<T, 2>(v, mask, recv, real_edges, n_edges, n_rows, h, g_sum, g_sumsq, both, g_both,
                                 cnt, grad, stream);
    default:
      return (int)cudaErrorMisalignedAddress;
  }
}

}  // namespace

// B6. dtype: 0 = float32, 1 = bfloat16 (v and both). mask may be null
// (every edge valid). recv: the n_edges sorted int32 receivers; row_ptr:
// their n_rows + 1 CSR row pointers (ptr[r] = first edge whose receiver
// is >= r, as common.cuh:csr_row_ptr_kernel builds them). real_edges:
// null (no bound), or one int32 on the device. cnt: [n_rows, 2h] float32.
// Two launches (the owner walk, then the long rows). Returns
// cudaGetLastError() after them (0 = success).
extern "C" int hg_pna_bwd_count(const void* v, int dtype, const void* mask, const void* recv,
                                const void* real_edges, long long n_edges, long long n_rows, int h,
                                const void* both, const void* row_ptr, void* cnt, void* stream) {
  if (n_rows <= 0 || h <= 0 || n_edges < 0) return (int)cudaErrorInvalidValue;
  cudaStream_t s = (cudaStream_t)stream;
  if (dtype == 0)
    return launch_count<float>(v, mask, recv, real_edges, n_edges, n_rows, h, both, row_ptr, cnt, s);
  if (dtype == 1)
    return launch_count<__nv_bfloat16>(v, mask, recv, real_edges, n_edges, n_rows, h, both, row_ptr, cnt, s);
  return (int)cudaErrorInvalidValue;
}

// B7. v, both, g_both and grad in dtype; g_sum, g_sumsq [n_rows, h] and
// cnt [n_rows, 2h] float32. Same conventions as B6 (no row pointers: the
// walk is over edges); every one of the n_edges rows of grad is written.
extern "C" int hg_pna_bwd_grad(const void* v, int dtype, const void* mask, const void* recv,
                               const void* real_edges, long long n_edges, long long n_rows, int h,
                               const void* g_sum, const void* g_sumsq, const void* both,
                               const void* g_both, const void* cnt, void* grad, void* stream) {
  if (n_rows <= 0 || h <= 0 || n_edges < 0) return (int)cudaErrorInvalidValue;
  cudaStream_t s = (cudaStream_t)stream;
  if (dtype == 0)
    return launch_grad<float>(v, mask, recv, real_edges, n_edges, n_rows, h, g_sum, g_sumsq, both, g_both, cnt,
                              grad, s);
  if (dtype == 1)
    return launch_grad<__nv_bfloat16>(v, mask, recv, real_edges, n_edges, n_rows, h, g_sum, g_sumsq, both,
                                      g_both, cnt, grad, s);
  return (int)cudaErrorInvalidValue;
}
