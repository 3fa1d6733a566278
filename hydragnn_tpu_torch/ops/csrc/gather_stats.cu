// gather_stats.cu — the fused gather and K-group statistics (B1) and its
// backward for Hopper (sm_90a).
//
// Forward. Replaces hydragnn_tpu/ops/segment_pallas.py:_gather_stats_kernel
// (reached through _gather_stats_call and gather_presum_stats). With
// v = table[ids], m = mask, and the edge slots cut into groups of K
// consecutive slots (g = e / K), it gives, per group g and column f:
//
//   stats[g, f]      = Σ m·v[e, f]             float32, in slot order
//   stats[g, H + f]  = Σ m·v[e, f]²            float32, in slot order
//   both[g, f]       = max (m ? v[e, f] : lowest)    in the table's type
//   both[g, H + f]   = max (m ? -v[e, f] : lowest)   in the table's type
//
// where lowest is the type's lowest finite value. An all-masked group keeps
// `lowest` in both halves: it is NOT cleaned to 0 here (unlike
// pna_aggregate.cu). The clean happens after the E/K segment max
// (graph/segment.py:segment_max, models/convs.py), exactly as in the JAX
// package. A masked slot, or one whose id is out of range, never reads the
// table and counts as masked. NaN is sticky in the maxima.
//
// Backward. Replaces the regather (gather_rows_local_fast) and the block
// of elementwise operations of segment_pallas.py:_gather_presum_bwd; the
// JAX package has no Pallas kernel there (XLA fuses the block into one
// pass on the TPU). It forms grad_v [E, H], in the table's type, which
// segment_sum_local.cu (B4) then scatters into the table:
//
//   tie_x = (m ? v : lowest) == both[g, f]      counted per group: c_x
//   tie_n = (m ? -v : lowest) == both[g, H + f]  counted per group: c_n
//   share_x = T(g_both[g, f] / max(T(c_x), 1))   divided in float32
//   share_n = T(g_both[g, H + f] / max(T(c_n), 1))
//   grad_v = m ? T(g_s + (2·v)·g_sq + tie_x·share_x − tie_n·share_n) : +0
//
// with g_s = g_stats[g, f], g_sq = g_stats[g, H + f], each operation in
// float32 in that order (__fmul_rn / __fadd_rn / __fsub_rn / __fdiv_rn,
// never contracted): the plain chain's order, ops/gather_stats.py:
// gather_presum_bwd_plain, which it equals bit for bit in float32 and
// bfloat16 (T() rounds to the table's type, the identity for float32).
//
// What bounds them on this card: bytes. The forward's least time is
// (E·4 + E·1 + N·H·sizeof(T) + (E/K)·2H·4 + (E/K)·2H·sizeof(T)) / 3.35
// TB/s; the backward's adds the three [E/K, 2H] inputs and the [E, H]
// output. The gathered rows come from L2 (the table is 16.8 MB at the
// flagship's training batch); the [E, H] gather v is never written to
// device memory.
//
// What the design does about it (fused_conv.cu's warp walk):
//   - At H >= 32 one warp owns a K-group. Lanes 0..K-1 load the group's
//     ids and mask once and __shfl_sync them out; each lane owns a vector
//     of columns, the widest row_vector_bytes allows (16 bytes at H = 128
//     float32), issues the group's row loads (8 at a time) before it adds
//     any, and stores 16-byte vectors.
//   - Below H = 32 a thread owns a (group, column); narrow tables (conv_0,
//     H = 1) pack many groups per warp and load the K ids as vectors.
//   - K = 8, the run alignment the loader emits, is a compile-time
//     parameter: the backward keeps the group's 8 rows in registers and
//     walks them once. Any other K takes the runtime-K kernels of the same
//     design (the backward walks the group twice: counts, then grads).
//   - One owner per output element adds in slot order: two launches are
//     bitwise equal (no atomics), and the sums equal the plain sequential
//     float32 sums.

#include "common.cuh"

namespace {

constexpr int kSlots = 8;  // the row loads in flight a lane

// The ids of slots [e, e + kSlots) of a group (those below `left`), or -1
// where the slot is masked, out of range or past the group. With `vec`
// (K = 8; ids 16-byte and mask 8-byte aligned) as two int4 and one uint2
// loads.
__device__ __forceinline__ void slot_ids(const int32_t* __restrict__ ids,
                                         const uint8_t* __restrict__ mask, long long e, int left,
                                         long long n_rows, bool vec, int (&src)[kSlots]) {
  int id[kSlots];
  uint8_t mk[kSlots];
  if (vec) {
    const int4 a = *reinterpret_cast<const int4*>(ids + e);
    const int4 b = *reinterpret_cast<const int4*>(ids + e + 4);
    const uint2 m = *reinterpret_cast<const uint2*>(mask + e);
    id[0] = a.x, id[1] = a.y, id[2] = a.z, id[3] = a.w;
    id[4] = b.x, id[5] = b.y, id[6] = b.z, id[7] = b.w;
#pragma unroll
    for (int u = 0; u < 4; ++u) mk[u] = (m.x >> (8 * u)) & 0xff, mk[4 + u] = (m.y >> (8 * u)) & 0xff;
  } else {
#pragma unroll
    for (int u = 0; u < kSlots; ++u) {
      mk[u] = u < left ? mask[e + u] : 0;
      id[u] = u < left ? ids[e + u] : -1;
    }
  }
#pragma unroll
  for (int u = 0; u < kSlots; ++u)
    src[u] = (u < left && mk[u] && id[u] >= 0 && (long long)id[u] < n_rows) ? id[u] : -1;
}

// One slot's contribution to a group's statistics (x ignored when !live).
__device__ __forceinline__ void add_slot(bool live, float x, float lowest, float& s, float& sq,
                                         float& mx, float& mn) {
  float xv = lowest, nxv = lowest;
  if (live) {
    xv = x;
    nxv = -x;
    s = __fadd_rn(s, x);
    sq = __fadd_rn(sq, __fmul_rn(x, x));
  }
  if (xv > mx || xv != xv) mx = xv;
  if (nxv > mn || nxv != nxv) mn = nxv;
}

// One slot's gradient (+0 when !live).
__device__ __forceinline__ float slot_grad(bool live, float v, float gs, float gq, bool tx,
                                           float sx, bool tn, float sn) {
  if (!live) return 0.f;
  float acc = __fadd_rn(gs, __fmul_rn(__fmul_rn(2.f, v), gq));
  acc = __fadd_rn(acc, __fmul_rn(tx ? 1.f : 0.f, sx));
  return __fsub_rn(acc, __fmul_rn(tn ? 1.f : 0.f, sn));
}

// A group's tie count rounded as the plain chain's sum in T, clamped at 1,
// and the share it divides out, rounded to T.
template <typename T>
__device__ __forceinline__ float share(float g, float count) {
  const float c = fmaxf(to_f32<T>(from_f32<T>(count)), 1.f);
  return to_f32<T>(from_f32<T>(__fdiv_rn(g, c)));
}

// Lane j's slot of a warp's chunk: the id of slot e, or -1 where the slot
// is masked or its id out of range.
__device__ __forceinline__ int lane_slot(const int32_t* __restrict__ ids,
                                         const uint8_t* __restrict__ mask, long long e,
                                         long long n_rows) {
  const int id = ids[e];
  return (mask[e] && id >= 0 && (long long)id < n_rows) ? id : -1;
}

// Slots [u0, u0 + kSlots) of a warp's chunk of `chunk` slots, lane j
// holding slot j's lane_slot in r: their ids src (-1 where masked, out of
// range or past the chunk) and this lane's vector of each row, every load
// issued before any is used.
template <typename T, int V>
__device__ __forceinline__ void warp_rows(int r, int u0, int chunk, const char* tb,
                                          size_t row_bytes, int col, bool live_col,
                                          int (&src)[kSlots], float (&x)[kSlots][V / sizeof(T)]) {
#pragma unroll
  for (int u = 0; u < kSlots; ++u) {
    src[u] = __shfl_sync(kFullWarp, r, u0 + u);
    if (u0 + u >= chunk) src[u] = -1;
  }
#pragma unroll
  for (int u = 0; u < kSlots; ++u) {
#pragma unroll
    for (int i = 0; i < V / (int)sizeof(T); ++i) x[u][i] = 0.f;
    if (src[u] >= 0 && live_col) load_vec<T, V>(tb + (size_t)src[u] * row_bytes + (size_t)col * V, x[u]);
  }
}

// ---- forward ----------------------------------------------------------

template <typename T, int V, int KC>
__global__ void __launch_bounds__(kThreads)
    gather_stats_warp_kernel(const T* __restrict__ table, const int32_t* __restrict__ ids,
                             const uint8_t* __restrict__ mask, long long n_groups, long long n_rows,
                             int h, int k_arg, int nv, float lowest, float* __restrict__ stats,
                             T* __restrict__ both) {
  constexpr int EPV = V / (int)sizeof(T);
  const int k = KC > 0 ? KC : k_arg;
  const int lane = threadIdx.x & 31;
  const long long g = (long long)blockIdx.x * (blockDim.x >> 5) + (threadIdx.x >> 5);
  if (g >= n_groups) return;  // the whole warp
  const long long e0 = g * k;
  const size_t row_bytes = (size_t)h * sizeof(T);
  const char* tb = reinterpret_cast<const char*>(table);
  for (int c0 = 0; c0 < nv; c0 += 32) {
    const int col = c0 + lane;
    const bool live_col = col < nv;
    float s[EPV], sq[EPV], mx[EPV], mn[EPV];
#pragma unroll
    for (int i = 0; i < EPV; ++i) s[i] = sq[i] = 0.f, mx[i] = mn[i] = -INFINITY;
    for (int base = 0; base < k; base += 32) {
      const int chunk = k - base < 32 ? k - base : 32;
      const int r = lane < chunk ? lane_slot(ids, mask, e0 + base + lane, n_rows) : -1;
      for (int u0 = 0; u0 < chunk; u0 += kSlots) {
        int src[kSlots];
        float x[kSlots][EPV];
        warp_rows<T, V>(r, u0, chunk, tb, row_bytes, col, live_col, src, x);
#pragma unroll
        for (int u = 0; u < kSlots; ++u) {
          if (u0 + u >= chunk) break;
#pragma unroll
          for (int i = 0; i < EPV; ++i) add_slot(src[u] >= 0, x[u][i], lowest, s[i], sq[i], mx[i], mn[i]);
        }
      }
    }
    if (!live_col) continue;
    float* st = stats + (size_t)g * 2 * h + (size_t)col * EPV;
    store_f32<EPV>(st, s);
    store_f32<EPV>(st + h, sq);
    char* bo = reinterpret_cast<char*>(both) + (size_t)g * 2 * row_bytes + (size_t)col * V;
    store_vec<T, V>(bo, mx);
    store_vec<T, V>(bo + row_bytes, mn);
  }
}

template <typename T, int KC>
__global__ void __launch_bounds__(kThreads)
    gather_stats_narrow_kernel(const T* __restrict__ table, const int32_t* __restrict__ ids,
                               const uint8_t* __restrict__ mask, long long n_groups,
                               long long n_rows, int h, int k_arg, int lpr_log2, bool vec_ids,
                               float lowest, float* __restrict__ stats, T* __restrict__ both) {
  const int k = KC > 0 ? KC : k_arg;
  const int f = threadIdx.x & ((1 << lpr_log2) - 1);
  const long long g = (long long)blockIdx.x * (blockDim.x >> lpr_log2) + (threadIdx.x >> lpr_log2);
  if (g >= n_groups || f >= h) return;
  const long long e0 = g * k;
  float s = 0.f, sq = 0.f, mx = -INFINITY, mn = -INFINITY;
  for (int base = 0; base < k; base += kSlots) {
    int src[kSlots];
    slot_ids(ids, mask, e0 + base, k - base, n_rows, KC == kSlots && vec_ids, src);
    float x[kSlots];
#pragma unroll
    for (int u = 0; u < kSlots; ++u) x[u] = src[u] >= 0 ? to_f32<T>(table[(size_t)src[u] * h + f]) : 0.f;
#pragma unroll
    for (int u = 0; u < kSlots; ++u) {
      if (base + u >= k) break;
      add_slot(src[u] >= 0, x[u], lowest, s, sq, mx, mn);
    }
  }
  const size_t o = (size_t)g * 2 * h + f;
  stats[o] = s;
  stats[o + h] = sq;
  both[o] = from_f32<T>(mx);
  both[o + h] = from_f32<T>(mn);
}

// ---- backward ---------------------------------------------------------

template <typename T, int V, int KC>
__global__ void __launch_bounds__(kThreads)
    gather_stats_bwd_warp_kernel(const T* __restrict__ table, const int32_t* __restrict__ ids,
                                 const uint8_t* __restrict__ mask, const T* __restrict__ both,
                                 const float* __restrict__ g_stats, const T* __restrict__ g_both,
                                 long long n_groups, long long n_rows, int h, int k_arg, int nv,
                                 float lowest, T* __restrict__ grad_v) {
  constexpr int EPV = V / (int)sizeof(T);
  static_assert(KC == 0 || KC == kSlots, "the one-pass walk holds kSlots rows");
  const int k = KC > 0 ? KC : k_arg;
  const int lane = threadIdx.x & 31;
  const long long g = (long long)blockIdx.x * (blockDim.x >> 5) + (threadIdx.x >> 5);
  if (g >= n_groups) return;  // the whole warp
  const long long e0 = g * k;
  const size_t row_bytes = (size_t)h * sizeof(T);
  const char* tb = reinterpret_cast<const char*>(table);
  char* ob = reinterpret_cast<char*>(grad_v);
  // K = 8: one pass over the group's rows, held in registers; otherwise
  // two (the tie counts, then the gradients)
  const int passes = KC == kSlots ? 1 : 2;
  for (int c0 = 0; c0 < nv; c0 += 32) {
    const int col = c0 + lane;
    const bool live_col = col < nv;
    // the group's rows of both, g_stats and g_both, read once
    float bx[EPV], bn[EPV], gs[EPV], gq[EPV], sx[EPV], sn[EPV], cx[EPV], cn[EPV];
#pragma unroll
    for (int i = 0; i < EPV; ++i) bx[i] = bn[i] = gs[i] = gq[i] = sx[i] = sn[i] = cx[i] = cn[i] = 0.f;
    if (live_col) {
      const size_t ro = (size_t)g * 2 * row_bytes + (size_t)col * V;
      load_vec<T, V>(reinterpret_cast<const char*>(both) + ro, bx);
      load_vec<T, V>(reinterpret_cast<const char*>(both) + ro + row_bytes, bn);
      load_vec<T, V>(reinterpret_cast<const char*>(g_both) + ro, sx);
      load_vec<T, V>(reinterpret_cast<const char*>(g_both) + ro + row_bytes, sn);
      const float* gp = g_stats + (size_t)g * 2 * h + (size_t)col * EPV;
      load_f32<EPV>(gp, gs);
      load_f32<EPV>(gp + h, gq);
    }
    for (int pass = 0; pass < passes; ++pass) {
      for (int base = 0; base < k; base += 32) {
        const int chunk = k - base < 32 ? k - base : 32;
        const int r = lane < chunk ? lane_slot(ids, mask, e0 + base + lane, n_rows) : -1;
        for (int u0 = 0; u0 < chunk; u0 += kSlots) {
          int src[kSlots];
          float x[kSlots][EPV];
          warp_rows<T, V>(r, u0, chunk, tb, row_bytes, col, live_col, src, x);
          if (pass == 0) {
#pragma unroll
            for (int u = 0; u < kSlots; ++u) {
              if (u0 + u >= chunk) break;
#pragma unroll
              for (int i = 0; i < EPV; ++i) {
                cx[i] += (src[u] >= 0 ? x[u][i] : lowest) == bx[i] ? 1.f : 0.f;
                cn[i] += (src[u] >= 0 ? -x[u][i] : lowest) == bn[i] ? 1.f : 0.f;
              }
            }
          }
          if (pass + 1 < passes) continue;
          if (passes == 1) {  // the group's one chunk is counted: divide
#pragma unroll
            for (int i = 0; i < EPV; ++i) sx[i] = share<T>(sx[i], cx[i]), sn[i] = share<T>(sn[i], cn[i]);
          }
#pragma unroll
          for (int u = 0; u < kSlots; ++u) {
            if (u0 + u >= chunk) break;
            const bool live = src[u] >= 0;
            float out[EPV];
#pragma unroll
            for (int i = 0; i < EPV; ++i) {
              const float v = x[u][i];
              out[i] = slot_grad(live, v, gs[i], gq[i], (live ? v : lowest) == bx[i], sx[i],
                                 (live ? -v : lowest) == bn[i], sn[i]);
            }
            if (live_col) store_vec<T, V>(ob + (size_t)(e0 + base + u0 + u) * row_bytes + (size_t)col * V, out);
          }
        }
      }
      if (pass == 0 && passes == 2) {
#pragma unroll
        for (int i = 0; i < EPV; ++i) sx[i] = share<T>(sx[i], cx[i]), sn[i] = share<T>(sn[i], cn[i]);
      }
    }
  }
}

template <typename T, int KC>
__global__ void __launch_bounds__(kThreads)
    gather_stats_bwd_narrow_kernel(const T* __restrict__ table, const int32_t* __restrict__ ids,
                                   const uint8_t* __restrict__ mask, const T* __restrict__ both,
                                   const float* __restrict__ g_stats,
                                   const T* __restrict__ g_both, long long n_groups,
                                   long long n_rows, int h, int k_arg, int lpr_log2, bool vec_ids,
                                   float lowest, T* __restrict__ grad_v) {
  const int k = KC > 0 ? KC : k_arg;
  const int f = threadIdx.x & ((1 << lpr_log2) - 1);
  const long long g = (long long)blockIdx.x * (blockDim.x >> lpr_log2) + (threadIdx.x >> lpr_log2);
  if (g >= n_groups || f >= h) return;
  const long long e0 = g * k;
  const size_t o = (size_t)g * 2 * h + f;
  const float bx = to_f32<T>(both[o]), bn = to_f32<T>(both[o + h]);
  const float gs = g_stats[o], gq = g_stats[o + h];
  float sx = to_f32<T>(g_both[o]), sn = to_f32<T>(g_both[o + h]);
  float cx = 0.f, cn = 0.f;
  // KC = 8: one pass over the group's rows, held in registers; otherwise
  // two (the tie counts, then the gradients)
  const int passes = KC == kSlots ? 1 : 2;
  for (int pass = 0; pass < passes; ++pass) {
    if (pass == 1) sx = share<T>(sx, cx), sn = share<T>(sn, cn);
    for (int base = 0; base < k; base += kSlots) {
      int src[kSlots];
      slot_ids(ids, mask, e0 + base, k - base, n_rows, KC == kSlots && vec_ids, src);
      float x[kSlots];
#pragma unroll
      for (int u = 0; u < kSlots; ++u) x[u] = src[u] >= 0 ? to_f32<T>(table[(size_t)src[u] * h + f]) : 0.f;
      bool tx[kSlots], tn[kSlots];
#pragma unroll
      for (int u = 0; u < kSlots; ++u) {
        tx[u] = (src[u] >= 0 ? x[u] : lowest) == bx;
        tn[u] = (src[u] >= 0 ? -x[u] : lowest) == bn;
        if (pass == 0 && base + u < k) cx += tx[u] ? 1.f : 0.f, cn += tn[u] ? 1.f : 0.f;
      }
      if (passes == 2 && pass == 0) continue;
      if (passes == 1) sx = share<T>(sx, cx), sn = share<T>(sn, cn);
#pragma unroll
      for (int u = 0; u < kSlots; ++u) {
        if (base + u >= k) break;
        grad_v[(size_t)(e0 + base + u) * h + f] =
            from_f32<T>(slot_grad(src[u] >= 0, x[u], gs, gq, tx[u], sx, tn[u], sn));
      }
    }
  }
}

// ---- launchers --------------------------------------------------------

inline bool ids_vectors_ok(const void* ids, const void* mask) {
  return (uintptr_t)ids % 16 == 0 && (uintptr_t)mask % 8 == 0;
}

template <typename T, int V>
int launch_fwd_warp(const void* table, const void* ids, const void* mask, long long n_groups,
                    long long n_rows, int h, int k, float lowest, void* stats, void* both,
                    cudaStream_t stream) {
  if constexpr (V < (int)sizeof(T)) {
    return (int)cudaErrorInvalidValue;
  } else {
    const int nv = (int)((long long)h * sizeof(T) / V);
    const long long blocks = (n_groups + (kThreads / 32) - 1) / (kThreads / 32);
    auto kern = k == kSlots ? gather_stats_warp_kernel<T, V, kSlots> : gather_stats_warp_kernel<T, V, 0>;
    kern<<<(unsigned)blocks, kThreads, 0, stream>>>((const T*)table, (const int32_t*)ids,
                                                    (const uint8_t*)mask, n_groups, n_rows, h, k,
                                                    nv, lowest, (float*)stats, (T*)both);
    return (int)cudaGetLastError();
  }
}

template <typename T>
int launch_fwd(const void* table, const void* ids, const void* mask, long long n_groups,
               long long n_rows, int h, int k, float lowest, void* stats, void* both,
               cudaStream_t stream) {
  if (h >= 32) {
    switch (row_vector_bytes((long long)h * sizeof(T), (uintptr_t)table, (int)sizeof(T))) {
      case 16:
        return launch_fwd_warp<T, 16>(table, ids, mask, n_groups, n_rows, h, k, lowest, stats, both, stream);
      case 8:
        return launch_fwd_warp<T, 8>(table, ids, mask, n_groups, n_rows, h, k, lowest, stats, both, stream);
      case 4:
        return launch_fwd_warp<T, 4>(table, ids, mask, n_groups, n_rows, h, k, lowest, stats, both, stream);
      case 2:
        return launch_fwd_warp<T, 2>(table, ids, mask, n_groups, n_rows, h, k, lowest, stats, both, stream);
      default:
        return (int)cudaErrorMisalignedAddress;
    }
  }
  const int lpr_log2 = lanes_log2(h);
  const long long blocks = (n_groups + (kThreads >> lpr_log2) - 1) / (kThreads >> lpr_log2);
  auto kern = k == kSlots ? gather_stats_narrow_kernel<T, kSlots> : gather_stats_narrow_kernel<T, 0>;
  kern<<<(unsigned)blocks, kThreads, 0, stream>>>((const T*)table, (const int32_t*)ids,
                                                  (const uint8_t*)mask, n_groups, n_rows, h, k,
                                                  lpr_log2, ids_vectors_ok(ids, mask), lowest,
                                                  (float*)stats, (T*)both);
  return (int)cudaGetLastError();
}

template <typename T, int V>
int launch_bwd_warp(const void* table, const void* ids, const void* mask, const void* both,
                    const void* g_stats, const void* g_both, long long n_groups, long long n_rows,
                    int h, int k, float lowest, void* grad_v, cudaStream_t stream) {
  if constexpr (V < (int)sizeof(T)) {
    return (int)cudaErrorInvalidValue;
  } else {
    const int nv = (int)((long long)h * sizeof(T) / V);
    const long long blocks = (n_groups + (kThreads / 32) - 1) / (kThreads / 32);
    auto kern = k == kSlots ? gather_stats_bwd_warp_kernel<T, V, kSlots>
                            : gather_stats_bwd_warp_kernel<T, V, 0>;
    kern<<<(unsigned)blocks, kThreads, 0, stream>>>(
        (const T*)table, (const int32_t*)ids, (const uint8_t*)mask, (const T*)both,
        (const float*)g_stats, (const T*)g_both, n_groups, n_rows, h, k, nv, lowest, (T*)grad_v);
    return (int)cudaGetLastError();
  }
}

template <typename T>
int launch_bwd(const void* table, const void* ids, const void* mask, const void* both,
               const void* g_stats, const void* g_both, long long n_groups, long long n_rows,
               int h, int k, float lowest, void* grad_v, cudaStream_t stream) {
  if (h >= 32) {
    const uintptr_t align = (uintptr_t)table | (uintptr_t)both | (uintptr_t)g_both | (uintptr_t)grad_v;
    int v = row_vector_bytes((long long)h * sizeof(T), align, (int)sizeof(T));
    // g_stats [E/K, 2H] float32: a lane reads V / sizeof(T) floats of it
    while (v > (int)sizeof(T)) {
      const int epv = v / (int)sizeof(T);
      if ((uintptr_t)g_stats % (uintptr_t)(4 * (epv < 4 ? epv : 4)) == 0) break;
      v >>= 1;
    }
    switch (v) {
      case 16:
        return launch_bwd_warp<T, 16>(table, ids, mask, both, g_stats, g_both, n_groups, n_rows, h, k,
                                      lowest, grad_v, stream);
      case 8:
        return launch_bwd_warp<T, 8>(table, ids, mask, both, g_stats, g_both, n_groups, n_rows, h, k,
                                     lowest, grad_v, stream);
      case 4:
        return launch_bwd_warp<T, 4>(table, ids, mask, both, g_stats, g_both, n_groups, n_rows, h, k,
                                     lowest, grad_v, stream);
      case 2:
        return launch_bwd_warp<T, 2>(table, ids, mask, both, g_stats, g_both, n_groups, n_rows, h, k,
                                     lowest, grad_v, stream);
      default:
        return (int)cudaErrorMisalignedAddress;
    }
  }
  const int lpr_log2 = lanes_log2(h);
  const long long blocks = (n_groups + (kThreads >> lpr_log2) - 1) / (kThreads >> lpr_log2);
  auto kern = k == kSlots ? gather_stats_bwd_narrow_kernel<T, kSlots> : gather_stats_bwd_narrow_kernel<T, 0>;
  kern<<<(unsigned)blocks, kThreads, 0, stream>>>(
      (const T*)table, (const int32_t*)ids, (const uint8_t*)mask, (const T*)both,
      (const float*)g_stats, (const T*)g_both, n_groups, n_rows, h, k, lpr_log2,
      ids_vectors_ok(ids, mask), lowest, (T*)grad_v);
  return (int)cudaGetLastError();
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
  if (dtype == 0)
    return launch_fwd<float>(table, ids, mask, n_groups, n_rows, h, k, lowest_of(0), stats, both, s);
  if (dtype == 1)
    return launch_fwd<__nv_bfloat16>(table, ids, mask, n_groups, n_rows, h, k, lowest_of(1), stats,
                                     both, s);
  return (int)cudaErrorInvalidValue;
}

// grad_v [n_groups * k, h] in the table's type from the forward's `both`
// [n_groups, 2h] (table's type) and the cotangents g_stats [n_groups, 2h]
// (float32) and g_both [n_groups, 2h] (table's type).
extern "C" int hg_gather_stats_bwd(const void* table, int dtype, const void* ids, const void* mask,
                                   const void* both, const void* g_stats, const void* g_both,
                                   long long n_groups, long long n_rows, int h, int k,
                                   void* grad_v, void* stream) {
  if (n_rows <= 0 || h <= 0 || k <= 0 || n_groups < 0) return (int)cudaErrorInvalidValue;
  if (n_groups == 0) return 0;
  cudaStream_t s = (cudaStream_t)stream;
  if (dtype == 0)
    return launch_bwd<float>(table, ids, mask, both, g_stats, g_both, n_groups, n_rows, h, k,
                             lowest_of(0), grad_v, s);
  if (dtype == 1)
    return launch_bwd<__nv_bfloat16>(table, ids, mask, both, g_stats, g_both, n_groups, n_rows, h,
                                     k, lowest_of(1), grad_v, s);
  return (int)cudaErrorInvalidValue;
}
