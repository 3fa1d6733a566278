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
// at a padding node, and a masked value must not reach a maximum. An
// optional bound (*real_edges, read on the device and clamped to
// [0, n_edges], common.cuh:edge_bound) cuts every row's walk at it: the
// caller's promise that every edge at or past it is masked (a batch's
// tail past its edge_occupancy), so the outputs are the same bits with it
// and without it, and the tail is never scanned.
//
// What bounds it on this card: bytes. Each v element is read once and takes
// part in 2 adds, 1 multiply and 2 comparisons; even at H = 128 that is
// about one operation per byte read, far below the H100's ~20 float32
// operations per byte of its 3.35 TB/s. The least time is
// (E·H·sizeof(v) + E·1 + (N + 1)·4 + N·H·8 + N·4 + N·2H·sizeof(v)) / 3.35 TB/s,
// with E the bound where one is given.
//
// What the design does about it:
//   - v is read once, for all four statistics (the TPU read it twice: once
//     in the kernel, once in XLA's scatter-max).
//   - The CSR row pointers of the sorted receivers come in from the caller
//     (row_pointers.cu; the chassis builds them once per forward and B6 and
//     B7 walk the same ones), so a call is one launch.
//   - One warp per receiver row (a group of 8 lanes at H = 1). The warp
//     reads the row's mask 32 slots at a time with one coalesced load and
//     keeps the live slots by __ballot_sync; cnt is the sum of their
//     popcounts, with no serial loop.
//   - Rows of 2 columns or more: each lane owns a vector of columns (16
//     bytes at f32 H = 128, 8 at bf16 H = 128; common.cuh:row_vector_bytes
//     checks the row's bytes and every pointer) and issues U row loads (8,
//     or 4 for wide vectors) before it adds any of them, so a warp has U x
//     512 bytes of v in flight; sum, sumsq and both leave as vector stores.
//     Rows under 32 columns (on no shipped path) take one element a lane,
//     lanes past the row's width idle.
//   - Rows of one column (conv_0): common.cuh:group_walk, a group of 8
//     lanes per row and four rows a warp, each lane with four slots' loads
//     in flight and the values handed round by shuffle in edge order; the
//     flagship's 32,752 rows fit on the card at once.
//   - Every output element is formed by one lane in edge order with
//     __fadd_rn/__fmul_rn (never contracted into fused multiply-adds), so
//     two runs are bitwise equal and f32 equals the plain PyTorch version
//     (index_add_ and scatter_reduce on the host) bit for bit. NaN is
//     sticky in the maxima, as in the reference's max.
// The TPU mechanics of the original (one-hot MXU matmuls, the 3-term bf16
// split, 128-lane padding, double-buffered DMA) have no counterpart here.

#include "common.cuh"

namespace {

constexpr int kWarps = kThreads / 32;

// The four running statistics of one column, set by reset(). (With
// default member initializers instead, the warp kernel's [2][EPV] array
// of them started its second row's maxima at 0 on the card, CUDA 12.8:
// the maxima of all-negative columns came out 0.)
struct Stats {
  float s, sq, mx, mn;
  __device__ __forceinline__ void reset() {
    s = 0.f, sq = 0.f, mx = -INFINITY, mn = -INFINITY;
  }
  __device__ __forceinline__ void take(float x) {
    const float nx = -x;
    s = __fadd_rn(s, x);
    sq = __fadd_rn(sq, __fmul_rn(x, x));
    // NaN is sticky, as in the reference's max
    if (x > mx || x != x) mx = x;
    if (nx > mn || nx != nx) mn = nx;
  }
};

__device__ __forceinline__ float cleaned(float m, float lowest) { return m <= lowest ? 0.f : m; }

// The end of a row's walk: its end, cut at the bound, and not before lo.
__device__ __forceinline__ long long bounded_end(long long hi, long long lo,
                                                 const int32_t* real_edges, long long n_edges) {
  const long long bound = edge_bound(real_edges, n_edges);
  hi = hi < bound ? hi : bound;
  return hi < lo ? lo : hi;
}

// Rows of 2 columns or more: a lane owns vectors lane, lane + 32, ...
// (VPL of them a pass) of V bytes; wider rows take further passes over the
// same slots.
template <typename T, int V, int VPL>
__global__ void __launch_bounds__(kThreads)
    pna_aggregate_warp_kernel(const T* __restrict__ v, const uint8_t* __restrict__ mask,
                              const int32_t* __restrict__ ptr,
                              const int32_t* __restrict__ real_edges, long long n_edges,
                              long long n_rows, int h, int nv, float lowest,
                              float* __restrict__ sum, float* __restrict__ sumsq,
                              float* __restrict__ cnt, T* __restrict__ both) {
  constexpr int EPV = V / (int)sizeof(T);
  constexpr int U = VPL * EPV <= 4 ? 8 : 4;
  const int lane = threadIdx.x & 31;
  const long long row = (long long)blockIdx.x * kWarps + (threadIdx.x >> 5);
  if (row >= n_rows) return;  // the whole warp
  const long long lo = ptr[row];
  const long long hi = bounded_end(ptr[row + 1], lo, real_edges, n_edges);
  const size_t row_bytes = (size_t)h * sizeof(T);
  const char* vb = reinterpret_cast<const char*>(v);
  int count = 0;
  for (int c0 = 0; c0 < nv; c0 += 32 * VPL) {
    Stats st[VPL][EPV];
#pragma unroll
    for (int p = 0; p < VPL; ++p)
#pragma unroll
      for (int i = 0; i < EPV; ++i) st[p][i].reset();
    for (long long base = lo; base < hi; base += 32) {
      const long long e = base + lane;
      unsigned live = __ballot_sync(kFullWarp, e < hi && (mask == nullptr || mask[e]));
      if (c0 == 0) count += __popc(live);
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
            for (int i = 0; i < EPV; ++i) st[p][i].take(x[u][p][i]);
        }
      }
    }
    char* bb = reinterpret_cast<char*>(both) + (size_t)row * 2 * row_bytes;
#pragma unroll
    for (int p = 0; p < VPL; ++p) {
      const int col = c0 + p * 32 + lane;
      if (col >= nv) continue;
      float s[EPV], sq[EPV], mx[EPV], mn[EPV];
#pragma unroll
      for (int i = 0; i < EPV; ++i) {
        s[i] = st[p][i].s, sq[i] = st[p][i].sq;
        mx[i] = cleaned(st[p][i].mx, lowest), mn[i] = cleaned(st[p][i].mn, lowest);
      }
      const size_t o = (size_t)row * h + (size_t)col * EPV;
      store_f32<EPV>(sum + o, s);
      store_f32<EPV>(sumsq + o, sq);
      store_vec<T, V>(bb + (size_t)col * V, mx);
      store_vec<T, V>(bb + row_bytes + (size_t)col * V, mn);
    }
  }
  if (lane == 0) cnt[row] = (float)count;
}

// Rows of one column (the design notes above): a group of 8 lanes per
// row (common.cuh:group_walk). A slot's value is loaded with its mask
// byte (v is read for every slot of the row; a masked slot's value is
// dropped, never added).
template <typename T>
__global__ void __launch_bounds__(kThreads)
    pna_aggregate_h1_kernel(const T* __restrict__ v, const uint8_t* __restrict__ mask,
                            const int32_t* __restrict__ ptr,
                            const int32_t* __restrict__ real_edges, long long n_edges,
                            long long n_rows, float lowest, float* __restrict__ sum,
                            float* __restrict__ sumsq, float* __restrict__ cnt,
                            T* __restrict__ both) {
  const long long row = ((long long)blockIdx.x * kThreads + threadIdx.x) / kGroup;
  const bool own = row < n_rows;  // the warp's other rows still shuffle
  long long lo = 0, hi = 0;
  if (own) {
    lo = ptr[row];
    hi = bounded_end(ptr[row + 1], lo, real_edges, n_edges);
  }
  Stats st;
  st.reset();
  const int count = group_walk(
      lo, hi,
      [&](long long e, float& m) -> bool {
        if (e >= hi) return false;
        m = to_f32<T>(v[e]);
        return mask == nullptr || mask[e];
      },
      [&](float x) { st.take(x); });
  if (own && (threadIdx.x & (kGroup - 1)) == 0) {
    sum[row] = st.s;
    sumsq[row] = st.sq;
    cnt[row] = (float)count;
    both[2 * row] = from_f32<T>(cleaned(st.mx, lowest));
    both[2 * row + 1] = from_f32<T>(cleaned(st.mn, lowest));
  }
}

template <typename T, int V>
int launch_warp(const void* v, const void* mask, const void* row_ptr, const void* real_edges,
                long long n_edges, long long n_rows, int h, float lowest, void* sum, void* sumsq,
                void* cnt, void* both, cudaStream_t stream) {
  if constexpr (V < (int)sizeof(T)) {
    return (int)cudaErrorInvalidValue;
  } else {
    const int nv = (int)((long long)h * sizeof(T) / V);
    const unsigned blocks = (unsigned)((n_rows + kWarps - 1) / kWarps);
    if (nv <= 32)
      pna_aggregate_warp_kernel<T, V, 1><<<blocks, kThreads, 0, stream>>>(
          (const T*)v, (const uint8_t*)mask, (const int32_t*)row_ptr, (const int32_t*)real_edges,
          n_edges, n_rows, h, nv, lowest, (float*)sum, (float*)sumsq, (float*)cnt, (T*)both);
    else
      pna_aggregate_warp_kernel<T, V, 2><<<blocks, kThreads, 0, stream>>>(
          (const T*)v, (const uint8_t*)mask, (const int32_t*)row_ptr, (const int32_t*)real_edges,
          n_edges, n_rows, h, nv, lowest, (float*)sum, (float*)sumsq, (float*)cnt, (T*)both);
    return (int)cudaGetLastError();
  }
}

template <typename T>
int launch(const void* v, const void* mask, const void* real_edges, long long n_edges, long long n_rows,
           int h, const void* row_ptr, void* sum, void* sumsq, void* cnt, void* both, float lowest,
           cudaStream_t stream) {
  if (h == 1) {
    const unsigned blocks = (unsigned)((n_rows + kThreads / kGroup - 1) / (kThreads / kGroup));
    pna_aggregate_h1_kernel<T><<<blocks, kThreads, 0, stream>>>(
        (const T*)v, (const uint8_t*)mask, (const int32_t*)row_ptr, (const int32_t*)real_edges, n_edges,
        n_rows, lowest, (float*)sum, (float*)sumsq, (float*)cnt, (T*)both);
    return (int)cudaGetLastError();
  }
  // sum and sumsq take vector stores of EPV floats (16 bytes at most):
  // the wrapper's own allocations, aligned far beyond that
  if (((uintptr_t)sum | (uintptr_t)sumsq) % 16 != 0) return (int)cudaErrorMisalignedAddress;
  const uintptr_t align = (uintptr_t)v | (uintptr_t)both;
  switch (row_vector_bytes((long long)h * sizeof(T), align, (int)sizeof(T))) {
    case 16:
      return launch_warp<T, 16>(v, mask, row_ptr, real_edges, n_edges, n_rows, h, lowest, sum, sumsq, cnt,
                                  both, stream);
    case 8:
      return launch_warp<T, 8>(v, mask, row_ptr, real_edges, n_edges, n_rows, h, lowest, sum, sumsq, cnt,
                                  both, stream);
    case 4:
      return launch_warp<T, 4>(v, mask, row_ptr, real_edges, n_edges, n_rows, h, lowest, sum, sumsq, cnt,
                                  both, stream);
    case 2:
      return launch_warp<T, 2>(v, mask, row_ptr, real_edges, n_edges, n_rows, h, lowest, sum, sumsq, cnt,
                                  both, stream);
    default:
      return (int)cudaErrorMisalignedAddress;
  }
}

}  // namespace

// dtype: 0 = float32, 1 = bfloat16. mask may be null (every edge valid).
// row_ptr: the n_rows + 1 int32 row pointers of the n_edges sorted
// receivers (row_pointers.cu). real_edges: null (no bound), or one int32
// on the device. Returns cudaGetLastError() after the launch (0 =
// success).
extern "C" int hg_pna_aggregate_fwd(const void* v, int dtype, const void* mask, const void* real_edges,
                                    long long n_edges, long long n_rows, int h, const void* row_ptr,
                                    void* sum, void* sumsq, void* cnt, void* both, void* stream) {
  if (n_rows <= 0 || h <= 0 || n_edges < 0) return (int)cudaErrorInvalidValue;
  cudaStream_t s = (cudaStream_t)stream;
  if (dtype == 0)
    return launch<float>(v, mask, real_edges, n_edges, n_rows, h, row_ptr, sum, sumsq, cnt, both, lowest_of(0),
                         s);
  if (dtype == 1)
    return launch<__nv_bfloat16>(v, mask, real_edges, n_edges, n_rows, h, row_ptr, sum, sumsq, cnt, both,
                                 lowest_of(1), s);
  return (int)cudaErrorInvalidValue;
}
