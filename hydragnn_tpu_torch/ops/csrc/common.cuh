// common.cuh — helpers shared by the port's Hopper kernels (one copy per
// translation unit: everything here has internal linkage).
#pragma once

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <float.h>
#include <math.h>
#include <stdint.h>
#include <string.h>

namespace {

template <typename T> __device__ __forceinline__ float to_f32(T x);
template <> __device__ __forceinline__ float to_f32<float>(float x) { return x; }
template <> __device__ __forceinline__ float to_f32<__nv_bfloat16>(__nv_bfloat16 x) {
  return __bfloat162float(x);
}

template <typename T> __device__ __forceinline__ T from_f32(float x);
template <> __device__ __forceinline__ float from_f32<float>(float x) { return x; }
template <> __device__ __forceinline__ __nv_bfloat16 from_f32<__nv_bfloat16>(float x) {
  // round to nearest even, as PyTorch casts; exact where x is 0, the type's
  // lowest value, or came from a bf16
  return __float2bfloat16_rn(x);
}

// The lowest finite value of the kernel's data type, as a float:
// -FLT_MAX for float32, bits 0xff7f for bfloat16.
inline float lowest_of(int dtype) {
  if (dtype == 0) return -FLT_MAX;
  const uint32_t bits = 0xff7f0000u;
  float lowest;
  memcpy(&lowest, &bits, sizeof(lowest));
  return lowest;
}

// ptr[r] = first edge position whose receiver is >= r, for r in [0, n_rows].
// Thread e fills the rows between the receivers at positions e-1 and e; the
// thread at e == n_edges closes the tail. Ids are clamped into [-1, n_rows],
// so an out-of-range id drops its edge instead of writing out of bounds
// (ptr is zero-filled by the caller, so every entry stays in [0, n_edges]).
__global__ void csr_row_ptr_kernel(const int32_t* __restrict__ recv, long long n_edges,
                                   long long n_rows, int32_t* __restrict__ ptr) {
  long long e = (long long)blockIdx.x * blockDim.x + threadIdx.x;
  if (e > n_edges) return;
  long long prev = (e == 0) ? -1 : (long long)recv[e - 1];
  long long cur = (e == n_edges) ? n_rows : (long long)recv[e];
  prev = prev < -1 ? -1 : (prev > n_rows ? n_rows : prev);
  cur = cur < -1 ? -1 : (cur > n_rows ? n_rows : cur);
  for (long long r = prev + 1; r <= cur; ++r) ptr[r] = (int32_t)e;
}

// The edge-network activations of hydragnn_tpu/ops/fused_conv.py:_ACTS in
// float32, by code (the Python wrappers' ACT_CODE order); softplus =
// max(x, 0) + log1p(exp(-|x|)).
enum ActCode { kNone = 0, kRelu = 1, kSigmoid = 2, kSoftplus = 3, kTanh = 4, kSilu = 5 };

__device__ __forceinline__ float sigmoid_f(float x) { return 1.f / (1.f + expf(-x)); }

__device__ __forceinline__ float act_f(int act, float x) {
  switch (act) {
    case kRelu:
      return x < 0.f ? 0.f : x;
    case kSigmoid:
      return sigmoid_f(x);
    case kSoftplus:
      return fmaxf(x, 0.f) + log1pf(expf(-fabsf(x)));
    case kTanh:
      return tanhf(x);
    case kSilu:
      return x * sigmoid_f(x);
    default:
      return x;
  }
}

// The edge walk's occupancy bound: *real_edges clamped to [0, n_edges], or
// n_edges without one.
__device__ __forceinline__ long long edge_bound(const int32_t* real_edges, long long n_edges) {
  if (real_edges == nullptr) return n_edges;
  const long long r = *real_edges;
  return r < 0 ? 0 : (r > n_edges ? n_edges : r);
}

// The card's SM count (132 when it cannot be read).
inline int sm_count() {
  static int count = 0;
  if (count == 0) {
    int dev = 0;
    if (cudaGetDevice(&dev) != cudaSuccess ||
        cudaDeviceGetAttribute(&count, cudaDevAttrMultiProcessorCount, dev) != cudaSuccess)
      count = 132;
  }
  return count;
}

constexpr int kThreads = 256;

inline void launch_row_ptr(const void* recv, long long n_edges, long long n_rows, void* row_ptr,
                           cudaStream_t stream) {
  const long long threads = n_edges + 1;
  csr_row_ptr_kernel<<<(unsigned)((threads + kThreads - 1) / kThreads), kThreads, 0, stream>>>(
      (const int32_t*)recv, n_edges, n_rows, (int32_t*)row_ptr);
}

// log2 of the lanes that share one output row: the power of two at or
// above the row width, at most 128. Lanes run along the feature axis, so a
// warp reads consecutive values of one row; narrow rows (H = 1) pack many
// rows per warp instead of idling lanes.
inline int lanes_log2(int width) {
  int l = 0;
  while ((1 << l) < width && l < 7) ++l;
  return l;
}

constexpr unsigned kFullWarp = 0xffffffffu;

// Asynchronous global -> shared copies of B bytes (4, 8 or 16; 16 bypasses
// L1), their commit and their wait, as PTX: the long-row rings of B2 and
// B4.
template <int B>
__device__ __forceinline__ void copy_async(void* dst, const void* src) {
  const unsigned d = (unsigned)__cvta_generic_to_shared(dst);
  if constexpr (B == 16)
    asm volatile("cp.async.cg.shared.global [%0], [%1], 16;\n" ::"r"(d), "l"(src) : "memory");
  else
    asm volatile("cp.async.ca.shared.global [%0], [%1], %2;\n" ::"r"(d), "l"(src), "n"(B) : "memory");
}
__device__ __forceinline__ void copy_async_commit() { asm volatile("cp.async.commit_group;\n" ::: "memory"); }
template <int N>
__device__ __forceinline__ void copy_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(N) : "memory");
}

// The bytes one lane loads of a row at a time: the widest of 16, 8, 4, 2
// or 1 that divides the row's bytes and every base pointer's address
// (`align` is their bitwise or), as gather_rows.cu picks it; narrowed
// while 32 lanes would not cover the row (bf16 at H = 128: 8 bytes, so a
// warp reads the 256-byte row at once), but never below the element.
inline int row_vector_bytes(long long row_bytes, uintptr_t align, int elem_bytes) {
  int v = 16;
  while (v > 1 && (row_bytes % v != 0 || align % v != 0)) v >>= 1;
  while (v > elem_bytes && row_bytes / v < 32) v >>= 1;
  return v;
}

// One lane's vector of V bytes of a row, as float32: V / sizeof(T)
// elements, bf16 widened exactly (its bits in the float's top half).
template <typename T, int V>
__device__ __forceinline__ void load_vec(const char* p, float (&f)[V / sizeof(T)]) {
  static_assert(V >= (int)sizeof(T), "a vector holds whole elements");
  uint32_t w[V >= 4 ? V / 4 : 1];
  if constexpr (V == 16) {
    const uint4 r = *reinterpret_cast<const uint4*>(p);
    w[0] = r.x, w[1] = r.y, w[2] = r.z, w[3] = r.w;
  } else if constexpr (V == 8) {
    const uint2 r = *reinterpret_cast<const uint2*>(p);
    w[0] = r.x, w[1] = r.y;
  } else if constexpr (V == 4) {
    w[0] = *reinterpret_cast<const uint32_t*>(p);
  } else {
    w[0] = (uint32_t)(*reinterpret_cast<const uint16_t*>(p));
  }
  if constexpr (sizeof(T) == 4) {
#pragma unroll
    for (int i = 0; i < V / 4; ++i) f[i] = __uint_as_float(w[i]);
  } else if constexpr (V == 2) {
    f[0] = __uint_as_float(w[0] << 16);
  } else {
#pragma unroll
    for (int i = 0; i < V / 4; ++i) {
      f[2 * i] = __uint_as_float(w[i] << 16);
      f[2 * i + 1] = __uint_as_float(w[i] & 0xffff0000u);
    }
  }
}

// The counterpart of load_vec: f rounded to T (round to nearest even, as
// PyTorch casts) and stored as one vector of V bytes.
template <typename T, int V>
__device__ __forceinline__ void store_vec(char* p, const float (&f)[V / sizeof(T)]) {
  static_assert(V >= (int)sizeof(T), "a vector holds whole elements");
  uint32_t w[V >= 4 ? V / 4 : 1];
  if constexpr (sizeof(T) == 4) {
#pragma unroll
    for (int i = 0; i < V / 4; ++i) w[i] = __float_as_uint(f[i]);
  } else if constexpr (V == 2) {
    *reinterpret_cast<uint16_t*>(p) = __bfloat16_as_ushort(__float2bfloat16_rn(f[0]));
    return;
  } else {
#pragma unroll
    for (int i = 0; i < V / 4; ++i)
      w[i] = (uint32_t)__bfloat16_as_ushort(__float2bfloat16_rn(f[2 * i])) |
             ((uint32_t)__bfloat16_as_ushort(__float2bfloat16_rn(f[2 * i + 1])) << 16);
  }
  if constexpr (V == 16) {
    *reinterpret_cast<uint4*>(p) = make_uint4(w[0], w[1], w[2], w[3]);
  } else if constexpr (V == 8) {
    *reinterpret_cast<uint2*>(p) = make_uint2(w[0], w[1]);
  } else if constexpr (V == 4) {
    *reinterpret_cast<uint32_t*>(p) = w[0];
  }
}

// N consecutive float32 values as 16-byte vectors (or one 8- or 4-byte
// access below 4 values); p is aligned to min(N, 4) floats.
template <int N>
__device__ __forceinline__ void load_f32(const float* p, float (&f)[N]) {
  if constexpr (N >= 4) {
    static_assert(N % 4 == 0, "whole 16-byte vectors");
#pragma unroll
    for (int i = 0; i < N; i += 4) {
      const float4 r = *reinterpret_cast<const float4*>(p + i);
      f[i] = r.x, f[i + 1] = r.y, f[i + 2] = r.z, f[i + 3] = r.w;
    }
  } else if constexpr (N == 2) {
    const float2 r = *reinterpret_cast<const float2*>(p);
    f[0] = r.x, f[1] = r.y;
  } else {
    f[0] = *p;
  }
}

template <int N>
__device__ __forceinline__ void store_f32(float* p, const float (&f)[N]) {
  if constexpr (N >= 4) {
    static_assert(N % 4 == 0, "whole 16-byte vectors");
#pragma unroll
    for (int i = 0; i < N; i += 4)
      *reinterpret_cast<float4*>(p + i) = make_float4(f[i], f[i + 1], f[i + 2], f[i + 3]);
  } else if constexpr (N == 2) {
    *reinterpret_cast<float2*>(p) = make_float2(f[0], f[1]);
  } else {
    *p = f[0];
  }
}

// The warp walk of one receiver row (B8's identity and scale walks, B9's
// walk), for rows of 2 columns or more: the whole warp walks the row's
// slots [lo, hi) and lane `lane` owns the vectors c0 + p·32 + lane (p <
// VPL, below nv) of V bytes of it. A pass loads 32 slots' mask and sender
// with one coalesced load each and keeps the live slots by __ballot_sync:
// the mask set and the sender in [0, n_x_rows). With OOB, a masked-in slot
// whose sender lies outside that range is live too and reads row n_x_rows
// of x, which the caller provides. The live senders reach every lane by
// __shfl_sync in edge order, U at a time, and each lane issues its U row
// loads (and, with SCALE, the slots' scale rows) before it adds any of
// them, with __fadd_rn (after __fmul_rn by the scale) in edge order into
// acc, which starts at 0.
template <typename T, int V, int VPL, bool SCALE, bool OOB>
__device__ __forceinline__ void warp_walk(const T* __restrict__ x, const int32_t* __restrict__ send,
                                          const uint8_t* __restrict__ mask, long long lo,
                                          long long hi, long long n_x_rows, int h, int c0, int nv,
                                          const T* __restrict__ scale,
                                          float (&acc)[VPL][V / sizeof(T)]) {
  constexpr int EPV = V / (int)sizeof(T);
  constexpr int U = VPL * EPV * (SCALE ? 2 : 1) <= 4 ? 8 : 4;
  const int lane = threadIdx.x & 31;
  const size_t row_bytes = (size_t)h * sizeof(T);
  const char* xb = reinterpret_cast<const char*>(x);
  const char* sb = reinterpret_cast<const char*>(scale);
#pragma unroll
  for (int p = 0; p < VPL; ++p)
#pragma unroll
    for (int i = 0; i < EPV; ++i) acc[p][i] = 0.f;
  for (long long base = lo; base < hi; base += 32) {
    const long long e = base + lane;
    int j = -1;  // the row to gather, -1 for none
    if (e < hi && mask[e]) {
      const int s = send[e];
      if (s >= 0 && s < n_x_rows)
        j = s;
      else if (OOB)
        j = (int)n_x_rows;
    }
    unsigned live = __ballot_sync(kFullWarp, j >= 0);  // the same in every lane
    while (live) {
      int k[U];
#pragma unroll
      for (int u = 0; u < U; ++u) {
        k[u] = live ? __ffs(live) - 1 : -1;
        live &= live - 1u;
      }
      long long src[U];
#pragma unroll
      for (int u = 0; u < U; ++u) src[u] = __shfl_sync(kFullWarp, j, k[u] < 0 ? 0 : k[u]);
      float v[U][VPL][EPV], sc[U][VPL][EPV];
#pragma unroll
      for (int u = 0; u < U; ++u)
#pragma unroll
        for (int p = 0; p < VPL; ++p) {
          const int col = c0 + p * 32 + lane;
#pragma unroll
          for (int i = 0; i < EPV; ++i) v[u][p][i] = sc[u][p][i] = 0.f;
          if (k[u] >= 0 && col < nv) {
            load_vec<T, V>(xb + (size_t)src[u] * row_bytes + (size_t)col * V, v[u][p]);
            if constexpr (SCALE)
              load_vec<T, V>(sb + (size_t)(base + k[u]) * row_bytes + (size_t)col * V, sc[u][p]);
          }
        }
#pragma unroll
      for (int u = 0; u < U; ++u) {
        if (k[u] < 0) continue;
#pragma unroll
        for (int p = 0; p < VPL; ++p)
#pragma unroll
          for (int i = 0; i < EPV; ++i) {
            const float m = SCALE ? __fmul_rn(v[u][p][i], sc[u][p][i]) : v[u][p][i];
            acc[p][i] = __fadd_rn(acc[p][i], m);
          }
      }
    }
  }
}

// The one-column walk (B5 and B8 at H = 1, conv_0 of every stack): a group
// of kGroup = 8 lanes per row, four rows a warp. A pass covers 32 slots of
// each row: lane g of a group holds slots g, g + 8, g + 16 and g + 24, so
// it has four index loads, then four value loads, in flight. load(e, m)
// fills m with slot e's value and says whether the slot takes part (false
// past hi). The group's 32 values reach every lane of the group by
// __shfl_sync in slot order, and take(x) runs on each lane for each live
// slot, so the row's sums run in edge order. Passes repeat while any row
// of the warp has slots left (a warp-uniform count, for the shuffles).
// Returns the number of live slots of the lane's row.
constexpr int kGroup = 8;

template <typename Load, typename Take>
__device__ __forceinline__ int group_walk(long long lo, long long hi, Load&& load, Take&& take) {
  const int lane = threadIdx.x & 31;
  const int g = lane & (kGroup - 1);
  const int first = lane & ~(kGroup - 1);  // the group's first lane
  const int passes = __reduce_max_sync(kFullWarp, (int)((hi - lo + 31) / 32));
  int count = 0;
  for (int pass = 0; pass < passes; ++pass) {
    const long long base = lo + (long long)pass * 32;
    float m[4];
    bool ok[4];
#pragma unroll
    for (int t = 0; t < 4; ++t) {
      m[t] = 0.f;
      ok[t] = load(base + t * kGroup + g, m[t]);
    }
#pragma unroll
    for (int t = 0; t < 4; ++t) {
      const unsigned live = (__ballot_sync(kFullWarp, ok[t]) >> first) & 0xffu;
      count += __popc(live);
#pragma unroll
      for (int k = 0; k < kGroup; ++k) {
        const float x = __shfl_sync(kFullWarp, m[t], k, kGroup);
        if ((live >> k) & 1u) take(x);
      }
    }
  }
  return count;
}

}  // namespace
