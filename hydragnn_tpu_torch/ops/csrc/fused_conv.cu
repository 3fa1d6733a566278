// fused_conv.cu — the fused gather -> edge network -> masked scatter for
// Hopper (sm_90a).
//
// Replaces hydragnn_tpu/ops/fused_conv.py:_make_fused_kernel (reached
// through _fused_kernel_call and fused_conv). For receivers sorted
// ascending it gives, per output row r and column o,
//
//   out[r, o] = Σ msg_e[o]   over the edges e of row r with mask[e] set
//
//   msg_e[o] = Π_k act_k(Σ_i x[send_e, i]·W[i, k·Hout + o] + b[k·Hout + o]
//                        + rtab[r, k·Hout + o] + eterm[e, k·Hout + o])
//              for K = 1 or 2 branches (W, b f32; rtab, eterm optional), or
//            = x[send_e, o] for K = 0 (identity, Hout = Hin),
//   times scale[e, o] when a scale is given,
//
// computed in float32 for float32 and bfloat16 inputs and summed in float32.
// Rows with no such edge are 0. A masked edge is skipped (a select, not a
// product by 0): its sender is never read and its message never formed, so
// an inf in its eterm or a self-loop filler cannot reach the output. Edges
// at or past *real_edges (the batch's occupancy bound, every one of them
// masked) are not visited; the bound is clamped to [0, E]. A sender
// outside [0, n_x_rows) drops its edge.
//
// What bounds it on this card: bytes for every variant the conv stacks run
// (identity, per-edge scale, the width-1 CGCNN gate). The least time is
// (E·4 senders + E·4 receivers + E·1 mask + N·Hin·sizeof(x) [+ E·Hout·sizeof
// (scale)] [+ the tables] + S·Hout·4) / 3.35 TB/s. A gate at width 128 does
// E·Hin·K·Hout multiply-adds and is bound by operations instead.
//
// What the design does:
//   - CSR row pointers of the sorted receivers come in from the caller
//     (row_pointers.cu, built once per forward by the chassis and shared
//     by every layer): no search, no atomics, no pass of its own.
//   - Every output element is summed over its row's edges in edge order
//     with __fadd_rn / __fmul_rn, by one lane: two launches are bitwise
//     equal, and f32 equals index_add_ on the host bit for bit.
//   - Identity and scale (K = 0), rows of 2 columns or more: one warp per
//     output row (common.cuh:warp_walk, which B9 shares). The warp loads
//     32 slots' mask and sender with one
//     coalesced load each, keeps the live ones by __ballot_sync (masked,
//     out-of-range and past-the-bound slots drop out) and hands each
//     sender to every lane by __shfl_sync, in edge order. Each lane owns a
//     vector of columns (16 bytes at H = 128 f32, 8 at SchNet's 504-byte
//     F = 126 rows and at bf16 H = 128; common.cuh:row_vector_bytes checks
//     the row's bytes and every base pointer) and issues U row loads (8,
//     or 4 for wide vectors and the scale) before it adds any of them.
//     So a warp has U x 512 bytes of the gather in flight where the old
//     one-column-a-thread walk had one 4-byte load, and no lane reads an
//     index twice. x (16.8 MB at the flagship) stays in the 50 MB L2, so
//     the gather is bound by L2's rate, not HBM's. Rows under 32 columns
//     (on no shipped path) take one element a lane, lanes past the row's
//     width idle.
//   - Identity and scale at one column (conv_0 of GIN, SAGE and MFC):
//     a group of 8 lanes per row, four rows a warp (common.cuh:
//     group_walk). Each lane loads four slots' mask and sender together,
//     then gathers their x itself, so a row has 32 gathers in flight, and
//     a warp covers four rows: the flagship batch's 32,752 rows fit on the
//     card at once. The group's values are handed round by __shfl_sync in
//     edge order.
//   - Narrow branches (K = 1, 2 with Hout < 32: the width-1 CGCNN gate):
//     lanes run along the columns in groups of a power of two
//     (common.cuh:lanes_log2), many rows a warp, W and b in shared memory, and
//     each lane reads its edges' gathered rows itself (Hin values each), so
//     no lane of a warp waits on a barrier for a row it has no column of.
//   - Wide branches (K = 1, 2): a block of 128 threads holds W and b in shared
//     memory (128 KB at Hin = 128, K·Hout = 256, hence the raised dynamic
//     limit; W stays in global memory when it does not fit). A group of
//     32-128 lanes (one row at a time) stages the gathered rows of 8 edges
//     in shared memory behind a named barrier of its own, then each lane
//     forms its column's pre-activations with fmaf over Hin. The receiver
//     table's row is the output row, so it is read once per row. The
//     per-edge product runs on the CUDA cores, not the tensor cores
//     (wgmma is later work).
// The TPU mechanics of the original (128-lane padding, one-hot MXU gather
// and scatter, the 3-term bf16 split, the CE/BN/BW window plan) have no
// counterpart here.

#include "common.cuh"

namespace {

constexpr int kBranchThreads = 128;
constexpr int kStage = 8;  // edges staged per group barrier
constexpr int kMaxSmem = 200 * 1024;
constexpr int kNarrowSmem = 48 * 1024;  // the default limit: no attribute to raise

// A barrier over the `lanes` threads of group g only (lanes a multiple of
// 32); barrier 0 stays __syncthreads'.
__device__ __forceinline__ void group_sync(int g, int lanes) {
  asm volatile("bar.sync %0, %1;" ::"r"(g + 1), "r"(lanes) : "memory");
}

// K = 0 at one column (the design notes above): a group of 8 lanes per
// row (common.cuh:group_walk). The mask and the sender of a slot are
// loaded together, then x (and the scale).
template <typename T, bool SCALE>
__global__ void __launch_bounds__(kThreads)
    fused_identity_h1_kernel(const T* __restrict__ x, const int32_t* __restrict__ send,
                             const uint8_t* __restrict__ mask, const int32_t* __restrict__ ptr,
                             const int32_t* __restrict__ real_edges, long long n_edges,
                             long long n_x_rows, long long n_rows, const T* __restrict__ scale,
                             float* __restrict__ out) {
  const long long row = ((long long)blockIdx.x * kThreads + threadIdx.x) / kGroup;
  const bool own = row < n_rows;  // the warp's other rows still shuffle
  long long lo = 0, hi = 0;
  if (own) {
    lo = ptr[row];
    hi = ptr[row + 1];
    const long long bound = edge_bound(real_edges, n_edges);
    hi = hi > bound ? bound : hi;
  }
  float acc = 0.f;
  group_walk(
      lo, hi,
      [&](long long e, float& m) -> bool {
        if (e >= hi) return false;
        const uint8_t live = mask[e];
        const int j = send[e];
        if (!live || j < 0 || j >= n_x_rows) return false;
        m = to_f32<T>(x[j]);
        if constexpr (SCALE) m = __fmul_rn(m, to_f32<T>(scale[e]));
        return true;
      },
      [&](float v) { acc = __fadd_rn(acc, v); });
  if (own && (threadIdx.x & (kGroup - 1)) == 0) out[row] = acc;
}

// K = 0 at 2 columns or more: one warp per output row (the design notes
// above; common.cuh:warp_walk). nv: the row's vectors of V bytes; a lane
// owns vectors lane, lane + 32, ..., VPL of them a pass, and wider rows
// take further passes over the same edges.
template <typename T, int V, int VPL, bool SCALE>
__global__ void __launch_bounds__(kThreads)
    fused_identity_warp_kernel(const T* __restrict__ x, const int32_t* __restrict__ send,
                               const uint8_t* __restrict__ mask, const int32_t* __restrict__ ptr,
                               const int32_t* __restrict__ real_edges, long long n_edges,
                               long long n_x_rows, long long n_rows, int h, int nv,
                               const T* __restrict__ scale, float* __restrict__ out) {
  constexpr int EPV = V / (int)sizeof(T);
  const int lane = threadIdx.x & 31;
  const long long row = (long long)blockIdx.x * (blockDim.x >> 5) + (threadIdx.x >> 5);
  if (row >= n_rows) return;  // the whole warp
  const long long lo = ptr[row];
  long long hi = ptr[row + 1];
  const long long bound = edge_bound(real_edges, n_edges);
  hi = hi > bound ? bound : hi;
  for (int c0 = 0; c0 < nv; c0 += 32 * VPL) {
    float acc[VPL][EPV];
    // a sender outside [0, n_x_rows) drops its slot
    warp_walk<T, V, VPL, SCALE, false>(x, send, mask, lo, hi, n_x_rows, h, c0, nv, scale, acc);
#pragma unroll
    for (int p = 0; p < VPL; ++p) {
      const int col = c0 + p * 32 + lane;
      if (col >= nv) continue;
      float* dst = out + (size_t)row * h + (size_t)col * EPV;
#pragma unroll
      for (int i = 0; i < EPV; ++i) dst[i] = acc[p][i];
    }
  }
}

// One edge's message from its pre-activations p0 (and p1), accumulated
// over Hin already: adds b, the receiver row's table entries and the edge
// term, applies the activations, multiplies the branches and the scale.
template <typename T, int KBR>
__device__ __forceinline__ float branch_message(float p0, float p1, int o, int hout, long long e,
                                                int kh, int act0, int act1,
                                                const float* __restrict__ b_s, float r0, float r1,
                                                bool has_rtab, const T* __restrict__ eterm,
                                                const T* __restrict__ scale) {
  p0 = __fadd_rn(p0, b_s[o]);
  if (has_rtab) p0 = __fadd_rn(p0, r0);
  if (eterm != nullptr) p0 = __fadd_rn(p0, to_f32<T>(eterm[e * kh + o]));
  float m = act_f(act0, p0);
  if (KBR == 2) {
    p1 = __fadd_rn(p1, b_s[hout + o]);
    if (has_rtab) p1 = __fadd_rn(p1, r1);
    if (eterm != nullptr) p1 = __fadd_rn(p1, to_f32<T>(eterm[e * kh + hout + o]));
    m = __fmul_rn(m, act_f(act1, p1));
  }
  if (scale != nullptr) m = __fmul_rn(m, to_f32<T>(scale[e * hout + o]));
  return m;
}

template <typename T, int KBR>
__global__ void fused_narrow_kernel(const T* __restrict__ x, const int32_t* __restrict__ send,
                                    const uint8_t* __restrict__ mask,
                                    const int32_t* __restrict__ ptr,
                                    const int32_t* __restrict__ real_edges, long long n_edges,
                                    long long n_x_rows, long long n_rows, int hin, int hout,
                                    int act0, int act1, const float* __restrict__ w,
                                    const float* __restrict__ b, const T* __restrict__ rtab,
                                    const T* __restrict__ eterm, const T* __restrict__ scale,
                                    int lpr_log2, float* __restrict__ out) {
  extern __shared__ float smem[];
  const int kh = KBR * hout;
  float* w_s = smem;
  float* b_s = smem + hin * kh;
  for (int i = threadIdx.x; i < hin * kh; i += blockDim.x) w_s[i] = w[i];
  for (int i = threadIdx.x; i < kh; i += blockDim.x) b_s[i] = b != nullptr ? b[i] : 0.f;
  __syncthreads();
  const int lpr = 1 << lpr_log2;
  const int lane = threadIdx.x & (lpr - 1);
  const long long row =
      (long long)blockIdx.x * (blockDim.x >> lpr_log2) + (threadIdx.x >> lpr_log2);
  if (row >= n_rows) return;
  const long long lo = ptr[row];
  long long hi = ptr[row + 1];
  const long long bound = edge_bound(real_edges, n_edges);
  hi = hi > bound ? bound : hi;
  for (int o = lane; o < hout; o += lpr) {
    float r0 = 0.f, r1 = 0.f;  // the receiver table's row is this row
    if (rtab != nullptr) {
      r0 = to_f32<T>(rtab[row * kh + o]);
      if (KBR == 2) r1 = to_f32<T>(rtab[row * kh + hout + o]);
    }
    float acc = 0.f;
    for (long long e = lo; e < hi; ++e) {
      if (!mask[e]) continue;
      const long long j = send[e];
      float p0 = 0.f, p1 = 0.f;
      if (j >= 0 && j < n_x_rows) {
        for (int i = 0; i < hin; ++i) {
          const float vi = to_f32<T>(x[j * hin + i]);
          p0 = fmaf(vi, w_s[i * kh + o], p0);
          if (KBR == 2) p1 = fmaf(vi, w_s[i * kh + hout + o], p1);
        }
      }
      acc = __fadd_rn(acc, branch_message<T, KBR>(p0, p1, o, hout, e, kh, act0, act1, b_s, r0, r1,
                                                  rtab != nullptr, eterm, scale));
    }
    out[row * hout + o] = acc;
  }
}

template <typename T, int KBR>
__global__ void fused_branch_kernel(const T* __restrict__ x, const int32_t* __restrict__ send,
                                    const uint8_t* __restrict__ mask,
                                    const int32_t* __restrict__ ptr,
                                    const int32_t* __restrict__ real_edges, long long n_edges,
                                    long long n_x_rows, long long n_rows, int hin, int hout,
                                    int act0, int act1, const float* __restrict__ w,
                                    const float* __restrict__ b, const T* __restrict__ rtab,
                                    const T* __restrict__ eterm, const T* __restrict__ scale,
                                    int w_in_smem, int lpr_log2, float* __restrict__ out) {
  extern __shared__ float smem[];
  const int kh = KBR * hout;
  float* w_s = smem;
  float* b_s = smem + (w_in_smem ? hin * kh : 0);
  const int lpr = 1 << lpr_log2;
  const int groups = blockDim.x >> lpr_log2;
  const int g = threadIdx.x >> lpr_log2;
  const int lane = threadIdx.x & (lpr - 1);
  float* v_s = b_s + kh + g * kStage * hin;

  if (w_in_smem)
    for (int i = threadIdx.x; i < hin * kh; i += blockDim.x) w_s[i] = w[i];
  for (int i = threadIdx.x; i < kh; i += blockDim.x) b_s[i] = b != nullptr ? b[i] : 0.f;
  __syncthreads();
  const float* wt = w_in_smem ? w_s : w;
  const long long bound = edge_bound(real_edges, n_edges);

  for (long long row = (long long)blockIdx.x * groups + g; row < n_rows;
       row += (long long)gridDim.x * groups) {
    const long long lo = ptr[row];
    long long hi = ptr[row + 1];
    hi = hi > bound ? bound : hi;
    for (int f0 = 0; f0 < hout; f0 += lpr) {
      const int o = f0 + lane;
      const bool live = o < hout;
      float r0 = 0.f, r1 = 0.f;  // the receiver table's row is this row
      if (live && rtab != nullptr) {
        r0 = to_f32<T>(rtab[row * kh + o]);
        if (KBR == 2) r1 = to_f32<T>(rtab[row * kh + hout + o]);
      }
      float acc = 0.f;
      for (long long e0 = lo; e0 < hi; e0 += kStage) {
        const int ne = (int)((hi - e0) < kStage ? (hi - e0) : kStage);
        group_sync(g, lpr);  // the previous chunk's rows are read
        for (int idx = lane; idx < ne * hin; idx += lpr) {
          const int u = idx / hin;
          const int i = idx - u * hin;
          const long long e = e0 + u;
          float val = 0.f;
          if (mask[e]) {
            const long long j = send[e];
            if (j >= 0 && j < n_x_rows) val = to_f32<T>(x[j * hin + i]);
          }
          v_s[u * hin + i] = val;
        }
        group_sync(g, lpr);
        if (!live) continue;
        for (int u = 0; u < ne; ++u) {
          const long long e = e0 + u;
          if (!mask[e]) continue;
          const float* v = v_s + u * hin;
          float p0 = 0.f, p1 = 0.f;
          for (int i = 0; i < hin; ++i) {
            const float vi = v[i];
            p0 = fmaf(vi, wt[i * kh + o], p0);
            if (KBR == 2) p1 = fmaf(vi, wt[i * kh + hout + o], p1);
          }
          acc = __fadd_rn(acc, branch_message<T, KBR>(p0, p1, o, hout, e, kh, act0, act1, b_s, r0,
                                                      r1, rtab != nullptr, eterm, scale));
        }
      }
      if (live) out[row * hout + o] = acc;
    }
  }
}

template <typename T, int KBR>
int launch_branch(const void* x, const void* send, const void* mask, const void* real_edges,
                  long long n_edges, long long n_x_rows, long long n_rows, int hin, int hout,
                  int act0, int act1, const void* w, const void* b, const void* rtab,
                  const void* eterm, const void* scale, const void* row_ptr, void* out,
                  cudaStream_t stream) {
  // raise the dynamic shared memory limit once, at the first launch (never
  // inside a CUDA graph capture, which replays launches only)
  static bool limit_set = false;
  if (!limit_set) {
    cudaError_t err = cudaFuncSetAttribute(fused_branch_kernel<T, KBR>,
                                           cudaFuncAttributeMaxDynamicSharedMemorySize, kMaxSmem);
    if (err != cudaSuccess) return (int)err;
    limit_set = true;
  }
  int lpr_log2 = lanes_log2(hout);
  const long long kh = (long long)KBR * hout;
  const long long w_bytes = (long long)hin * kh * 4;
  if (lpr_log2 < 5 && w_bytes + kh * 4 <= kNarrowSmem) {
    const long long rows_per_block = kThreads >> lpr_log2;
    const long long blocks = (n_rows + rows_per_block - 1) / rows_per_block;
    fused_narrow_kernel<T, KBR><<<(unsigned)blocks, kThreads, (size_t)(w_bytes + kh * 4), stream>>>(
        (const T*)x, (const int32_t*)send, (const uint8_t*)mask, (const int32_t*)row_ptr,
        (const int32_t*)real_edges, n_edges, n_x_rows, n_rows, hin, hout, act0, act1,
        (const float*)w, (const float*)b, (const T*)rtab, (const T*)eterm, (const T*)scale,
        lpr_log2, (float*)out);
    return (int)cudaGetLastError();
  }
  if (lpr_log2 < 5) lpr_log2 = 5;  // whole warps per group (named barriers)
  const int groups = kBranchThreads >> lpr_log2;
  const long long stage_bytes = (kh + (long long)groups * kStage * hin) * 4;
  if (stage_bytes > kMaxSmem) return (int)cudaErrorInvalidValue;
  const int w_in_smem = stage_bytes + w_bytes <= kMaxSmem;
  const long long smem = stage_bytes + (w_in_smem ? w_bytes : 0);
  long long blocks = (n_rows + groups - 1) / groups;
  // a large W is staged once per block: a few blocks per SM walk all rows
  if (w_bytes > 16 * 1024 && blocks > 4LL * sm_count()) blocks = 4LL * sm_count();
  fused_branch_kernel<T, KBR><<<(unsigned)blocks, kBranchThreads, (size_t)smem, stream>>>(
      (const T*)x, (const int32_t*)send, (const uint8_t*)mask, (const int32_t*)row_ptr,
      (const int32_t*)real_edges, n_edges, n_x_rows, n_rows, hin, hout, act0, act1,
      (const float*)w, (const float*)b, (const T*)rtab, (const T*)eterm, (const T*)scale,
      w_in_smem, lpr_log2, (float*)out);
  return (int)cudaGetLastError();
}

template <typename T, int V, int VPL>
int launch_identity_warp(const void* x, const void* send, const void* mask, const void* real_edges,
                         long long n_edges, long long n_x_rows, long long n_rows, int h, int nv,
                         const void* scale, const void* row_ptr, void* out, cudaStream_t stream) {
  const long long rows_per_block = kThreads / 32;
  const unsigned blocks = (unsigned)((n_rows + rows_per_block - 1) / rows_per_block);
  if (scale != nullptr)
    fused_identity_warp_kernel<T, V, VPL, true><<<blocks, kThreads, 0, stream>>>(
        (const T*)x, (const int32_t*)send, (const uint8_t*)mask, (const int32_t*)row_ptr,
        (const int32_t*)real_edges, n_edges, n_x_rows, n_rows, h, nv, (const T*)scale,
        (float*)out);
  else
    fused_identity_warp_kernel<T, V, VPL, false><<<blocks, kThreads, 0, stream>>>(
        (const T*)x, (const int32_t*)send, (const uint8_t*)mask, (const int32_t*)row_ptr,
        (const int32_t*)real_edges, n_edges, n_x_rows, n_rows, h, nv, nullptr, (float*)out);
  return (int)cudaGetLastError();
}

template <typename T, bool SCALE>
int launch_identity_h1(const void* x, const void* send, const void* mask, const void* real_edges,
                       long long n_edges, long long n_x_rows, long long n_rows, const void* scale,
                       const void* row_ptr, void* out, cudaStream_t stream) {
  const unsigned blocks = (unsigned)((n_rows + kThreads / kGroup - 1) / (kThreads / kGroup));
  fused_identity_h1_kernel<T, SCALE><<<blocks, kThreads, 0, stream>>>(
      (const T*)x, (const int32_t*)send, (const uint8_t*)mask, (const int32_t*)row_ptr,
      (const int32_t*)real_edges, n_edges, n_x_rows, n_rows, (const T*)scale, (float*)out);
  return (int)cudaGetLastError();
}

template <typename T, int V>
int launch_identity_v(const void* x, const void* send, const void* mask, const void* real_edges,
                      long long n_edges, long long n_x_rows, long long n_rows, int h,
                      const void* scale, const void* row_ptr, void* out, cudaStream_t stream) {
  if constexpr (V < (int)sizeof(T)) {
    return (int)cudaErrorInvalidValue;
  } else {
    const int nv = (int)((long long)h * sizeof(T) / V);
    if (nv <= 32)
      return launch_identity_warp<T, V, 1>(x, send, mask, real_edges, n_edges, n_x_rows, n_rows,
                                           h, nv, scale, row_ptr, out, stream);
    return launch_identity_warp<T, V, 2>(x, send, mask, real_edges, n_edges, n_x_rows, n_rows, h,
                                         nv, scale, row_ptr, out, stream);
  }
}

template <typename T>
int launch(const void* x, const void* send, const void* mask, const void* real_edges,
           long long n_edges, long long n_x_rows, long long n_rows, int hin, int hout, int k_br,
           int act0, int act1, const void* w, const void* b, const void* rtab, const void* eterm,
           const void* scale, const void* row_ptr, void* out, cudaStream_t stream) {
  if (k_br == 0 && hout >= 2) {
    const uintptr_t align = (uintptr_t)x | (uintptr_t)scale;
    const int v = row_vector_bytes((long long)hout * sizeof(T), align, (int)sizeof(T));
    switch (v) {
      case 16:
        return launch_identity_v<T, 16>(x, send, mask, real_edges, n_edges, n_x_rows, n_rows,
                                        hout, scale, row_ptr, out, stream);
      case 8:
        return launch_identity_v<T, 8>(x, send, mask, real_edges, n_edges, n_x_rows, n_rows,
                                       hout, scale, row_ptr, out, stream);
      case 4:
        return launch_identity_v<T, 4>(x, send, mask, real_edges, n_edges, n_x_rows, n_rows,
                                       hout, scale, row_ptr, out, stream);
      case 2:
        return launch_identity_v<T, 2>(x, send, mask, real_edges, n_edges, n_x_rows, n_rows,
                                       hout, scale, row_ptr, out, stream);
      default:
        return (int)cudaErrorMisalignedAddress;
    }
  }
  if (k_br == 0) {
    if (scale != nullptr)
      return launch_identity_h1<T, true>(x, send, mask, real_edges, n_edges, n_x_rows, n_rows,
                                         scale, row_ptr, out, stream);
    return launch_identity_h1<T, false>(x, send, mask, real_edges, n_edges, n_x_rows, n_rows,
                                        nullptr, row_ptr, out, stream);
  }
  if (k_br == 1)
    return launch_branch<T, 1>(x, send, mask, real_edges, n_edges, n_x_rows, n_rows, hin, hout,
                               act0, act1, w, b, rtab, eterm, scale, row_ptr, out, stream);
  return launch_branch<T, 2>(x, send, mask, real_edges, n_edges, n_x_rows, n_rows, hin, hout,
                             act0, act1, w, b, rtab, eterm, scale, row_ptr, out, stream);
}

}  // namespace

// dtype: 0 = float32, 1 = bfloat16, for x, rtab, eterm and scale alike; w
// ([Hin, K·Hout]) and b ([K·Hout], may be null) are float32. rtab
// ([n_rows, K·Hout]), eterm ([E, K·Hout]), scale ([E, Hout]) and
// real_edges (one int32 on the card) may be null. K = k_br in 0..2, and
// K = 0 needs Hin = Hout. act0/act1: 0 none, 1 relu, 2 sigmoid, 3 softplus,
// 4 tanh, 5 silu. row_ptr: the n_rows + 1 int32 row pointers of the
// sorted receivers (row_pointers.cu). Returns a cudaError_t (0 = success).
extern "C" int hg_fused_conv(const void* x, int dtype, const void* send, const void* mask,
                             const void* real_edges, long long n_edges, long long n_x_rows,
                             long long n_rows, int hin, int hout, int k_br, int act0, int act1,
                             const void* w, const void* b, const void* rtab, const void* eterm,
                             const void* scale, const void* row_ptr, void* out, void* stream) {
  if (n_rows <= 0 || n_edges < 0 || n_x_rows <= 0 || hin <= 0 || hout <= 0 || k_br < 0 ||
      k_br > 2 || act0 < 0 || act0 > 5 || act1 < 0 || act1 > 5)
    return (int)cudaErrorInvalidValue;
  if ((k_br == 0 && hin != hout) || (k_br > 0 && w == nullptr)) return (int)cudaErrorInvalidValue;
  cudaStream_t s = (cudaStream_t)stream;
  if (dtype == 0)
    return launch<float>(x, send, mask, real_edges, n_edges, n_x_rows, n_rows, hin, hout, k_br,
                         act0, act1, w, b, rtab, eterm, scale, row_ptr, out, s);
  if (dtype == 1)
    return launch<__nv_bfloat16>(x, send, mask, real_edges, n_edges, n_x_rows, n_rows, hin, hout,
                                 k_br, act0, act1, w, b, rtab, eterm, scale, row_ptr, out, s);
  return (int)cudaErrorInvalidValue;
}
