// fused_conv_stack.cu — L width-preserving fused conv layers in one host
// entry, for Hopper (sm_90a).
//
// Replaces hydragnn_tpu/ops/fused_conv.py:_make_stack_kernel (reached
// through _stack_kernel_call and fused_conv_stack). For receivers sorted
// ascending and num_segments == N it gives
//
//   h_0 = x;   out_l[r, o] = Σ edge_act(Σ_i h_l[send_e, i]·W_l[i, o] + b_l[o])
//                            over the edges e of row r with mask[e] set
//   h_{l+1} = inter_act(out_l);   the result is out_{L-1} [N, H] f32
//
// in float32. Rows with no such edge are 0, so the next layer reads
// inter_act(0) there. A masked edge is skipped (a select, not a product by
// 0): its message is never formed, so edge_act of a masked slot (a sigmoid
// is not 0 at 0) cannot reach a sum. Edges at or past *real_edges (the
// batch's occupancy bound, every one of them masked) are not visited, on
// every layer.
//
// The design rests on one observation: an edge's pre-activation
// h_l[send_e]·W_l + b_l, and edge_act of it, depend on its sender alone.
// So each layer is
//   1. a node-level dense layer, Q_l = edge_act(inter_act(out_{l-1})·W_l + b_l)
//      over the N node rows instead of the E edge slots (21x fewer
//      products on the flagship batch), and
//   2. the masked sum of Q_l[send] by receiver: B8's identity walk (one
//      owner thread per (row, column) over its CSR row, edges in order).
// Both are computed here, 2L launches on the caller's stream with no
// host synchronisation (the product and the walk per layer), over the
// CSR row pointers of the receivers that the caller built once
// (row_pointers.cu). Between layers the two [N, H] f32 buffers (Q and
// out, 16.8 MB each at the flagship's N = 32,752, H = 128) stay in the
// card's 50 MB L2: the counterpart of the TPU kernel's VMEM residency.
//
// Numbers: the product sums over i in ascending order with fmaf from 0,
// adds b with __fadd_rn and applies edge_act as fused_conv.cu's per-edge
// branch does, and the walk adds the messages in edge order with
// __fadd_rn as B8 does. So every message equals the one B8 forms for the
// same edge, and with inter_act "none" or "relu" the stack equals a loop of
// B8 launches with relu applied between them, value for value. A sender
// outside [0, N) gets the message of a zero row, edge_act(b), as in B8.
//
// What bounds it on this card: per layer it reads h (N·H·4 bytes), the
// sender and receiver ids and the mask (9 bytes an edge slot), W and b, and
// writes out (N·H·4); the product is 2·N·H² operations. At the flagship's
// shapes and L = 6 the operations (6.4 GFLOP of products and 0.5 G adds,
// 0.104 ms at 67 TFLOP/s) outweigh the bytes (0.012 ms at 3.35 TB/s, each
// input read once). The
// product runs on the CUDA cores in a simple tiled form (W in shared
// memory, 32 rows a tile, 8 rows x 4 columns a thread); tensor cores
// (wgmma) are later work. The TPU mechanics of the original (the ping-pong
// VMEM pair, one-hot MXU window gathers and scatters, the 3-term bf16
// split, 128-lane padding, the window plan) have no counterpart here.

#include "common.cuh"

namespace {

constexpr int kRowTile = 32;               // node rows per product tile
constexpr int kTileStride = kRowTile + 4;  // float4-aligned, fewer bank conflicts
constexpr int kThreadRows = 8;             // rows a thread accumulates
constexpr int kThreadCols = 4;             // consecutive columns a thread accumulates
constexpr int kColThreads = 32;            // a warp spans 128 columns, one row group
constexpr int kProductThreads = kColThreads * (kRowTile / kThreadRows);  // 128
constexpr int kMaxSmem = 200 * 1024;

// q[r, o] = edge_act(Σ_i h[r, i]·w[i, o] + b[o]) for the rows of the tiles
// this block walks; h[r, i] = src[r, i], or inter_act(src[r, i]) when
// apply_inter (the previous layer's output). A tile is 32 rows; a warp
// takes 8 of them and 128 columns (4 consecutive a thread), in steps of
// 128 columns: per i a thread reads its 8 rows' values (two broadcast
// 16-byte loads) and its 4 columns of W (one 16-byte load) for 32 FMAs.
// W sits in shared memory with its rows padded to ``wp`` (a multiple of 4)
// columns of zeros when it fits, else it is read from global memory.
template <bool kSmemW>
__global__ void stack_product_kernel(const float* __restrict__ src, int apply_inter, int act_i,
                                     const float* __restrict__ w, const float* __restrict__ b,
                                     int act_e, long long n_rows, int h, int wp,
                                     float* __restrict__ q) {
  extern __shared__ float4 smem4[];
  float* smem = reinterpret_cast<float*>(smem4);
  float* h_s = smem;                              // [h][kTileStride], rows along the fast axis
  float* b_s = h_s + (long long)h * kTileStride;  // [wp]
  float* w_s = b_s + wp;                          // [h][wp] when kSmemW
  // The staging copies are latency-bound (8 warps an SM): with H a
  // multiple of 4 each thread keeps 8 independent 16-byte loads in flight.
  const bool vec = (h & 3) == 0;  // then wp == h and every row is 16-byte aligned
  if (kSmemW && vec) {
    const int n4 = h * h / 4;
#pragma unroll 8
    for (int k = threadIdx.x; k < n4; k += blockDim.x)
      reinterpret_cast<float4*>(w_s)[k] = reinterpret_cast<const float4*>(w)[k];
  } else if (kSmemW) {
    for (int i = 0; i < h; ++i)
      for (int o = threadIdx.x; o < wp; o += blockDim.x)
        w_s[i * wp + o] = o < h ? w[(long long)i * h + o] : 0.f;
  }
  for (int o = threadIdx.x; o < wp; o += blockDim.x) b_s[o] = (b != nullptr && o < h) ? b[o] : 0.f;
  const int lane = threadIdx.x % kColThreads;
  const int r_base = (threadIdx.x / kColThreads) * kThreadRows;
  const long long n_tiles = (n_rows + kRowTile - 1) / kRowTile;

  for (long long tile = blockIdx.x; tile < n_tiles; tile += gridDim.x) {
    const long long r0 = tile * kRowTile;
    __syncthreads();  // W and b staged; the previous tile's rows read
    if (vec) {
      const int per_row = h / 4;
#pragma unroll 8
      for (int k = threadIdx.x; k < kRowTile * per_row; k += blockDim.x) {
        const int r = k / per_row;
        const int i = 4 * (k - r * per_row);
        float4 v = make_float4(0.f, 0.f, 0.f, 0.f);
        if (r0 + r < n_rows) {
          v = reinterpret_cast<const float4*>(src + (r0 + r) * h)[i / 4];
          if (apply_inter)
            v = make_float4(act_f(act_i, v.x), act_f(act_i, v.y), act_f(act_i, v.z), act_f(act_i, v.w));
        }
        h_s[(i + 0) * kTileStride + r] = v.x;
        h_s[(i + 1) * kTileStride + r] = v.y;
        h_s[(i + 2) * kTileStride + r] = v.z;
        h_s[(i + 3) * kTileStride + r] = v.w;
      }
    } else {
      for (int r = 0; r < kRowTile; ++r) {
        const bool live = r0 + r < n_rows;
        for (int i = threadIdx.x; i < h; i += blockDim.x) {
          float v = 0.f;
          if (live) {
            v = src[(r0 + r) * h + i];
            if (apply_inter) v = act_f(act_i, v);
          }
          h_s[i * kTileStride + r] = v;
        }
      }
    }
    __syncthreads();
    for (int c0 = 0; c0 < h; c0 += kColThreads * kThreadCols) {
      const int col = c0 + lane * kThreadCols;
      if (col >= h) continue;
      float acc[kThreadRows][kThreadCols];
#pragma unroll
      for (int r = 0; r < kThreadRows; ++r)
#pragma unroll
        for (int c = 0; c < kThreadCols; ++c) acc[r][c] = 0.f;
      for (int i = 0; i < h; ++i) {
        float wv[kThreadCols];
        if (kSmemW) {
          const float4 w4 = *reinterpret_cast<const float4*>(w_s + (long long)i * wp + col);
          wv[0] = w4.x, wv[1] = w4.y, wv[2] = w4.z, wv[3] = w4.w;
        } else {
#pragma unroll
          for (int c = 0; c < kThreadCols; ++c) wv[c] = col + c < h ? w[(long long)i * h + col + c] : 0.f;
        }
        const float4* hv = reinterpret_cast<const float4*>(h_s + i * kTileStride + r_base);
#pragma unroll
        for (int r4 = 0; r4 < kThreadRows / 4; ++r4) {
          const float4 v = hv[r4];
          const float vr[4] = {v.x, v.y, v.z, v.w};
#pragma unroll
          for (int rr = 0; rr < 4; ++rr)
#pragma unroll
            for (int c = 0; c < kThreadCols; ++c)
              acc[4 * r4 + rr][c] = fmaf(vr[rr], wv[c], acc[4 * r4 + rr][c]);
        }
      }
#pragma unroll
      for (int r = 0; r < kThreadRows; ++r) {
        const long long row = r0 + r_base + r;
        if (row >= n_rows) continue;
#pragma unroll
        for (int c = 0; c < kThreadCols; ++c)
          if (col + c < h) q[row * h + col + c] = act_f(act_e, __fadd_rn(acc[r][c], b_s[col + c]));
      }
    }
  }
}

// out[r, o] = Σ q[send_e, o] over the edges e of row r with mask[e] set, in
// edge order (fused_conv.cu's identity walk); a sender outside [0, n_rows)
// contributes edge_act(b[o]).
__global__ void stack_walk_kernel(const float* __restrict__ q, const int32_t* __restrict__ send,
                                  const uint8_t* __restrict__ mask,
                                  const int32_t* __restrict__ ptr,
                                  const int32_t* __restrict__ real_edges, long long n_edges,
                                  long long n_rows, int h, const float* __restrict__ b, int act_e,
                                  int lpr_log2, float* __restrict__ out) {
  const int lpr = 1 << lpr_log2;
  const int lane = threadIdx.x & (lpr - 1);
  const long long row =
      (long long)blockIdx.x * (blockDim.x >> lpr_log2) + (threadIdx.x >> lpr_log2);
  if (row >= n_rows) return;
  const long long lo = ptr[row];
  long long hi = ptr[row + 1];
  const long long bound = edge_bound(real_edges, n_edges);
  hi = hi > bound ? bound : hi;
  for (int f = lane; f < h; f += lpr) {
    float s = 0.f;
    for (long long e = lo; e < hi; ++e) {
      if (!mask[e]) continue;
      const long long j = send[e];
      const float m = (j >= 0 && j < n_rows)
                          ? q[j * h + f]
                          : act_f(act_e, __fadd_rn(0.f, b != nullptr ? b[f] : 0.f));
      s = __fadd_rn(s, m);
    }
    out[row * h + f] = s;
  }
}

}  // namespace

// x [n_rows, h] f32; w [n_layers, h, h] f32; b [n_layers, h] f32 or null;
// send [n_edges] int32; mask [n_edges] bool; real_edges one int32 on the
// card or null. act_e, act_i: 0 none, 1 relu, 2 sigmoid, 3 softplus,
// 4 tanh, 5 silu. row_ptr: the n_rows + 1 int32 row pointers of the
// sorted receivers (row_pointers.cu); q: [n_rows, h] f32 scratch; out:
// [n_rows, h] f32. Returns a cudaError_t (0 = success).
extern "C" int hg_fused_conv_stack(const void* x, const void* send, const void* mask,
                                   const void* real_edges, long long n_edges, long long n_rows,
                                   int h, int n_layers, int act_e, int act_i, const void* w,
                                   const void* b, const void* row_ptr, void* q, void* out,
                                   void* stream) {
  if (n_rows <= 0 || n_edges < 0 || h <= 0 || n_layers <= 0 || act_e < 0 || act_e > 5 ||
      act_i < 0 || act_i > 5 || x == nullptr || w == nullptr || row_ptr == nullptr)
    return (int)cudaErrorInvalidValue;
  cudaStream_t s = (cudaStream_t)stream;
  // raise the dynamic shared memory limit once, at the first launch (never
  // inside a CUDA graph capture, which replays launches only)
  static bool limit_set = false;
  if (!limit_set) {
    for (const void* fn : {(const void*)stack_product_kernel<true>, (const void*)stack_product_kernel<false>}) {
      const cudaError_t err =
          cudaFuncSetAttribute(fn, cudaFuncAttributeMaxDynamicSharedMemorySize, kMaxSmem);
      if (err != cudaSuccess) return (int)err;
    }
    limit_set = true;
  }
  const int wp = (h + 3) & ~3;
  const long long stage_bytes = ((long long)h * kTileStride + wp) * 4;
  if (stage_bytes > kMaxSmem) return (int)cudaErrorInvalidValue;
  const long long w_bytes = (long long)h * wp * 4;
  const bool w_in_smem = stage_bytes + w_bytes <= kMaxSmem;
  const size_t smem = (size_t)(stage_bytes + (w_in_smem ? w_bytes : 0));
  const long long n_tiles = (n_rows + kRowTile - 1) / kRowTile;
  // W is staged once per block: as many blocks as fit on the card at once
  // (2 an SM with W at H = 128 in shared memory) walk all the tiles
  int per_sm = 1;
  cudaError_t err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(
      &per_sm, w_in_smem ? stack_product_kernel<true> : stack_product_kernel<false>, kProductThreads,
      smem);
  if (err != cudaSuccess) return (int)err;
  const long long resident = (long long)(per_sm > 0 ? per_sm : 1) * sm_count();
  const long long blocks = n_tiles < resident ? n_tiles : resident;
  const int lpr_log2 = lanes_log2(h);
  const long long rows_per_block = kThreads >> lpr_log2;
  const long long walk_blocks = (n_rows + rows_per_block - 1) / rows_per_block;
  for (int l = 0; l < n_layers; ++l) {
    const float* wl = (const float*)w + (long long)l * h * h;
    const float* bl = b != nullptr ? (const float*)b + (long long)l * h : nullptr;
    const float* src = l == 0 ? (const float*)x : (const float*)out;
    if (w_in_smem)
      stack_product_kernel<true><<<(unsigned)blocks, kProductThreads, smem, s>>>(
          src, l > 0, act_i, wl, bl, act_e, n_rows, h, wp, (float*)q);
    else
      stack_product_kernel<false><<<(unsigned)blocks, kProductThreads, smem, s>>>(
          src, l > 0, act_i, wl, bl, act_e, n_rows, h, wp, (float*)q);
    err = cudaGetLastError();
    if (err != cudaSuccess) return (int)err;
    stack_walk_kernel<<<(unsigned)walk_blocks, kThreads, 0, s>>>(
        (const float*)q, (const int32_t*)send, (const uint8_t*)mask, (const int32_t*)row_ptr,
        (const int32_t*)real_edges, n_edges, n_rows, h, bl, act_e, lpr_log2, (float*)out);
    err = cudaGetLastError();
    if (err != cudaSuccess) return (int)err;
  }
  return 0;
}
