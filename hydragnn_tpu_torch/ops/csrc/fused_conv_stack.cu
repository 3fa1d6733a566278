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
//   1. a node-level dense layer, Q_l = edge_act(h_l·W_l + b_l) over the N
//      node rows instead of the E edge slots (21x fewer products on the
//      flagship batch), and
//   2. the masked sum of Q_l[send] by receiver, which writes
//      h_{l+1} = inter_act(out_l) (out_{L-1} itself after the last layer).
// Both are computed here, 2L launches on the caller's stream with no
// allocation or host synchronisation (a product and a walk per layer), over
// the CSR row pointers of the receivers that the caller built once
// (row_pointers.cu). Between layers the two [N, H] f32 buffers (Q and h,
// 16.8 MB each at the flagship's N = 32,752, H = 128) stay in the card's
// 50 MB L2: the counterpart of the TPU kernel's VMEM residency.
//
// Numbers (the contract): the product sums over i in ascending order with
// fmaf from 0, adds b with __fadd_rn and applies edge_act, as
// fused_conv.cu's per-edge branch does, and the walk adds the messages in
// edge order with __fadd_rn as B8 does. So every message equals the one B8
// forms for the same edge, and with inter_act "none" or "relu" the stack
// equals a loop of B8 launches with relu applied between them, value for
// value. A live slot whose sender lies outside [0, N) gets the message of a
// zero row, edge_act(b), as B8's per-edge branch gives it (B8's identity
// walk, which has no bias, drops such a slot instead): the product also
// writes Q's row N from a zero row of x, and the walk reads that row for
// such a slot. No split of the sum over i, no reordering, no tensor cores:
// each would end that equality.
//
// What bounds it on this card: per layer the product is 2·N·H² operations
// and the walk reads Q (N·H·4 bytes), the senders and the mask (5 bytes an
// edge slot) and the row pointers and writes h (N·H·4). At the flagship's
// shapes (N = 32,752, H = 128, 810,888 slots) a layer's product is 1.07
// GFLOP, 0.0160 ms at the card's 67 TFLOP/s of f32 FMA, and its walk
// 37.7 MB, 0.01126 ms at 3.35 TB/s; the whole op (6 layers, each input
// read once) is bound by operations.
//
// The node product (stack_product_kernel), for H a multiple of 32 whose W
// column slab fits in shared memory (H ≤ 256):
//   - Persistent blocks of 256 threads, one an SM (121 KB of shared memory
//     at H = 128, 187 KB at 256); blockIdx.y picks a slab of 128 output
//     columns. A block stages its slab of W_l ([H, 128], 64 KB at H = 128)
//     and of b_l once, then walks tiles of 128 rows, the grid's stride
//     apart. At N = 32,752 that is 256 tiles on 132 SMs, two a block.
//   - The rows of x come through a ring of 3 stages of [128 rows × 32 k]
//     (18 KB each, rows padded to 36 floats) filled by 16-byte cp.async
//     (zero-filled past N), two stages ahead of the FMAs: the loads of the
//     next chunk overlap this chunk's products, one barrier a chunk.
//   - A thread holds an 8 × 8 register tile: rows 4t..4t+3 and 64 + 4t..,
//     columns 4c..4c+3 and 64 + 4c.. (t = thread / 16, c = thread % 16).
//     Per 4 k it reads its 8 rows' 4 values (8 LDS.128; the 16 lanes of a
//     half-warp read one address, the two halves rows 4 apart, 16 banks
//     apart) and per k the two 16-byte quads of W (2 LDS.128; 16 lanes on
//     256 contiguous bytes): 64 FMAs for 4 shared loads, conflict-free.
//     The chunk's 32 k are unrolled whole.
//   - Epilogue: __fadd_rn(b), edge_act, two 16-byte stores a row. edge_act
//     is a template parameter: a runtime switch there made the kernel
//     several times slower on the card.
//   - Tile shape: 128-row tiles at one block an SM and 64-row tiles at two
//     (the same 8 warps an SM, the same wave count) timed alike on the
//     card; with 128 rows W is staged once an SM, not twice.
// Other widths, and wider W, take stack_product_simple_kernel: a thread an
// output, the same fmaf chain, W read from global memory (on no shipped
// path).
//
// The walk (stack_walk_kernel) is B8's warp walk (common.cuh:warp_walk): a
// warp a receiver row, a 16-byte vector of columns a lane at H = 128, the
// mask and sender of 32 slots at once by ballot, 8 row loads in flight;
// its epilogue applies inter_act (once an element, rather than 16 times in
// the next product's inner loop) and stores 16-byte vectors. At H = 1,
// stack_walk_h1_kernel: a group of 8 lanes a row (common.cuh:group_walk).
//
// The TPU mechanics of the original (the ping-pong VMEM pair, one-hot MXU
// window gathers and scatters, the 3-term bf16 split, 128-lane padding,
// the window plan) have no counterpart here.

#include "common.cuh"

namespace {

constexpr int kTileRows = 128;              // node rows a product tile
constexpr int kSlabCols = 128;              // output columns a block owns
constexpr int kKc = 32;                     // k a ring stage
constexpr int kXStride = kKc + 4;           // a stage row, in floats (16-byte aligned)
constexpr int kStages = 3;                  // the ring's stages
constexpr int kProductThreads = 256;        // 16 row groups x 16 column groups
constexpr int kStageFloats = kTileRows * kXStride;
constexpr int kMaxSmem = 227 * 1024;        // the most a block may ask for

long long product_smem_bytes(int h) {
  return ((long long)h * kSlabCols + kSlabCols + (long long)kStages * kStageFloats) * 4;
}

// A 16-byte global -> shared copy, zero-filled (nothing read) when !live.
__device__ __forceinline__ void copy16_async(float* dst, const float* src, bool live) {
  const unsigned d = (unsigned)__cvta_generic_to_shared(dst);
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::"r"(d), "l"(src), "r"(live ? 16 : 0)
               : "memory");
}
__device__ __forceinline__ void copy_commit() { asm volatile("cp.async.commit_group;\n" ::: "memory"); }
template <int N>
__device__ __forceinline__ void copy_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(N) : "memory");
}

// q[r, o] = edge_act(__fadd_rn(Σ_i x[r, i]·w[i, o], b[o])) for r in [0,
// n_rows], x's row n_rows read as zeros (the design notes above), with
// edge_act = ACT. h is a multiple of kKc; blockIdx.y is the column slab.
template <int ACT>
__global__ void __launch_bounds__(kProductThreads, 1)
    stack_product_kernel(const float* __restrict__ x, const float* __restrict__ w,
                         const float* __restrict__ b, long long n_rows, int h,
                         float* __restrict__ q) {
  extern __shared__ float4 smem4[];
  float* w_s = reinterpret_cast<float*>(smem4);  // [h][kSlabCols]
  float* b_s = w_s + (long long)h * kSlabCols;   // [kSlabCols]
  float* x_s = b_s + kSlabCols;                  // kStages x [kTileRows][kXStride]
  const int tid = threadIdx.x;
  const int tc = tid & 15, tr = tid >> 4;
  const int slab0 = blockIdx.y * kSlabCols;
  const long long tile_stride = gridDim.x;
  const long long n_tiles = (n_rows + kTileRows) / kTileRows;  // n_rows + 1 rows
  const long long first = blockIdx.x;
  const int n_kc = h / kKc;
  const long long my_tiles = first < n_tiles ? (n_tiles - first + tile_stride - 1) / tile_stride : 0;
  const long long n_steps = my_tiles * n_kc;

  // the slab of W and b (columns past h zero-filled), with the first stage
  for (int k = tid; k < h * (kSlabCols / 4); k += kProductThreads) {
    const int i = k / (kSlabCols / 4), c = 4 * (k % (kSlabCols / 4));
    const bool live = slab0 + c < h;
    copy16_async(w_s + i * kSlabCols + c, live ? w + (long long)i * h + slab0 + c : w, live);
  }
  for (int c = tid; c < kSlabCols; c += kProductThreads)
    b_s[c] = (b != nullptr && slab0 + c < h) ? b[slab0 + c] : 0.f;

  // stage s: rows of tile first + (s / n_kc)·tile_stride, k chunk s % n_kc
  auto load_stage = [&](long long s) {
    const long long r0 = (first + (s / n_kc) * tile_stride) * kTileRows;
    const int k0 = (int)(s % n_kc) * kKc;
    float* dst = x_s + (s % kStages) * kStageFloats;
#pragma unroll
    for (int t = 0; t < kTileRows * kKc / 4 / kProductThreads; ++t) {
      const int id = tid + t * kProductThreads;
      const int r = id / (kKc / 4), c = 4 * (id % (kKc / 4));
      const bool live = r0 + r < n_rows;
      copy16_async(dst + r * kXStride + c, live ? x + (r0 + r) * h + k0 + c : x, live);
    }
  };
  for (int s = 0; s < kStages - 1; ++s) {
    if (s < n_steps) load_stage(s);
    copy_commit();
  }

  float acc[8][8];
#pragma unroll
  for (int j = 0; j < 8; ++j)
#pragma unroll
    for (int c = 0; c < 8; ++c) acc[j][c] = 0.f;

  for (long long s = 0; s < n_steps; ++s) {
    copy_wait<kStages - 2>();  // stage s (and, at s = 0, W and b) has landed
    __syncthreads();           // for every thread; stage s - 1 is read
    if (s + kStages - 1 < n_steps) load_stage(s + kStages - 1);
    copy_commit();

    const float* xs = x_s + (s % kStages) * kStageFloats;
    const float* ws = w_s + (long long)(s % n_kc) * kKc * kSlabCols;
#pragma unroll
    for (int kk = 0; kk < kKc; kk += 4) {
      float xr[8][4];
#pragma unroll
      for (int j = 0; j < 8; ++j) {
        const int r = (j < 4 ? 0 : 64) + 4 * tr + (j & 3);
        load_f32<4>(xs + r * kXStride + kk, xr[j]);
      }
#pragma unroll
      for (int t = 0; t < 4; ++t) {
        float wv[2][4];
        load_f32<4>(ws + (kk + t) * kSlabCols + 4 * tc, wv[0]);
        load_f32<4>(ws + (kk + t) * kSlabCols + 64 + 4 * tc, wv[1]);
#pragma unroll
        for (int j = 0; j < 8; ++j)
#pragma unroll
          for (int c = 0; c < 8; ++c) acc[j][c] = fmaf(xr[j][t], wv[c >> 2][c & 3], acc[j][c]);
      }
    }

    if (s % n_kc == n_kc - 1) {  // the tile's last chunk: the epilogue
      const long long r0 = (first + (s / n_kc) * tile_stride) * kTileRows;
#pragma unroll
      for (int j = 0; j < 8; ++j) {
        const long long row = r0 + (j < 4 ? 0 : 64) + 4 * tr + (j & 3);
#pragma unroll
        for (int half = 0; half < 2; ++half) {
          const int c = half * 64 + 4 * tc;
          float o[4];
#pragma unroll
          for (int i = 0; i < 4; ++i) {
            o[i] = act_f(ACT, __fadd_rn(acc[j][4 * half + i], b_s[c + i]));
            acc[j][4 * half + i] = 0.f;
          }
          if (row <= n_rows && slab0 + c < h) store_f32<4>(q + row * h + slab0 + c, o);
        }
      }
    }
  }
  copy_wait<0>();  // no copy outlives the block
}

// The same q for any width: a thread an output, W from global memory.
__global__ void __launch_bounds__(kThreads)
    stack_product_simple_kernel(const float* __restrict__ x, const float* __restrict__ w,
                                const float* __restrict__ b, int act_e, long long n_rows, int h,
                                float* __restrict__ q) {
  const long long idx = (long long)blockIdx.x * kThreads + threadIdx.x;
  if (idx >= (n_rows + 1) * h) return;
  const long long r = idx / h;
  const int o = (int)(idx - r * h);
  float acc = 0.f;
  if (r < n_rows)
    for (int i = 0; i < h; ++i) acc = fmaf(x[r * h + i], w[(long long)i * h + o], acc);
  q[idx] = act_f(act_e, __fadd_rn(acc, b != nullptr ? b[o] : 0.f));
}

// out[r, o] = act_out(Σ q[send_e, o] over the edges e of row r with
// mask[e] set, in edge order): the warp walk (the design notes above); a
// sender outside [0, n_rows) reads q's row n_rows.
template <int V, int VPL>
__global__ void __launch_bounds__(kThreads)
    stack_walk_kernel(const float* __restrict__ q, const int32_t* __restrict__ send,
                      const uint8_t* __restrict__ mask, const int32_t* __restrict__ ptr,
                      const int32_t* __restrict__ real_edges, long long n_edges, long long n_rows,
                      int h, int nv, int act_out, float* __restrict__ out) {
  constexpr int EPV = V / 4;
  const int lane = threadIdx.x & 31;
  const long long row = (long long)blockIdx.x * (blockDim.x >> 5) + (threadIdx.x >> 5);
  if (row >= n_rows) return;  // the whole warp
  const long long lo = ptr[row];
  long long hi = ptr[row + 1];
  const long long bound = edge_bound(real_edges, n_edges);
  hi = hi > bound ? bound : hi;
  for (int c0 = 0; c0 < nv; c0 += 32 * VPL) {
    float acc[VPL][EPV];
    warp_walk<float, V, VPL, false, true>(q, send, mask, lo, hi, n_rows, h, c0, nv, nullptr, acc);
#pragma unroll
    for (int p = 0; p < VPL; ++p) {
      const int col = c0 + p * 32 + lane;
      if (col >= nv) continue;
      float o[EPV];
#pragma unroll
      for (int i = 0; i < EPV; ++i) o[i] = act_f(act_out, acc[p][i]);
      store_f32<EPV>(out + row * h + (long long)col * EPV, o);
    }
  }
}

// The same at one column: a group of 8 lanes a row (common.cuh:group_walk).
__global__ void __launch_bounds__(kThreads)
    stack_walk_h1_kernel(const float* __restrict__ q, const int32_t* __restrict__ send,
                         const uint8_t* __restrict__ mask, const int32_t* __restrict__ ptr,
                         const int32_t* __restrict__ real_edges, long long n_edges,
                         long long n_rows, int act_out, float* __restrict__ out) {
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
        if (e >= hi || !mask[e]) return false;
        const int j = send[e];
        m = q[(j >= 0 && j < n_rows) ? j : n_rows];
        return true;
      },
      [&](float v) { acc = __fadd_rn(acc, v); });
  if (own && (threadIdx.x & (kGroup - 1)) == 0) out[row] = act_f(act_out, acc);
}

// The product kernel of each edge activation (ActCode order).
const void* const kProducts[] = {
    (const void*)stack_product_kernel<kNone>, (const void*)stack_product_kernel<kRelu>,
    (const void*)stack_product_kernel<kSigmoid>, (const void*)stack_product_kernel<kSoftplus>,
    (const void*)stack_product_kernel<kTanh>, (const void*)stack_product_kernel<kSilu>};

template <int ACT>
int launch_product(dim3 grid, size_t smem, cudaStream_t s, const float* x, const float* w,
                   const float* b, long long n_rows, int h, float* q) {
  stack_product_kernel<ACT><<<grid, kProductThreads, smem, s>>>(x, w, b, n_rows, h, q);
  return (int)cudaGetLastError();
}

int product(int act_e, dim3 grid, size_t smem, cudaStream_t s, const float* x, const float* w,
            const float* b, long long n_rows, int h, float* q) {
  switch (act_e) {
    case kRelu:
      return launch_product<kRelu>(grid, smem, s, x, w, b, n_rows, h, q);
    case kSigmoid:
      return launch_product<kSigmoid>(grid, smem, s, x, w, b, n_rows, h, q);
    case kSoftplus:
      return launch_product<kSoftplus>(grid, smem, s, x, w, b, n_rows, h, q);
    case kTanh:
      return launch_product<kTanh>(grid, smem, s, x, w, b, n_rows, h, q);
    case kSilu:
      return launch_product<kSilu>(grid, smem, s, x, w, b, n_rows, h, q);
    default:
      return launch_product<kNone>(grid, smem, s, x, w, b, n_rows, h, q);
  }
}

template <int V>
int launch_walk(const float* q, const int32_t* send, const uint8_t* mask, const int32_t* ptr,
                const int32_t* real_edges, long long n_edges, long long n_rows, int h, int act_out,
                float* out, cudaStream_t s) {
  const int nv = h * 4 / V;
  const unsigned blocks = (unsigned)((n_rows + kThreads / 32 - 1) / (kThreads / 32));
  if (nv <= 32)
    stack_walk_kernel<V, 1><<<blocks, kThreads, 0, s>>>(q, send, mask, ptr, real_edges, n_edges, n_rows,
                                                        h, nv, act_out, out);
  else
    stack_walk_kernel<V, 2><<<blocks, kThreads, 0, s>>>(q, send, mask, ptr, real_edges, n_edges, n_rows,
                                                        h, nv, act_out, out);
  return (int)cudaGetLastError();
}

int walk(const float* q, const int32_t* send, const uint8_t* mask, const int32_t* ptr,
         const int32_t* real_edges, long long n_edges, long long n_rows, int h, int act_out,
         float* out, cudaStream_t s) {
  if (h == 1) {
    const unsigned blocks = (unsigned)((n_rows + kThreads / kGroup - 1) / (kThreads / kGroup));
    stack_walk_h1_kernel<<<blocks, kThreads, 0, s>>>(q, send, mask, ptr, real_edges, n_edges, n_rows,
                                                     act_out, out);
    return (int)cudaGetLastError();
  }
  const uintptr_t align = (uintptr_t)q | (uintptr_t)out;
  switch (row_vector_bytes((long long)h * 4, align, 4)) {
    case 16:
      return launch_walk<16>(q, send, mask, ptr, real_edges, n_edges, n_rows, h, act_out, out, s);
    case 8:
      return launch_walk<8>(q, send, mask, ptr, real_edges, n_edges, n_rows, h, act_out, out, s);
    case 4:
      return launch_walk<4>(q, send, mask, ptr, real_edges, n_edges, n_rows, h, act_out, out, s);
    default:
      return (int)cudaErrorMisalignedAddress;
  }
}

}  // namespace

// x [n_rows, h] f32; w [n_layers, h, h] f32; b [n_layers, h] f32 or null;
// send [n_edges] int32; mask [n_edges] bool; real_edges one int32 on the
// card or null. act_e, act_i: 0 none, 1 relu, 2 sigmoid, 3 softplus,
// 4 tanh, 5 silu. row_ptr: the n_rows + 1 int32 row pointers of the
// sorted receivers (row_pointers.cu); q: [n_rows + 1, h] f32 scratch; out:
// [n_rows, h] f32, which also holds each intermediate h_{l+1}. Returns a
// cudaError_t (0 = success).
extern "C" int hg_fused_conv_stack(const void* x, const void* send, const void* mask,
                                   const void* real_edges, long long n_edges, long long n_rows,
                                   int h, int n_layers, int act_e, int act_i, const void* w,
                                   const void* b, const void* row_ptr, void* q, void* out,
                                   void* stream) {
  if (n_rows <= 0 || n_edges < 0 || h <= 0 || n_layers <= 0 || act_e < 0 || act_e > 5 ||
      act_i < 0 || act_i > 5 || x == nullptr || w == nullptr || row_ptr == nullptr)
    return (int)cudaErrorInvalidValue;
  cudaStream_t s = (cudaStream_t)stream;
  // raise the dynamic shared memory limit once, at the first call (never
  // inside a CUDA graph capture, which replays launches only)
  static bool limit_set = false;
  if (!limit_set) {
    for (const void* fn : kProducts) {
      const cudaError_t err = cudaFuncSetAttribute(fn, cudaFuncAttributeMaxDynamicSharedMemorySize, kMaxSmem);
      if (err != cudaSuccess) return (int)err;
    }
    limit_set = true;
  }
  const uintptr_t align = (uintptr_t)x | (uintptr_t)q | (uintptr_t)out | (uintptr_t)w;
  const bool tiled = h % kKc == 0 && align % 16 == 0 && product_smem_bytes(h) <= kMaxSmem;
  // persistent blocks: one an SM, spread over the column slabs
  const unsigned n_slabs = (unsigned)((h + kSlabCols - 1) / kSlabCols);
  const long long n_tiles = (n_rows + kTileRows) / kTileRows;  // n_rows + 1 rows
  long long per_slab = (sm_count() + n_slabs - 1) / n_slabs;
  per_slab = per_slab < n_tiles ? per_slab : n_tiles;
  const dim3 product_grid((unsigned)per_slab, n_slabs);
  const unsigned simple_blocks = (unsigned)(((n_rows + 1) * h + kThreads - 1) / kThreads);
  for (int l = 0; l < n_layers; ++l) {
    const float* wl = (const float*)w + (long long)l * h * h;
    const float* bl = b != nullptr ? (const float*)b + (long long)l * h : nullptr;
    const float* src = l == 0 ? (const float*)x : (const float*)out;
    int rc;
    if (tiled) {
      rc = product(act_e, product_grid, (size_t)product_smem_bytes(h), s, src, wl, bl, n_rows, h, (float*)q);
    } else {
      stack_product_simple_kernel<<<simple_blocks, kThreads, 0, s>>>(src, wl, bl, act_e, n_rows, h, (float*)q);
      rc = (int)cudaGetLastError();
    }
    if (rc != 0) return rc;
    // every layer but the last writes h_{l+1} = inter_act(out_l)
    const int act_out = l + 1 < n_layers ? act_i : 0;
    rc = walk((const float*)q, (const int32_t*)send, (const uint8_t*)mask, (const int32_t*)row_ptr,
              (const int32_t*)real_edges, n_edges, n_rows, h, act_out, (float*)out, s);
    if (rc != 0) return rc;
  }
  return 0;
}
