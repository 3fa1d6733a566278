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
// an edge of another block inside a window is skipped by its id. An
// optional bound (*real_edges, read on the device and clamped to
// [0, n_edges], as common.cuh:edge_bound reads B8's) cuts every window at
// it: the caller's promise that the edges at or past it add nothing (a
// batch's masked tail past edge_occupancy, whose cotangent is zero), so
// they belong to no row and are never scanned or read.
//
// What bounds it on this card: bytes. The least time is
// (E·H·sizeof(data) + E·4 + N·H·4 [+ the window plan]) / 3.35 TB/s: every
// edge row read once, every output row written once; E is the bound where
// one is given.
//
// What the design does:
//   - Each row block's rows are split over CTAs of kRows = 32 rows (4 CTAs
//     a 128-row block: 1,024 CTAs of 256 threads at the flagship's 256
//     blocks, where one CTA a block left 7/8 of the card's threads idle).
//     Launch bounds hold a thread to 80 registers, 3 CTAs an SM (at 64
//     registers, 4 CTAs, it spills and runs 5% slower at the flagship).
//   - A CTA scans only its window's ids (4 bytes an edge), in chunks of
//     kChunk positions, so a window of any length works. Per chunk it
//     builds a stable per-row edge list in shared memory: each warp counts
//     its contiguous slice's edges per row, one warp scans the counts,
//     then each warp places its slice's edges in edge order (ranked within
//     32 positions by __match_any_sync). Only then does it touch data.
//   - Then one warp per output row (several rows a warp under 32 columns)
//     sums its edges' data rows: each lane owns a vector of columns (16
//     bytes at H = 128 f32; common.cuh:row_vector_bytes checks the row's
//     bytes and the base pointer) and issues U = 8 (4 for wide vectors)
//     row loads before it adds any of them. An edge row is read only by
//     the CTA whose rows hold its id, so each is read once.
//   - Each output element is summed in edge order with __fadd_rn, carried
//     in registers from chunk to chunk, and written once: no shared-memory
//     accumulator, no atomics. Two launches are bitwise equal and equal
//     the sequential float32 sum (index_add_ on the host) bit for bit.
//   - A row with more than kLong edges in a chunk (a batch's padding node,
//     a hub) would leave one lane group walking it with U rows in flight
//     while the CTA idles. There the whole CTA streams the row's data into
//     a ring of kStages shared-memory tiles by cp.async (kStages - 1 tiles
//     in flight), and the row's own lanes add each tile in edge order from
//     shared memory: the loads are split over the CTA, the sum is not.
// Whether the card wants the windows at all (against the sender_perm sort,
// or atomics) is ROADMAP B4's open question, answered by timing.

#include "common.cuh"

namespace {

constexpr int kWarps = 8;
constexpr int kCtaThreads = kWarps * 32;
constexpr int kRows = 32;                      // output rows a CTA (a warp's lanes scan them)
constexpr int kChunk = 2048;                   // window positions a scan chunk
constexpr int kPer = kChunk / kCtaThreads;     // positions a thread a chunk
constexpr int kRowsPerGroup = kRows / kWarps;  // rows a lane group sums, at most
constexpr int kLong = 64;                      // a row's edges in a chunk above which the CTA streams it
constexpr int kStages = 4;                     // the long-row ring's tiles
constexpr int kStageBytes = kChunk * 4;        // one tile: as large as `stage`, which is tile 0
constexpr int kSmemBytes = (2 * kChunk + kWarps * kRows + kRows + 4) * 4 + (kStages - 1) * kStageBytes;

// Ring slot k % kStages of the long-row ring: `stage` is slot 0.
__device__ __forceinline__ unsigned char* ring_slot(int* stage, unsigned char* rest, int k) {
  const int slot = k % kStages;
  return slot == 0 ? reinterpret_cast<unsigned char*>(stage) : rest + (slot - 1) * kStageBytes;
}

// The whole CTA copies ne edges' rows (positions cb + pos[u]), vectors
// [c0, c0 + nvp) of V bytes each, into dst, edge u at u * tile_bytes.
template <int V>
__device__ __forceinline__ void issue_tile(unsigned char* dst, const char* db, size_t row_bytes,
                                           long long cb, const int* pos, int ne, int c0, int nvp,
                                           int tile_bytes) {
  for (int p = threadIdx.x; p < ne * nvp; p += kCtaThreads) {
    const int u = p / nvp;
    const int q = p - u * nvp;
    const char* src = db + (size_t)(cb + pos[u]) * row_bytes + (size_t)(c0 + q) * V;
    if constexpr (V >= 4)
      copy_async<V>(dst + u * tile_bytes + q * V, src);
    else
      *reinterpret_cast<uint16_t*>(dst + u * tile_bytes + q * V) = *reinterpret_cast<const uint16_t*>(src);
  }
}

// nv: the row's vectors of V bytes. A lane group of 2^g_log2 lanes sums a
// row; 32 >> g_log2 groups share a warp. A lane owns vectors gl, gl + G,
// ..., VPL of them a pass; wider rows take further passes over the window.
template <typename T, int V, int VPL>
__global__ void __launch_bounds__(kCtaThreads, 3)
    segment_sum_local_kernel(const T* __restrict__ data, const int32_t* __restrict__ ids,
                             const int32_t* __restrict__ win, const int32_t* __restrict__ real_edges,
                             long long n_edges, int n_blocks, int block_rows, int ctas_per_block,
                             long long n_rows, int h, int nv, int g_log2, float* __restrict__ out) {
  constexpr int EPV = V / (int)sizeof(T);
  constexpr int U = VPL * EPV <= 4 ? 8 : 4;
  extern __shared__ __align__(16) int smem[];
  int* stage = smem;                       // a position's local row, or -1
  int* list = stage + kChunk;              // the chunk's positions grouped by row, in edge order
  int(*cnt)[kRows] = reinterpret_cast<int(*)[kRows]>(list + kChunk);  // per warp slice:
                                           // counts, then placement offsets
  int* start = list + kChunk + kWarps * kRows;  // each row's first list entry
  // the long-row ring: tile 0 is `stage` (free while rows are summed)
  unsigned char* ring_rest = reinterpret_cast<unsigned char*>(start + kRows + 4);

  const int warp = threadIdx.x >> 5;
  const int lane = threadIdx.x & 31;
  const int blk = blockIdx.x / ctas_per_block;
  const int part = blockIdx.x - blk * ctas_per_block;
  const long long row0 = (long long)blk * block_rows + (long long)part * kRows;
  long long rows_ll = kRows;
  if (block_rows - (long long)part * kRows < rows_ll) rows_ll = block_rows - (long long)part * kRows;
  if (n_rows - row0 < rows_ll) rows_ll = n_rows - row0;
  if (rows_ll <= 0) return;  // the whole CTA
  const int rows = (int)rows_ll;
  const long long bound = edge_bound(real_edges, n_edges);
  long long lo = win[blk];
  long long hi = win[n_blocks + blk];
  lo = lo < 0 ? 0 : lo;
  hi = hi > bound ? bound : hi;

  const int G = 1 << g_log2;
  const int groups = kWarps * (32 >> g_log2);
  const int grp = warp * (32 >> g_log2) + (lane >> g_log2);
  const int gl = lane & (G - 1);
  const size_t row_bytes = (size_t)h * sizeof(T);
  const char* db = reinterpret_cast<const char*>(data);
  const int slice = warp * 32 * kPer;  // this warp's positions in a chunk

  for (int i = threadIdx.x; i < kWarps * kRows; i += kCtaThreads) (&cnt[0][0])[i] = 0;
  __syncthreads();

  for (int c0 = 0; c0 < nv; c0 += G * VPL) {
    float acc[kRowsPerGroup][VPL][EPV];
#pragma unroll
    for (int k = 0; k < kRowsPerGroup; ++k)
#pragma unroll
      for (int q = 0; q < VPL; ++q)
#pragma unroll
        for (int i = 0; i < EPV; ++i) acc[k][q][i] = 0.f;

    for (long long cb = lo; cb < hi; cb += kChunk) {
      // 1. each position's local row; per-slice counts
      int id[kPer];
#pragma unroll
      for (int i = 0; i < kPer; ++i) {
        const long long e = cb + slice + i * 32 + lane;
        id[i] = e < hi ? ids[e] : -1;
      }
#pragma unroll
      for (int i = 0; i < kPer; ++i) {
        const long long e = cb + slice + i * 32 + lane;
        const long long d = (long long)id[i] - row0;
        const int r = (e < hi && d >= 0 && d < rows) ? (int)d : -1;
        stage[slice + i * 32 + lane] = r;
        if (r >= 0) atomicAdd(&cnt[warp][r], 1);
      }
      __syncthreads();
      // 2. row starts and each slice's offsets (one warp, a lane a row)
      if (warp == 0) {
        int tot = 0;
#pragma unroll
        for (int w = 0; w < kWarps; ++w) tot += cnt[w][lane];
        int incl = tot;
#pragma unroll
        for (int d = 1; d < 32; d <<= 1) {
          const int t = __shfl_up_sync(kFullWarp, incl, d);
          if (lane >= d) incl += t;
        }
        start[lane] = incl - tot;
        if (lane == 31) start[kRows] = incl;
        int run = incl - tot;
#pragma unroll
        for (int w = 0; w < kWarps; ++w) {
          const int t = cnt[w][lane];
          cnt[w][lane] = run;
          run += t;
        }
      }
      __syncthreads();
      // 3. place each slice's edges in edge order
      const unsigned lower = (1u << lane) - 1u;
#pragma unroll
      for (int i = 0; i < kPer; ++i) {
        const int pos = slice + i * 32 + lane;
        const int r = stage[pos];
        const unsigned peers = __match_any_sync(kFullWarp, r);
        if (r >= 0) list[cnt[warp][r] + __popc(peers & lower)] = pos;
        __syncwarp();
        if (r >= 0 && lane == __ffs(peers) - 1) cnt[warp][r] += __popc(peers);
        __syncwarp();
      }
      __syncthreads();
      // 4. clear the counts for the next chunk; sum this chunk's rows
      for (int i = threadIdx.x; i < kWarps * kRows; i += kCtaThreads) (&cnt[0][0])[i] = 0;
#pragma unroll
      for (int k = 0; k < kRowsPerGroup; ++k) {
        const int r = grp + k * groups;
        if (r >= rows || start[r + 1] - start[r] > kLong) continue;
        const int pe = start[r + 1];
        for (int p = start[r]; p < pe; p += U) {
          long long src[U];
#pragma unroll
          for (int u = 0; u < U; ++u) src[u] = p + u < pe ? cb + list[p + u] : -1;
          float v[U][VPL][EPV];
#pragma unroll
          for (int u = 0; u < U; ++u)
#pragma unroll
            for (int q = 0; q < VPL; ++q) {
              const int col = c0 + q * G + gl;
#pragma unroll
              for (int i = 0; i < EPV; ++i) v[u][q][i] = 0.f;
              if (src[u] >= 0 && col < nv)
                load_vec<T, V>(db + (size_t)src[u] * row_bytes + (size_t)col * V, v[u][q]);
            }
#pragma unroll
          for (int u = 0; u < U; ++u) {
            if (src[u] < 0) continue;
#pragma unroll
            for (int q = 0; q < VPL; ++q)
#pragma unroll
              for (int i = 0; i < EPV; ++i) acc[k][q][i] = __fadd_rn(acc[k][q][i], v[u][q][i]);
          }
        }
      }
      // 5. the long rows: the CTA streams each one's data through the ring,
      // its own lanes add it in edge order
      const int nvp = nv - c0 < G * VPL ? nv - c0 : G * VPL;  // this pass's vectors
      const int tile_bytes = nvp * V;
      int te = kStageBytes / tile_bytes;  // edges a tile
      te = te > kChunk ? kChunk : te;
      // (rows taken as (k, group) pairs, so that the owner's accumulator
      // acc[k] has a compile-time index and stays in registers)
#pragma unroll
      for (int k = 0; k < kRowsPerGroup; ++k) {
        for (int g = 0; g < groups; ++g) {
          const int r = g + k * groups;
          if (r >= rows) break;  // the same in every thread
          const int rs = start[r];
          const int c = start[r + 1] - rs;
          if (c <= kLong) continue;
          const int tiles = (c + te - 1) / te;
          for (int t = 0; t < kStages - 1; ++t) {
            if (t < tiles)
              issue_tile<V>(ring_slot(stage, ring_rest, t), db, row_bytes, cb, list + rs + t * te,
                            c - t * te < te ? c - t * te : te, c0, nvp, tile_bytes);
            copy_async_commit();
          }
          for (int t = 0; t < tiles; ++t) {
            copy_async_wait<kStages - 2>();  // this thread's copies of tile t have landed
            __syncthreads();                 // everyone's have; tile t - 1 is summed
            const int tn = t + kStages - 1;
            if (tn < tiles)
              issue_tile<V>(ring_slot(stage, ring_rest, tn), db, row_bytes, cb, list + rs + tn * te,
                            c - tn * te < te ? c - tn * te : te, c0, nvp, tile_bytes);
            copy_async_commit();
            if (grp != g) continue;
            const char* buf = reinterpret_cast<const char*>(ring_slot(stage, ring_rest, t)) + (size_t)gl * V;
            const int ne = c - t * te < te ? c - t * te : te;
#pragma unroll 4
            for (int u = 0; u < ne; ++u)
#pragma unroll
              for (int q = 0; q < VPL; ++q) {
                if (c0 + q * G + gl >= nv) continue;
                float f[EPV];
                load_vec<T, V>(buf + (size_t)u * tile_bytes + (size_t)q * G * V, f);
#pragma unroll
                for (int i = 0; i < EPV; ++i) acc[k][q][i] = __fadd_rn(acc[k][q][i], f[i]);
              }
          }
          copy_async_wait<0>();
          __syncthreads();  // the ring is free for the next long row
        }
      }
      __syncthreads();
    }

#pragma unroll
    for (int k = 0; k < kRowsPerGroup; ++k) {
      const int r = grp + k * groups;
      if (r >= rows) continue;
#pragma unroll
      for (int q = 0; q < VPL; ++q) {
        const int col = c0 + q * G + gl;
        if (col >= nv) continue;
        float* dst = out + (size_t)(row0 + r) * h + (size_t)col * EPV;
#pragma unroll
        for (int i = 0; i < EPV; ++i) dst[i] = acc[k][q][i];
      }
    }
  }
}

template <typename T, int V>
int launch_v(const void* data, const void* ids, const void* win, const void* real_edges, long long n_edges,
             int n_blocks, int block_rows, long long n_rows, int h, void* out, cudaStream_t stream) {
  if constexpr (V < (int)sizeof(T)) {
    return (int)cudaErrorInvalidValue;
  } else {
    const int nv = (int)((long long)h * sizeof(T) / V);
    const int g_log2 = nv >= 32 ? 5 : lanes_log2(nv);
    const int ctas_per_block = (block_rows + kRows - 1) / kRows;
    const long long grid = (long long)n_blocks * ctas_per_block;
    if (grid > 0x7fffffffLL) return (int)cudaErrorInvalidValue;
    if (nv <= 32)
      segment_sum_local_kernel<T, V, 1><<<(unsigned)grid, kCtaThreads, kSmemBytes, stream>>>(
          (const T*)data, (const int32_t*)ids, (const int32_t*)win, (const int32_t*)real_edges, n_edges,
          n_blocks, block_rows, ctas_per_block, n_rows, h, nv, g_log2, (float*)out);
    else
      segment_sum_local_kernel<T, V, 2><<<(unsigned)grid, kCtaThreads, kSmemBytes, stream>>>(
          (const T*)data, (const int32_t*)ids, (const int32_t*)win, (const int32_t*)real_edges, n_edges,
          n_blocks, block_rows, ctas_per_block, n_rows, h, nv, g_log2, (float*)out);
    return (int)cudaGetLastError();
  }
}

template <typename T>
int launch(const void* data, const void* ids, const void* win, const void* real_edges, long long n_edges,
           int n_blocks, int block_rows, long long n_rows, int h, void* out, cudaStream_t stream) {
  const int v = row_vector_bytes((long long)h * sizeof(T), (uintptr_t)data, (int)sizeof(T));
  switch (v) {
    case 16:
      return launch_v<T, 16>(data, ids, win, real_edges, n_edges, n_blocks, block_rows, n_rows, h, out,
                              stream);
    case 8:
      return launch_v<T, 8>(data, ids, win, real_edges, n_edges, n_blocks, block_rows, n_rows, h, out,
                              stream);
    case 4:
      return launch_v<T, 4>(data, ids, win, real_edges, n_edges, n_blocks, block_rows, n_rows, h, out,
                              stream);
    case 2:
      return launch_v<T, 2>(data, ids, win, real_edges, n_edges, n_blocks, block_rows, n_rows, h, out,
                              stream);
    default:
      return (int)cudaErrorMisalignedAddress;
  }
}

}  // namespace

// dtype: 0 = float32, 1 = bfloat16. win: int32 [2, n_blocks] (row 0 the
// window starts, row 1 the ends). block_rows x n_blocks >= n_rows.
// real_edges: null (no bound), or one int32 on the device.
// Returns a cudaError_t (0 = success).
extern "C" int hg_segment_sum_local(const void* data, int dtype, const void* ids,
                                    const void* win, const void* real_edges, long long n_edges,
                                    int n_blocks, int block_rows, long long n_rows, int h, void* out,
                                    void* stream) {
  if (n_rows <= 0 || h <= 0 || n_edges < 0 || n_blocks <= 0 || block_rows <= 0 ||
      (long long)n_blocks * block_rows < n_rows)
    return (int)cudaErrorInvalidValue;
  cudaStream_t s = (cudaStream_t)stream;
  if (dtype == 0)
    return launch<float>(data, ids, win, real_edges, n_edges, n_blocks, block_rows, n_rows, h, out, s);
  if (dtype == 1)
    return launch<__nv_bfloat16>(data, ids, win, real_edges, n_edges, n_blocks, block_rows, n_rows, h,
                                 out, s);
  return (int)cudaErrorInvalidValue;
}
