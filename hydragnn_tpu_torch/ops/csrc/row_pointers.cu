// row_pointers.cu — the CSR row pointers of sorted receivers, for Hopper
// (sm_90a): the one pass behind every kernel that walks a receiver row's
// edges (B5, B6 and B7, B8, B9).
//
//   ptr[r] = the first edge whose receiver is >= r,   r in [0, n_rows]
//
// n_rows + 1 int32: a zero fill, then common.cuh:csr_row_ptr_kernel (one
// thread per edge fills the rows between its receiver and the one before;
// ids are clamped, so an out-of-range id drops its edge and every entry
// stays in [0, n_edges]). The fill is a kernel, not cudaMemsetAsync, whose
// node replays slower in a CUDA graph. The chassis builds the pointers
// once per forward (models/convs.py:EdgeContext.row_ptr) and hands them
// to every layer's call.
//
// What bounds it on this card: launches. It reads E·4 bytes and writes
// (N + 1)·4 (3.4 MB at the flagship training batch, about 1 µs at 3.35
// TB/s); two launches' latency is several times that. No TPU kernel
// corresponds: the Pallas kernels take their row offsets from XLA.

#include "common.cuh"

namespace {

__global__ void zero_kernel(int32_t* __restrict__ p, long long n) {
  const long long i = (long long)blockIdx.x * blockDim.x + threadIdx.x;
  if (i < n) p[i] = 0;
}

}  // namespace

// recv: n_edges sorted int32 receivers; row_ptr: n_rows + 1 int32, filled
// here. Returns a cudaError_t (0 = success).
extern "C" int hg_row_pointers(const void* recv, long long n_edges, long long n_rows,
                               void* row_ptr, void* stream) {
  if (n_rows <= 0 || n_edges < 0) return (int)cudaErrorInvalidValue;
  cudaStream_t s = (cudaStream_t)stream;
  zero_kernel<<<(unsigned)((n_rows + kThreads) / kThreads), kThreads, 0, s>>>((int32_t*)row_ptr,
                                                                             n_rows + 1);
  launch_row_ptr(recv, n_edges, n_rows, row_ptr, s);
  return (int)cudaGetLastError();
}
