// L1-L3: the GPU health ladder's three probes (madrona_renderer_tpu_torch/
// ladder.py), each the smallest kernel that exercises one thing the render
// kernels depend on.
//
// Replace tools/tpu_ladder.py's Pallas probes:
//   L1 copy (pallas_copy, :33-49, launched at :43): o = x * 2 on one
//     [8, 128] f32 block: a launch, a global read and a write;
//   L2 grid_smem (pallas_grid_smem, :52-74, launched at :64): a grid of
//     blocks, each adding its own scalar, staged in shared memory by one
//     thread behind a barrier, to its [8, 128] slab (the TPU probe's SMEM
//     scalar per grid step);
//   L3 fori_smem (pallas_fori_smem, :77-100, launched at :94): per block the
//     sum of one row of n floats held in shared memory (row 0 of the
//     block's [3, n] slab), added in index order from 0 as the TPU probe's
//     fori_loop does, broadcast into the block's [8, 128] output.
// Their plain PyTorch versions are ladder.py's *_plain; the sums are exact
// here (small integers), and the kernels round as the plain versions do.
//
// Bound on an H100: a few kilobytes each way, a few thousand FP32
// operations: each is bound by its launch, some microseconds, far above the
// bytes' nanoseconds (chip_smoke.py states both). The design is the
// simple one: 256 threads a block, each thread a strided part of the
// block's 1,024 outputs.

#include <cuda_runtime.h>

namespace {

constexpr int kThreads = 256;
constexpr int kSlab = 8 * 128;   // one [8, 128] block of outputs
constexpr int kMaxRow = 1024;    // L3's row, in shared memory

__global__ void __launch_bounds__(kThreads) copy_kernel(const float* x, float* out) {
  const float* xb = x + (size_t)blockIdx.x * kSlab;
  float* ob = out + (size_t)blockIdx.x * kSlab;
  for (int i = threadIdx.x; i < kSlab; i += kThreads) ob[i] = xb[i] * 2.0f;
}

__global__ void __launch_bounds__(kThreads)
grid_smem_kernel(const float* x, const float* s, float* out) {
  __shared__ float s_val;
  if (threadIdx.x == 0) s_val = s[blockIdx.x];
  __syncthreads();
  const float* xb = x + (size_t)blockIdx.x * kSlab;
  float* ob = out + (size_t)blockIdx.x * kSlab;
  for (int i = threadIdx.x; i < kSlab; i += kThreads) ob[i] = xb[i] + s_val;
}

__global__ void __launch_bounds__(kThreads)
fori_smem_kernel(const float* rows, int n, float* out) {
  __shared__ float s_row[kMaxRow];
  const float* rb = rows + (size_t)blockIdx.x * 3 * n;  // row 0 of [3, n]
  for (int j = threadIdx.x; j < n; j += kThreads) s_row[j] = rb[j];
  __syncthreads();
  float total = 0.0f;  // every thread sums the row in index order
  for (int j = 0; j < n; ++j) total = total + s_row[j];
  float* ob = out + (size_t)blockIdx.x * kSlab;
  for (int i = threadIdx.x; i < kSlab; i += kThreads) ob[i] = total;
}

}  // namespace

extern "C" {

// Each entry launches its probe on `stream`, one 256-thread block per
// [8, 128] output slab (`blocks` of them), and returns cudaGetLastError()
// after the launch (0 on success), or cudaErrorInvalidValue for a bad size.
// x: [blocks, 8, 128]; s: [blocks] (L2 only, else null); n: L3's row length
// (x is then [blocks, 3, n]), else ignored.
int mrt_ladder_copy(const float* x, const float* s, float* out, int blocks, int n,
                    void* stream) {
  (void)s;
  (void)n;
  if (blocks < 1) return (int)cudaErrorInvalidValue;
  copy_kernel<<<blocks, kThreads, 0, (cudaStream_t)stream>>>(x, out);
  return (int)cudaGetLastError();
}

int mrt_ladder_grid_smem(const float* x, const float* s, float* out, int blocks, int n,
                         void* stream) {
  (void)n;
  if (blocks < 1 || s == nullptr) return (int)cudaErrorInvalidValue;
  grid_smem_kernel<<<blocks, kThreads, 0, (cudaStream_t)stream>>>(x, s, out);
  return (int)cudaGetLastError();
}

int mrt_ladder_fori_smem(const float* x, const float* s, float* out, int blocks, int n,
                         void* stream) {
  (void)s;
  if (blocks < 1 || n < 1 || n > kMaxRow) return (int)cudaErrorInvalidValue;
  fori_smem_kernel<<<blocks, kThreads, 0, (cudaStream_t)stream>>>(x, n, out);
  return (int)cudaGetLastError();
}

const char* mrt_error_string(int err) {
  return cudaGetErrorString((cudaError_t)err);
}

}  // extern "C"
