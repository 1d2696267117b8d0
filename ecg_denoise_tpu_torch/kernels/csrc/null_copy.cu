// The null launch: one kernel that copies n float32 values, for the
// launch-floor probes (ecg_denoise_tpu_torch/probes/) on Hopper (sm_90a).
//
// Replaces the TPU probes' null kernels: the `kern` of
// scripts/probe_chain.py:58 (launched at :62) and of
// scripts/probe_floor.py:65 (launched at :71), each a pallas_call on a
// one-step grid that copies one (8, 128) float32 tile through VMEM. With
// n = 1,024 this kernel is that tile copy, one block, the cheapest launch
// the port can make. With n = the elements of an attention call's q it is
// the Hopper counterpart of the probes' "dma" floor, which the TPU package
// measures by running its attention kernel with every compute skipped
// (ECG_ATTN_ABLATE=dma): the time to move the call's bytes and nothing
// else.
//
// What bounds it: nothing but launch and memory. n = 1,024 moves 8 KB, a
// few nanoseconds at 3.35 TB/s, so its time is the launch itself; a large n
// moves 8n bytes and is bound by HBM.
//
// Design: one block of 256 threads per 1,024 elements, each thread copying
// four elements 256 apart, so a warp's loads and stores are 128 contiguous
// bytes; the ragged last block is masked.

#include <cuda_runtime.h>

namespace {

constexpr int kPerBlock = 1024;
constexpr int kThreads = 256;

__global__ void __launch_bounds__(kThreads)
null_copy_kernel(const float* __restrict__ x, float* __restrict__ o, int n) {
  const long long base = static_cast<long long>(blockIdx.x) * kPerBlock;
#pragma unroll
  for (int j = 0; j < kPerBlock / kThreads; ++j) {
    const long long i = base + threadIdx.x + j * kThreads;
    if (i < n) o[i] = x[i];
  }
}

}  // namespace

// Plain C interface for ctypes: copies n >= 1 float32 values from x to o
// on `stream` of card `device`; does not synchronise and allocates
// nothing. Returns the launch's cudaError_t (0 = success).
extern "C" int ecg_null_copy(const void* x, void* o, int n, int device,
                             void* stream) {
  if (n < 1) return static_cast<int>(cudaErrorInvalidValue);
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return static_cast<int>(err);
  const dim3 grid((n + kPerBlock - 1) / kPerBlock);
  null_copy_kernel<<<grid, kThreads, 0, static_cast<cudaStream_t>(stream)>>>(
      static_cast<const float*>(x), static_cast<float*>(o), n);
  return static_cast<int>(cudaGetLastError());
}

extern "C" const char* ecg_cuda_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}
