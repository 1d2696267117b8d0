// The null launch and the dma floor: one kernel that copies n float32
// values, for the launch-floor probes (ecg_denoise_tpu_torch/probes/) on
// Hopper (sm_90a).
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
// moves 8n bytes and is bound by HBM: 5.0 us for a (64, 8) call's q at
// B = 1024 (2.1 M values), 10.0 us at B = 2048.
//
// Design: a grid of at most one wave of resident blocks (the card's SMs
// times the blocks an SM holds), 256 threads a block, each thread copying
// the 16-byte vectors t, t + T, t + 2T, ... (T = the grid's threads) in
// groups of four, a group's four loads issued before its first store.
// Grid-sizing matters most: a q of 2.1 M values is 524,288 vectors, two a
// thread over one wave, so every block starts at once and none waits in a
// second wave or a tail. The null launch (n = 1,024) is one block of 256
// threads, one vector each, with nothing added. The last 0-3 values are
// scalars. Where x or o is not 16-byte aligned (x a view such as base[1:];
// o comes from the allocator, aligned) the copy takes the same loop with
// 4-byte accesses. Loads and stores keep the default caching: streaming
// hints and a copy by the bulk-copy engine read level with it (PERF.md).

#include <cuda_runtime.h>

#include <cstdint>

namespace {

constexpr int kThreads = 256;
constexpr int kGroup = 4;  // loads a thread has in flight before its first store
constexpr int kMaxDevices = 64;

// Copies the n / kPer units V (float4 or float) of x to o in the
// grid-stride loop of the design note; with V = float4 the first threads of
// block 0 also copy the last n % 4 values.
template <typename V>
__global__ void __launch_bounds__(kThreads)
null_copy_kernel(const float* __restrict__ x, float* __restrict__ o, long long n) {
  constexpr int kPer = sizeof(V) / sizeof(float);
  const long long t = static_cast<long long>(blockIdx.x) * kThreads + threadIdx.x;
  const long long T = static_cast<long long>(gridDim.x) * kThreads;
  const long long units = n / kPer;
  const V* xv = reinterpret_cast<const V*>(x);
  V* ov = reinterpret_cast<V*>(o);
  for (long long i = t; i < units; i += kGroup * T) {
    V v[kGroup];
#pragma unroll
    for (int u = 0; u < kGroup; ++u) {
      if (i + u * T < units) v[u] = xv[i + u * T];
    }
#pragma unroll
    for (int u = 0; u < kGroup; ++u) {
      if (i + u * T < units) ov[i + u * T] = v[u];
    }
  }
  const long long k = units * kPer + t;
  if (kPer > 1 && k < n) o[k] = x[k];
}

// Blocks of null_copy_kernel<V> resident on all SMs of `device` at once
// (one wave), read once per device into `blocks`.
template <typename V>
cudaError_t wave(int device, int* blocks) {
  static int cache[kMaxDevices] = {};
  if (device < 0 || device >= kMaxDevices) return cudaErrorInvalidDevice;
  if (cache[device] == 0) {
    int sms = 0, per_sm = 0;
    cudaError_t err = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, device);
    if (err == cudaSuccess) {
      err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(&per_sm, null_copy_kernel<V>,
                                                          kThreads, 0);
    }
    if (err != cudaSuccess) return err;
    cache[device] = sms * per_sm;
  }
  *blocks = cache[device];
  return cudaSuccess;
}

template <typename V>
cudaError_t launch(const float* x, float* o, long long n, int device, cudaStream_t stream) {
  int blocks = 0;
  const cudaError_t err = wave<V>(device, &blocks);
  if (err != cudaSuccess) return err;
  const long long units = n / static_cast<long long>(sizeof(V) / sizeof(float));
  const long long needed = (units + kThreads - 1) / kThreads;
  const unsigned grid = static_cast<unsigned>(needed < 1 ? 1 : needed < blocks ? needed : blocks);
  null_copy_kernel<V><<<grid, kThreads, 0, stream>>>(x, o, n);
  return cudaGetLastError();
}

}  // namespace

// Plain C interface for ctypes: copies n >= 1 float32 values from x to o
// on `stream` of card `device`; does not synchronise and allocates
// nothing. Returns the launch's cudaError_t (0 = success).
extern "C" int ecg_null_copy(const void* x, void* o, int n, int device, void* stream) {
  if (n < 1) return static_cast<int>(cudaErrorInvalidValue);
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return static_cast<int>(err);
  const auto* xf = static_cast<const float*>(x);
  auto* of = static_cast<float*>(o);
  const auto s = static_cast<cudaStream_t>(stream);
  const bool aligned = (reinterpret_cast<uintptr_t>(x) | reinterpret_cast<uintptr_t>(o)) % 16 == 0;
  return static_cast<int>(aligned ? launch<float4>(xf, of, n, device, s)
                                  : launch<float>(xf, of, n, device, s));
}

extern "C" const char* ecg_cuda_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}
