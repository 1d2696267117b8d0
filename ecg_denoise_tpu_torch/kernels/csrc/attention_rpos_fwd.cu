// Attention with a per-window R-peak bias, forward — RA-LENet's R-wave
// attention (`--r_pos detect`) on Hopper (sm_90a).
//
// Replaces the TPU kernel ecg_denoise_tpu/kernels/attention_pallas.py
// _fwd_rpos_kernel (:827), launched through _rpos_call (:978) from
// fused_attention_rpos (:943) -> _rpos_single -> _rpos_fwd (:1019).
//
// Computes, for every (b, h, l):
//   out[b,h,l,:] = sum_m p[l,m] * v[b,h,m,:]
//   p[l,:]       = softmax_m(q[b,h,l,:] . k[b,h,m,:] + bias_b[h,l,m])
//   bias_b[h,l,m] = toep[0,h,l,m] * in_b[l] * in_b[m],
//   in_b[i]      = (off_b <= i < off_b + W)   (compared in float32)
// q arrives pre-scaled. Operands are contiguous (B, H, L, D); toep is a
// contiguous (1, H, L, L) array in the operand dtype (the Toeplitz
// expansion of the rel-pos table, zero where |l - m| >= W); offsets is a
// contiguous (B,) float32 array of window starts, which may be negative or
// run past L - W (the window is cut at the edges, not shifted). float32
// and bfloat16 operands; logits, the row max, exp, the sums and the
// weighted sum are float32, and the output is rounded once to the operand
// dtype. When `lse` is given, each row's float32 log-sum-exp is written
// for the backward kernel (attention_rpos_bwd.cu).
//
// Which kernel takes which (D, L), and why:
// * D = 4 at L <= 256 (RA-LENet's path, every stage): the kernel below, a
//   thread two rows, K and V of the block's heads in shared memory. At
//   L <= 256 a head's keys fit a block's shared memory at once, and the
//   arithmetic of the first version is kept bit for bit.
// * D = 4 past 256 keys (PTB-XL's 10 s records at 100 Hz, L = 1,000), and
//   D = 8, 16, 32, 64 at any L (bf16 from 16; the wrapper pads other D <=
//   64 up): B3's window kernel on the tensor cores
//   (attention_rpos_fwd_mma.cuh). D = 4 runs there unpadded (m16n8k4 TF32,
//   m16n8k8 bf16), the window is tested once a (warp, key tile), and f32 K
//   and V are split into TF32 halves once a tile.
// * D > 64, a multiple of 64 (the wrapper pads other D up): B1's wide
//   kernel in its window mode (attention_fwd_mma.cuh, kWin), thread-block
//   clusters along D.
//
// The D = 4 kernel. What bounds it: as for attention_fwd.cu, per (b, h)
// the work is 2*(2*L*L*D + L*L) flops and L*L exps against 4*L*D operand
// elements, with D = 4 below every tensor-core shape: CUDA-core f32
// arithmetic at L >= 128 and HBM below, by that count. The (B, H, L, L)
// bias is never built in any memory: the kernel forms it from toep and
// offsets[b].
//
// The first version (a thread a row, 128 consecutive rows of the
// flattened (B*H*L) row space a block, K and V of the block's heads in
// shared memory) tested the window on every key of both passes, and each
// test sat beside a dot4 whose K row was loaded for that one row alone.
//
// Design: the same two passes and order of operations, with fewer
// instructions per (row, key) pair.
// * A thread owns R consecutive query rows of one (b, h): R = 2 when L is
//   even, so that one shared-memory load of a key (and, in the second
//   pass, of its V row) feeds both rows' products; R = 1 otherwise. A
//   block owns kThreads * R rows and stages, converted to f32, the K and V
//   rows of every (b, h) they touch.
// * The element's window [lo, hi) is computed once. The L keys of each
//   pass go in three runs: [0, lo) and [hi, L) with no bias and no test,
//   and [lo, hi), where a row inside the window adds toep[h, l, m] (a
//   predicated load and add; outside its window a row gets no bias at all,
//   so every other entry of bias_b is skipped, exactly). A warp none of
//   whose rows lies in its window makes one bias-free run. In RA-LENet a
//   warp's rows share one batch element (H * L = 512), so the runs are
//   uniform across the warp; where they are not, each lane still takes
//   its own element's runs.
// * Two passes over the keys: the row max (trained logits reach 191.5,
//   so exp needs it), then exp, the sum and the V-weighted sum, in the
//   first version's order with its operations: the output and lse are its
//   bit for bit. No online rescaling, no atomics.
// About 21.5 instructions per (row, key) pair remain (read from the SASS):
// a dot4 in each pass, the max, __expf's exact path for tiny results (a
// compare and two predicated multiplies beside MUFU.EX2), the sum and four
// FMAs; keeping the first version's bits pins each of them (PERF.md).

#include <cuda_bf16.h>
#include <cuda_runtime.h>

#include <type_traits>

#include "attention_fwd_mma.cuh"
#include "attention_rpos_fwd_mma.cuh"

namespace {

constexpr int kD = 4;
constexpr int kThreads = 128;
constexpr int kMaxL = 256;

__device__ __forceinline__ float4 load4(const float* p) {
  return *reinterpret_cast<const float4*>(p);
}

__device__ __forceinline__ float4 load4(const __nv_bfloat16* p) {
  const __nv_bfloat162* p2 = reinterpret_cast<const __nv_bfloat162*>(p);
  const float2 a = __bfloat1622float2(p2[0]);
  const float2 b = __bfloat1622float2(p2[1]);
  return make_float4(a.x, a.y, b.x, b.y);
}

__device__ __forceinline__ float load1(const float* p) { return *p; }

__device__ __forceinline__ float load1(const __nv_bfloat16* p) {
  return __bfloat162float(*p);
}

__device__ __forceinline__ void store4(float* p, float4 v) {
  *reinterpret_cast<float4*>(p) = v;
}

__device__ __forceinline__ void store4(__nv_bfloat16* p, float4 v) {
  __nv_bfloat162* p2 = reinterpret_cast<__nv_bfloat162*>(p);
  p2[0] = __floats2bfloat162_rn(v.x, v.y);
  p2[1] = __floats2bfloat162_rn(v.z, v.w);
}

// The same product order as attention_fwd.cu and the backward kernels.
__device__ __forceinline__ float dot4(float4 a, float4 b) {
  float s = a.x * b.x;
  s = fmaf(a.y, b.y, s);
  s = fmaf(a.z, b.z, s);
  return fmaf(a.w, b.w, s);
}

// Keys one block may need to stage: kThreads * R consecutive rows span at
// most ceil((kThreads * R - 1) / L) + 1 heads of L rows each.
__host__ __device__ __forceinline__ int key_capacity(int L, int R) {
  return ((kThreads * R - 1 + L - 1) / L + 1) * L;
}

using Plain = std::false_type;
using Biased = std::true_type;

template <typename T, int R>
__global__ void __launch_bounds__(kThreads)
attention_rpos_fwd_kernel(const T* __restrict__ q, const T* __restrict__ k,
                          const T* __restrict__ v, const T* __restrict__ toep,
                          const float* __restrict__ offsets,
                          T* __restrict__ o, float* __restrict__ lse, int H,
                          int L, int W, int n_rows) {
  extern __shared__ float4 smem[];
  float4* ks = smem;
  float4* vs = smem + key_capacity(L, R);

  const int row0 = blockIdx.x * (kThreads * R);
  const int row_end = min(row0 + kThreads * R, n_rows);
  const int key0 = (row0 / L) * L;               // first key row staged
  const int n_keys = ((row_end - 1) / L + 1) * L - key0;
  for (int i = threadIdx.x; i < n_keys; i += kThreads) {
    ks[i] = load4(k + static_cast<size_t>(key0 + i) * kD);
    vs[i] = load4(v + static_cast<size_t>(key0 + i) * kD);
  }
  __syncthreads();

  // This thread: rows first .. first + R - 1, all of one (b, h) (L % R == 0).
  const int first = row0 + threadIdx.x * R;
  if (first >= n_rows) return;
  const int bh = first / L;
  const int l0 = first - bh * L;
  const int b = bh / H;
  const int h = bh - b * H;
  const float4* kh = ks + (bh * L - key0);
  const float4* vh = vs + (bh * L - key0);
  const Window win = window_of(offsets[b], W, L);  // attention_window.cuh
  const int lo = win.lo, hi = win.hi;
  float4 qr[R], acc[R];
  float mx[R], sum[R];
  bool in[R];
  const T* trow[R];
  bool any_in = false;
#pragma unroll
  for (int i = 0; i < R; ++i) {
    qr[i] = load4(q + static_cast<size_t>(first + i) * kD);
    in[i] = l0 + i >= lo && l0 + i < hi;  // a row outside the window: no bias
    any_in |= in[i];
    trow[i] = toep + (static_cast<size_t>(h) * L + l0 + i) * L;
    mx[i] = __int_as_float(0xff800000);  // -inf
    sum[i] = 0.f;
    acc[i] = make_float4(0.f, 0.f, 0.f, 0.f);
  }

  auto max_run = [&](int m_begin, int m_end, auto biased) {  // the row max
#pragma unroll 4
    for (int m = m_begin; m < m_end; ++m) {
      const float4 km = kh[m];
#pragma unroll
      for (int i = 0; i < R; ++i) {
        float s = dot4(qr[i], km);
        if constexpr (decltype(biased)::value) {
          if (in[i]) s += load1(trow[i] + m);
        }
        mx[i] = fmaxf(mx[i], s);
      }
    }
  };
  auto sum_run = [&](int m_begin, int m_end, auto biased) {  // exp, the sums
#pragma unroll 4
    for (int m = m_begin; m < m_end; ++m) {
      const float4 km = kh[m];
      const float4 vv = vh[m];
#pragma unroll
      for (int i = 0; i < R; ++i) {
        float s = dot4(qr[i], km);
        if constexpr (decltype(biased)::value) {
          if (in[i]) s += load1(trow[i] + m);
        }
        const float e = __expf(s - mx[i]);
        sum[i] += e;
        acc[i].x = fmaf(e, vv.x, acc[i].x);
        acc[i].y = fmaf(e, vv.y, acc[i].y);
        acc[i].z = fmaf(e, vv.z, acc[i].z);
        acc[i].w = fmaf(e, vv.w, acc[i].w);
      }
    }
  };
  // The keys in order, in three runs; a warp none of whose rows lies in
  // its window makes one bias-free run.
  if (__any_sync(__activemask(), any_in)) {
    max_run(0, lo, Plain{});
    max_run(lo, hi, Biased{});
    max_run(hi, L, Plain{});
    sum_run(0, lo, Plain{});
    sum_run(lo, hi, Biased{});
    sum_run(hi, L, Plain{});
  } else {
    max_run(0, L, Plain{});
    sum_run(0, L, Plain{});
  }
#pragma unroll
  for (int i = 0; i < R; ++i) {
    const size_t row = static_cast<size_t>(first + i);
    const float s = sum[i];
    store4(o + row * kD,
           make_float4(acc[i].x / s, acc[i].y / s, acc[i].z / s, acc[i].w / s));
    if (lse != nullptr) lse[row] = mx[i] + logf(s);
  }
}

template <typename T, int R>
cudaError_t launch_rows(const T* q, const T* k, const T* v, const T* toep,
                        const float* offsets, T* o, float* lse, int B, int H,
                        int L, int W, cudaStream_t stream) {
  const long long n_rows = static_cast<long long>(B) * H * L;
  if (n_rows > 0x7fffffffLL) return cudaErrorInvalidValue;
  const int grid = static_cast<int>((n_rows + kThreads * R - 1) / (kThreads * R));
  const size_t smem = 2 * key_capacity(L, R) * sizeof(float4);  // below 48 KB
  attention_rpos_fwd_kernel<T, R><<<grid, kThreads, smem, stream>>>(
      q, k, v, toep, offsets, o, lse, H, L, W, static_cast<int>(n_rows));
  return cudaGetLastError();
}

template <typename T>
cudaError_t launch(const void* q, const void* k, const void* v,
                   const void* toep, const float* offsets, void* o,
                   float* lse, int B, int H, int L, int W,
                   cudaStream_t stream) {
  const T* qt = static_cast<const T*>(q);
  const T* kt = static_cast<const T*>(k);
  const T* vt = static_cast<const T*>(v);
  const T* tt = static_cast<const T*>(toep);
  T* ot = static_cast<T*>(o);
  return L % 2 == 0
             ? launch_rows<T, 2>(qt, kt, vt, tt, offsets, ot, lse, B, H, L, W, stream)
             : launch_rows<T, 1>(qt, kt, vt, tt, offsets, ot, lse, B, H, L, W, stream);
}

}  // namespace

// Plain C interface for ctypes. D: 4 (the kernel above at L <= kMaxL, the
// window kernel past it), 8, 16, 32, 64 (the window kernel, any L whose
// grid fits an int; bf16 from 16) or a multiple of 64 past 64 (the wide
// kernel, any L). dtype: 0 = float32, 1 = bfloat16. `toep` and `offsets`
// are required; `lse` is null, or a float32 (B, H, L) output for the
// backward. Launches on `stream` of card `device`, does not synchronise
// and allocates nothing. Returns the launch's cudaError_t (0 = success).
extern "C" int ecg_attention_rpos_fwd(const void* q, const void* k,
                                      const void* v, const void* toep,
                                      const void* offsets, void* o, void* lse,
                                      int B, int H, int L, int D, int W,
                                      int dtype, int device, void* stream) {
  if (B < 1 || H < 1 || L < 1 || W < 1 || toep == nullptr || offsets == nullptr) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return static_cast<int>(err);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const float* off = static_cast<const float*>(offsets);
  float* lse_f = static_cast<float*>(lse);
  const bool small = D == kD && L <= kMaxL;
  switch (dtype) {
    case 0:
      err = small ? launch<float>(q, k, v, toep, off, o, lse_f, B, H, L, W, s)
            : D <= mma_fwd::kWideD
                ? rpos_fwd::launch<float>(q, k, v, toep, off, o, lse_f, B, H, L, D, W, s)
                : mma_fwd::launch_wide<float, true>(q, k, v, toep, o, lse_f, B, H, L, D, off, W,
                                                    s);
      break;
    case 1:
      err = small ? launch<__nv_bfloat16>(q, k, v, toep, off, o, lse_f, B, H, L, W, s)
            : D <= mma_fwd::kWideD
                ? rpos_fwd::launch<__nv_bfloat16>(q, k, v, toep, off, o, lse_f, B, H, L, D, W,
                                                  s)
                : mma_fwd::launch_wide<__nv_bfloat16, true>(q, k, v, toep, o, lse_f, B, H, L, D,
                                                            off, W, s);
      break;
    default:
      err = cudaErrorInvalidValue;
  }
  return static_cast<int>(err);
}

// The wide kernel's cluster at head dim D (a multiple of 64 past 64):
// out[0] its size in blocks, out[1] the clusters card `device` holds at once
// (cudaOccupancyMaxActiveClusters). dtype as above; with_bias is not read
// (the window mode has its bias). Returns a cudaError_t (0 = success).
extern "C" int ecg_wide_clusters(int D, int dtype, int with_bias, int device, int* out) {
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return static_cast<int>(err);
  switch (dtype) {
    case 0: err = mma_fwd::wide_clusters<float, true>(D, with_bias != 0, out + 1, out); break;
    case 1:
      err = mma_fwd::wide_clusters<__nv_bfloat16, true>(D, with_bias != 0, out + 1, out);
      break;
    default: err = cudaErrorInvalidValue;
  }
  return static_cast<int>(err);
}

extern "C" const char* ecg_cuda_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}
