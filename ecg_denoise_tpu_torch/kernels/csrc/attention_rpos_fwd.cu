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
// q arrives pre-scaled. Operands are contiguous (B, H, L, D) with D = 4 and
// L <= 256; toep is a contiguous (1, H, L, L) array in the operand dtype
// (the Toeplitz expansion of the rel-pos table, zero where |l - m| >= W);
// offsets is a contiguous (B,) float32 array of window starts, which may
// be negative or run past L - W (the window is cut at the edges, not
// shifted). float32 and bfloat16 operands; logits, the row max, exp, the
// sums and the weighted sum are float32, and the output is rounded once to
// the operand dtype. When `lse` is given, each row's float32 log-sum-exp
// is written for the backward kernel (attention_rpos_bwd.cu).
//
// What bounds it: as for attention_fwd.cu, per (b, h) the work is
// 2*(2*L*L*D + L*L) flops and L*L exps against 4*L*D operand elements,
// with D = 4 below every tensor-core shape: CUDA-core f32 arithmetic at
// L >= 128 and HBM below, by that count. The (B, H, L, L) bias is never
// built in any memory: the kernel forms it from toep and offsets[b].
//
// Design (a simple correct first version; none of the TPU layout is kept —
// no (B, H, D, L) transpose, no lane packing, no packed block-diagonal
// toep, no ones-row sum fold):
// * One thread owns one query row; a block owns kRows consecutive rows of
//   the flattened (B*H*L) row space and stages, converted to f32, the K
//   and V rows of every (b, h) its rows touch in shared memory, as
//   attention_fwd.cu does.
// * Each thread turns offsets[b] into the integer key range [lo, hi) of
//   the window, cut to [0, L). A row outside its window gets no bias at
//   all; a row inside it gets toep[h, l, m] for the keys m in [lo, hi)
//   only. Every other entry of bias_b is zero by the in_b test, so the
//   thread reads at most W toep values and skips the rest: exact, not an
//   approximation. Where B1 reads a whole bias row for every row of every
//   batch element, B3 reads W of them for the W rows of the window.
// * Two passes over the L keys: the row max (trained logits reach 191.5,
//   so exp needs it), then exp, the sum and the V-weighted sum. All L <=
//   256 keys are in shared memory; no online rescaling, no atomics.

#include <cuda_bf16.h>
#include <cuda_runtime.h>

namespace {

constexpr int kD = 4;
constexpr int kRows = 128;
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

// Keys one block may need to stage: kRows consecutive rows span at most
// ceil((kRows - 1) / L) + 1 heads of L rows each.
__host__ __device__ __forceinline__ int key_capacity(int L) {
  return ((kRows - 1 + L - 1) / L + 1) * L;
}

// The integer positions i in [0, L) with off <= i < off + W, as [lo, hi):
// i >= off iff i >= ceil(off), and i < x iff i < ceil(x), for integer i.
__device__ __forceinline__ void window(float off, int W, int L, int& lo,
                                       int& hi) {
  const float fl = static_cast<float>(L);
  lo = static_cast<int>(ceilf(fminf(fmaxf(off, 0.f), fl)));
  hi = static_cast<int>(ceilf(fminf(fmaxf(off + static_cast<float>(W), 0.f), fl)));
  if (hi < lo) hi = lo;
}

template <typename T>
__global__ void __launch_bounds__(kRows)
attention_rpos_fwd_kernel(const T* __restrict__ q, const T* __restrict__ k,
                          const T* __restrict__ v, const T* __restrict__ toep,
                          const float* __restrict__ offsets,
                          T* __restrict__ o, float* __restrict__ lse, int H,
                          int L, int W, int n_rows) {
  extern __shared__ float4 smem[];
  float4* ks = smem;
  float4* vs = smem + key_capacity(L);

  const int row0 = blockIdx.x * kRows;
  const int row_end = min(row0 + kRows, n_rows);
  const int key0 = (row0 / L) * L;               // first key row staged
  const int n_keys = ((row_end - 1) / L + 1) * L - key0;
  for (int i = threadIdx.x; i < n_keys; i += kRows) {
    ks[i] = load4(k + (key0 + i) * kD);
    vs[i] = load4(v + (key0 + i) * kD);
  }
  __syncthreads();

  const int row = row0 + threadIdx.x;
  if (row >= n_rows) return;
  const int bh = row / L;
  const int l = row - bh * L;
  const int b = bh / H;
  const int h = bh - b * H;
  const float4* kh = ks + (bh * L - key0);
  const float4* vh = vs + (bh * L - key0);
  const float4 qr = load4(q + row * kD);
  int lo, hi;
  window(offsets[b], W, L, lo, hi);
  if (l < lo || l >= hi) hi = lo;  // a row outside the window: no bias
  const unsigned width = static_cast<unsigned>(hi - lo);
  const T* trow = toep + (h * L + l) * L;

  float mx = __int_as_float(0xff800000);  // -inf
  for (int m = 0; m < L; ++m) {
    float s = dot4(qr, kh[m]);
    if (static_cast<unsigned>(m - lo) < width) s += load1(trow + m);
    mx = fmaxf(mx, s);
  }

  float sum = 0.f;
  float4 acc = make_float4(0.f, 0.f, 0.f, 0.f);
  for (int m = 0; m < L; ++m) {
    float s = dot4(qr, kh[m]);
    if (static_cast<unsigned>(m - lo) < width) s += load1(trow + m);
    const float e = __expf(s - mx);
    const float4 vv = vh[m];
    sum += e;
    acc.x = fmaf(e, vv.x, acc.x);
    acc.y = fmaf(e, vv.y, acc.y);
    acc.z = fmaf(e, vv.z, acc.z);
    acc.w = fmaf(e, vv.w, acc.w);
  }
  store4(o + row * kD,
         make_float4(acc.x / sum, acc.y / sum, acc.z / sum, acc.w / sum));
  if (lse != nullptr) lse[row] = mx + logf(sum);
}

template <typename T>
cudaError_t launch(const void* q, const void* k, const void* v,
                   const void* toep, const float* offsets, void* o,
                   float* lse, int B, int H, int L, int W,
                   cudaStream_t stream) {
  const int n_rows = B * H * L;
  const dim3 grid((n_rows + kRows - 1) / kRows);
  const size_t smem = 2 * key_capacity(L) * sizeof(float4);
  attention_rpos_fwd_kernel<T><<<grid, kRows, smem, stream>>>(
      static_cast<const T*>(q), static_cast<const T*>(k),
      static_cast<const T*>(v), static_cast<const T*>(toep), offsets,
      static_cast<T*>(o), lse, H, L, W, n_rows);
  return cudaGetLastError();
}

}  // namespace

// Plain C interface for ctypes. dtype: 0 = float32, 1 = bfloat16. `toep`
// and `offsets` are required; `lse` is null, or a float32 (B, H, L) output
// for the backward. Launches on `stream` of card `device`, does not
// synchronise and allocates nothing. Returns the launch's cudaError_t
// (0 = success).
extern "C" int ecg_attention_rpos_fwd(const void* q, const void* k,
                                      const void* v, const void* toep,
                                      const void* offsets, void* o, void* lse,
                                      int B, int H, int L, int D, int W,
                                      int dtype, int device, void* stream) {
  if (B < 1 || H < 1 || L < 1 || L > kMaxL || D != kD || W < 1 ||
      toep == nullptr || offsets == nullptr) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return static_cast<int>(err);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const float* off = static_cast<const float*>(offsets);
  float* lse_f = static_cast<float*>(lse);
  switch (dtype) {
    case 0:
      err = launch<float>(q, k, v, toep, off, o, lse_f, B, H, L, W, s);
      break;
    case 1:
      err = launch<__nv_bfloat16>(q, k, v, toep, off, o, lse_f, B, H, L, W, s);
      break;
    default:
      err = cudaErrorInvalidValue;
  }
  return static_cast<int>(err);
}

extern "C" const char* ecg_cuda_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}
