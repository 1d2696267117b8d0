// Fused biased attention, forward — RA-LENet's attention on Hopper (sm_90a).
//
// Replaces the TPU kernel ecg_denoise_tpu/kernels/attention_pallas.py
// _fwd_kernel (:253), launched through _fwd_call (:684) from
// fused_attention (:1265) -> _fused_single -> _fwd (:618) -> _fwd_raw.
//
// Computes, for every (b, h, l):
//   out[b,h,l,:] = sum_m p[l,m] * v[b,h,m,:]
//   p[l,:]       = softmax_m(q[b,h,l,:] . k[b,h,m,:] + bias[0,h,l,m])
// q arrives pre-scaled. Operands are contiguous (B, H, L, D) with D = 4 and
// L <= 256; bias is a contiguous (1, H, L, L) array shared by the batch, or
// absent. float32 and bfloat16 operands; logits, the row max, exp, the sums
// and the weighted sum are float32, and the output is rounded once to the
// operand dtype. (The TPU kernel rounds the unnormalised probabilities to
// bf16 before its pv matmul; this kernel stays in f32 there.)
//
// What bounds it: per (b, h) the work is 2*(2*L*L*D + L*L) flops and L*L
// exps against (4*L*D + L*L) operand elements, so with D = 4 there is
// nothing for the tensor cores (a head_dim of 4 is below every MMA shape)
// and by that count the call is bound by CUDA-core f32 arithmetic at
// L >= 128 and by HBM below. What sets its time on the card is neither:
// it is the bias reads (see the last point below). Each thread reads its
// own bias row, so one warp's 4-byte loads touch 32 rows, each costing a
// fresh 32-byte sector from L2, and the bias is read again for every batch
// element; at (L, H) = (256, 2) the call runs 8.8 times faster without
// the bias (PERF.md, PR 1).
//
// Training: when the caller passes `lse`, each thread also writes its
// row's log-sum-exp, rowmax + log(rowsum), as one float32 per (b, h, l).
// The backward kernel (attention_bwd.cu) recomputes the probabilities
// from it as exp(logit - lse). The TPU kernel saves the row sum instead
// and recomputes the max; one number carries both. Without `lse` the
// kernel is the serving kernel unchanged.
//
// Design (a simple correct first version; none of the TPU layout is kept —
// no (B, H, D, L) transpose, no lane packing, no ones-row sum fold):
// * One thread owns one query row; a block owns kRows consecutive rows of
//   the flattened (B*H*L) row space, which at L >= kRows is a tile of one
//   (b, h) and at L < kRows covers kRows / L whole heads.
// * The block stages, converted to f32, the K and V rows of every (b, h)
//   its rows touch in shared memory (8 KB each at L = 256); threads of a
//   warp read the same key row, a shared-memory broadcast.
// * Each thread keeps q in 4 registers and makes two passes over its L
//   keys: the row max, then exp, the sum and the V-weighted sum. All L <=
//   256 keys are in shared memory, so no online rescaling is needed, and
//   there is no cross-block reduction, so no atomics.
// * The bias row is read straight from global memory: uncoalesced across
//   the warp, but batch-independent and L2-resident (512 KB at L = 256).
//   Coalescing it through shared memory is later work.

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

template <typename T, bool kBias>
__global__ void __launch_bounds__(kRows)
attention_fwd_kernel(const T* __restrict__ q, const T* __restrict__ k,
                     const T* __restrict__ v, const T* __restrict__ bias,
                     T* __restrict__ o, float* __restrict__ lse, int H, int L,
                     int n_rows) {
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
  const float4* kh = ks + (bh * L - key0);
  const float4* vh = vs + (bh * L - key0);
  const float4 qr = load4(q + row * kD);
  const T* brow = nullptr;
  if (kBias) brow = bias + ((bh % H) * L + l) * L;

  float mx = __int_as_float(0xff800000);  // -inf
  for (int m = 0; m < L; ++m) {
    float s = dot4(qr, kh[m]);
    if (kBias) s += load1(brow + m);
    mx = fmaxf(mx, s);
  }

  float sum = 0.f;
  float4 acc = make_float4(0.f, 0.f, 0.f, 0.f);
  for (int m = 0; m < L; ++m) {
    float s = dot4(qr, kh[m]);
    if (kBias) s += load1(brow + m);
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
                   const void* bias, void* o, float* lse, int B, int H,
                   int L, cudaStream_t stream) {
  const int n_rows = B * H * L;
  const dim3 grid((n_rows + kRows - 1) / kRows);
  const size_t smem = 2 * key_capacity(L) * sizeof(float4);
  const T* qt = static_cast<const T*>(q);
  const T* kt = static_cast<const T*>(k);
  const T* vt = static_cast<const T*>(v);
  const T* bt = static_cast<const T*>(bias);
  T* ot = static_cast<T*>(o);
  if (bias != nullptr) {
    attention_fwd_kernel<T, true><<<grid, kRows, smem, stream>>>(
        qt, kt, vt, bt, ot, lse, H, L, n_rows);
  } else {
    attention_fwd_kernel<T, false><<<grid, kRows, smem, stream>>>(
        qt, kt, vt, bt, ot, lse, H, L, n_rows);
  }
  return cudaGetLastError();
}

}  // namespace

// Plain C interface for ctypes. dtype: 0 = float32, 1 = bfloat16. `bias`
// may be null; `lse` is null, or a float32 (B, H, L) output for the
// backward. Launches on `stream` of card `device`, does not synchronise
// and allocates nothing. Returns the launch's cudaError_t (0 = success).
extern "C" int ecg_attention_fwd(const void* q, const void* k, const void* v,
                                 const void* bias, void* o, void* lse,
                                 int B, int H, int L, int D, int dtype,
                                 int device, void* stream) {
  if (B < 1 || H < 1 || L < 1 || L > kMaxL || D != kD) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return static_cast<int>(err);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  float* lse_f = static_cast<float*>(lse);
  switch (dtype) {
    case 0:
      err = launch<float>(q, k, v, bias, o, lse_f, B, H, L, s);
      break;
    case 1:
      err = launch<__nv_bfloat16>(q, k, v, bias, o, lse_f, B, H, L, s);
      break;
    default:
      err = cudaErrorInvalidValue;
  }
  return static_cast<int>(err);
}

extern "C" const char* ecg_cuda_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}
