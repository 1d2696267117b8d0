// Fused biased attention, backward — RA-LENet's attention gradient on
// Hopper (sm_90a).
//
// Replaces the TPU kernel ecg_denoise_tpu/kernels/attention_pallas.py
// _bwd_kernel (:333), launched through _bwd_call (:767) from _fused_bwd
// (:1287) -> _bwd (:708) -> _bwd_raw (:790).
//
// Computes, for every (b, h), with the forward's log-sum-exp residual lse
// (attention_fwd.cu) and the incoming gradient g of the output o:
//   p[l,m]  = exp(q[l] . k[m] + bias[h,l,m] - lse[l])
//   c[l]    = sum_d g[l,d] * o[l,d]          (the flash delta identity)
//   ds[l,m] = p[l,m] * (g[l] . v[m] - c[l])
//   dq[l]   = sum_m ds[l,m] * k[m]
//   dk[m]   = sum_l ds[l,m] * q[l]
//   dv[m]   = sum_l p[l,m] * g[l]
//   dbias[h,l,m] = sum_b ds[b,h,l,m]          (float32)
// q arrives pre-scaled. Operands are contiguous (B, H, L, D) with D = 4 and
// L <= 256; bias is a contiguous (1, H, L, L) array shared by the batch,
// or absent. float32 and bfloat16 operands; every product, exp and sum is
// float32, dq, dk and dv are rounded once to the operand dtype, and dbias
// is written in float32 (the caller casts it to the bias dtype). The TPU
// kernel rounds e and ds to bf16 before its products; this one does not.
//
// What bounds it: per (b, h) the work is 2*(5*L*L*D + 3*L*L) flops and
// L*L exps, with D = 4 below every tensor-core shape, so the products run
// on the CUDA cores in f32. By bytes the call moves q, k, v, g, o, dq, dk,
// dv, lse, c, the bias and dbias once: operations bound it at L >= 128 and
// bytes below. As in the forward, the bias reads of the dq pass (one bias
// row per thread, uncoalesced, again for every batch element) are the
// likely cost on the card; the other two passes read the bias by column,
// coalesced across a warp.
//
// Design (a simple correct first version, three launches; none of the TPU
// layout is kept — no (B, H, D, L) transpose, no lane packing, no 8-sublane
// residual, no block-diagonal bias):
// * dq pass: one thread per query row, K and V of the block's heads staged
//   in shared memory as in the forward. Each thread also computes its row's
//   c and writes it to a float32 (B, H, L) scratch for the two later passes.
// * dk/dv pass: one thread per key row, q, g, lse and c of the block's heads
//   staged in shared memory; the warp reads the bias by column.
// * dbias pass (only when the bias needs a gradient): one thread per
//   (h, l, m), looping b = 0 .. B-1 in order and recomputing ds from q, k,
//   v, g, lse and c. The TPU walks the batch axis on a sequential grid with
//   the output block as accumulator; Hopper's blocks run in no order, so
//   the loop inside one thread takes its place.
// Every output element is summed by one thread in one fixed order: no
// atomics, and a call gives bit-identical results every time.

#include <cuda_bf16.h>
#include <cuda_runtime.h>

namespace {

constexpr int kD = 4;
constexpr int kRows = 128;
constexpr int kMaxL = 256;
constexpr int kBiasThreads = 256;

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

// The same product order as the forward kernel, so a logit recomputed here
// is bit-identical to the one the forward's lse was taken over.
__device__ __forceinline__ float dot4(float4 a, float4 b) {
  float s = a.x * b.x;
  s = fmaf(a.y, b.y, s);
  s = fmaf(a.z, b.z, s);
  return fmaf(a.w, b.w, s);
}

__device__ __forceinline__ void fma4(float a, float4 x, float4& acc) {
  acc.x = fmaf(a, x.x, acc.x);
  acc.y = fmaf(a, x.y, acc.y);
  acc.z = fmaf(a, x.z, acc.z);
  acc.w = fmaf(a, x.w, acc.w);
}

// Rows one block may need to stage: kRows consecutive rows span at most
// ceil((kRows - 1) / L) + 1 heads of L rows each.
__host__ __device__ __forceinline__ int head_capacity(int L) {
  return ((kRows - 1 + L - 1) / L + 1) * L;
}

template <typename T, bool kBias>
__global__ void __launch_bounds__(kRows)
attention_bwd_dq_kernel(const T* __restrict__ q, const T* __restrict__ k,
                        const T* __restrict__ v, const T* __restrict__ bias,
                        const T* __restrict__ g, const T* __restrict__ o,
                        const float* __restrict__ lse, float* __restrict__ c,
                        T* __restrict__ dq, int H, int L, int n_rows) {
  extern __shared__ float4 smem[];
  float4* ks = smem;
  float4* vs = smem + head_capacity(L);

  const int row0 = blockIdx.x * kRows;
  const int row_end = min(row0 + kRows, n_rows);
  const int key0 = (row0 / L) * L;
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
  const float4 gr = load4(g + row * kD);
  const float cr = dot4(gr, load4(o + row * kD));
  const float lr = lse[row];
  c[row] = cr;
  const T* brow = nullptr;
  if (kBias) brow = bias + ((bh % H) * L + l) * L;

  float4 acc = make_float4(0.f, 0.f, 0.f, 0.f);
  for (int m = 0; m < L; ++m) {
    const float4 km = kh[m];
    float s = dot4(qr, km);
    if (kBias) s += load1(brow + m);
    const float ds = __expf(s - lr) * (dot4(gr, vh[m]) - cr);
    fma4(ds, km, acc);
  }
  store4(dq + row * kD, acc);
}

template <typename T, bool kBias>
__global__ void __launch_bounds__(kRows)
attention_bwd_dkdv_kernel(const T* __restrict__ q, const T* __restrict__ k,
                          const T* __restrict__ v, const T* __restrict__ bias,
                          const T* __restrict__ g,
                          const float* __restrict__ lse,
                          const float* __restrict__ c, T* __restrict__ dk,
                          T* __restrict__ dv, int H, int L, int n_rows) {
  extern __shared__ float4 smem[];
  const int cap = head_capacity(L);
  float4* qs = smem;
  float4* gs = smem + cap;
  float* ls = reinterpret_cast<float*>(smem + 2 * cap);
  float* cs = ls + cap;

  const int row0 = blockIdx.x * kRows;  // key rows of the flattened B*H*L
  const int row_end = min(row0 + kRows, n_rows);
  const int first = (row0 / L) * L;     // first query row staged
  const int n_staged = ((row_end - 1) / L + 1) * L - first;
  for (int i = threadIdx.x; i < n_staged; i += kRows) {
    qs[i] = load4(q + (first + i) * kD);
    gs[i] = load4(g + (first + i) * kD);
    ls[i] = lse[first + i];
    cs[i] = c[first + i];
  }
  __syncthreads();

  const int row = row0 + threadIdx.x;
  if (row >= n_rows) return;
  const int bh = row / L;
  const int m = row - bh * L;
  const int off = bh * L - first;
  const float4 kr = load4(k + row * kD);
  const float4 vr = load4(v + row * kD);
  const T* bcol = nullptr;  // bias[h, l, m] is bcol[l * L]
  if (kBias) bcol = bias + (bh % H) * L * L + m;

  float4 dk_acc = make_float4(0.f, 0.f, 0.f, 0.f);
  float4 dv_acc = make_float4(0.f, 0.f, 0.f, 0.f);
  for (int l = 0; l < L; ++l) {
    const float4 ql = qs[off + l];
    const float4 gl = gs[off + l];
    float s = dot4(ql, kr);
    if (kBias) s += load1(bcol + l * L);
    const float p = __expf(s - ls[off + l]);
    fma4(p, gl, dv_acc);
    fma4(p * (dot4(gl, vr) - cs[off + l]), ql, dk_acc);
  }
  store4(dk + row * kD, dk_acc);
  store4(dv + row * kD, dv_acc);
}

template <typename T>
__global__ void __launch_bounds__(kBiasThreads)
attention_bwd_dbias_kernel(const T* __restrict__ q, const T* __restrict__ k,
                           const T* __restrict__ v, const T* __restrict__ bias,
                           const T* __restrict__ g,
                           const float* __restrict__ lse,
                           const float* __restrict__ c,
                           float* __restrict__ dbias, int B, int H, int L) {
  const int idx = blockIdx.x * kBiasThreads + threadIdx.x;  // (h, l, m)
  if (idx >= H * L * L) return;
  const int m = idx % L;
  const int hl = idx / L;
  const int l = hl % L;
  const int h = hl / L;
  const float bv = load1(bias + idx);
  const int stride = H * L;  // rows between consecutive batch elements
  int qrow = h * L + l;
  int krow = h * L + m;
  float acc = 0.f;
#pragma unroll 4
  for (int b = 0; b < B; ++b) {
    const float4 ql = load4(q + qrow * kD);
    const float4 km = load4(k + krow * kD);
    const float p = __expf(dot4(ql, km) + bv - lse[qrow]);
    acc = fmaf(p, dot4(load4(g + qrow * kD), load4(v + krow * kD)) - c[qrow],
               acc);
    qrow += stride;
    krow += stride;
  }
  dbias[idx] = acc;
}

template <typename T>
cudaError_t launch(const void* q, const void* k, const void* v,
                   const void* bias, const void* g, const void* o,
                   const float* lse, float* c, void* dq, void* dk, void* dv,
                   float* dbias, int B, int H, int L, cudaStream_t stream) {
  const int n_rows = B * H * L;
  const dim3 grid((n_rows + kRows - 1) / kRows);
  const int cap = head_capacity(L);
  const size_t smem_dq = 2 * cap * sizeof(float4);
  const size_t smem_dkdv = cap * (2 * sizeof(float4) + 2 * sizeof(float));
  const T* qt = static_cast<const T*>(q);
  const T* kt = static_cast<const T*>(k);
  const T* vt = static_cast<const T*>(v);
  const T* bt = static_cast<const T*>(bias);
  const T* gt = static_cast<const T*>(g);
  const T* ot = static_cast<const T*>(o);
  T* dqt = static_cast<T*>(dq);
  T* dkt = static_cast<T*>(dk);
  T* dvt = static_cast<T*>(dv);
  if (bias != nullptr) {
    attention_bwd_dq_kernel<T, true><<<grid, kRows, smem_dq, stream>>>(
        qt, kt, vt, bt, gt, ot, lse, c, dqt, H, L, n_rows);
  } else {
    attention_bwd_dq_kernel<T, false><<<grid, kRows, smem_dq, stream>>>(
        qt, kt, vt, bt, gt, ot, lse, c, dqt, H, L, n_rows);
  }
  cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess) return err;
  if (bias != nullptr) {
    attention_bwd_dkdv_kernel<T, true><<<grid, kRows, smem_dkdv, stream>>>(
        qt, kt, vt, bt, gt, lse, c, dkt, dvt, H, L, n_rows);
  } else {
    attention_bwd_dkdv_kernel<T, false><<<grid, kRows, smem_dkdv, stream>>>(
        qt, kt, vt, bt, gt, lse, c, dkt, dvt, H, L, n_rows);
  }
  err = cudaGetLastError();
  if (err != cudaSuccess || dbias == nullptr) return err;
  const dim3 grid_bias((H * L * L + kBiasThreads - 1) / kBiasThreads);
  attention_bwd_dbias_kernel<T><<<grid_bias, kBiasThreads, 0, stream>>>(
      qt, kt, vt, bt, gt, lse, c, dbias, B, H, L);
  return cudaGetLastError();
}

}  // namespace

// Plain C interface for ctypes. dtype: 0 = float32, 1 = bfloat16. `bias`
// may be null; `dbias` is null, or (with a bias) a float32 (1, H, L, L)
// output. `lse` is the forward's float32 (B, H, L) residual and `c` a
// float32 (B, H, L) scratch the call fills. Launches on `stream` of card
// `device`, does not synchronise and allocates nothing. Returns the first
// failing launch's cudaError_t (0 = success).
extern "C" int ecg_attention_bwd(const void* q, const void* k, const void* v,
                                 const void* bias, const void* g,
                                 const void* o, const void* lse, void* c,
                                 void* dq, void* dk, void* dv, void* dbias,
                                 int B, int H, int L, int D, int dtype,
                                 int device, void* stream) {
  if (B < 1 || H < 1 || L < 1 || L > kMaxL || D != kD ||
      (dbias != nullptr && bias == nullptr)) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return static_cast<int>(err);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const float* lse_f = static_cast<const float*>(lse);
  float* c_f = static_cast<float*>(c);
  float* dbias_f = static_cast<float*>(dbias);
  switch (dtype) {
    case 0:
      err = launch<float>(q, k, v, bias, g, o, lse_f, c_f, dq, dk, dv, dbias_f,
                          B, H, L, s);
      break;
    case 1:
      err = launch<__nv_bfloat16>(q, k, v, bias, g, o, lse_f, c_f, dq, dk, dv,
                                  dbias_f, B, H, L, s);
      break;
    default:
      err = cudaErrorInvalidValue;
  }
  return static_cast<int>(err);
}

extern "C" const char* ecg_cuda_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}
