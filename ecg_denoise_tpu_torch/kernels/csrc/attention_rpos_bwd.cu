// Attention with a per-window R-peak bias, backward — the gradient of
// RA-LENet's R-wave attention (`--r_pos detect`) on Hopper (sm_90a).
//
// Replaces the TPU kernel ecg_denoise_tpu/kernels/attention_pallas.py
// _bwd_rpos_kernel (:859), launched through _rpos_bwd_call (:1037) from
// _rpos_bwd (:1058), the custom VJP of _rpos_single.
//
// Computes, for every (b, h), with the forward's log-sum-exp residual lse
// (attention_rpos_fwd.cu) and the incoming gradient g of the output o,
// where bias_b[h,l,m] = toep[0,h,l,m] * in_b[l] * in_b[m] and
// in_b[i] = (off_b <= i < off_b + W):
//   p[l,m]  = exp(q[l] . k[m] + bias_b[h,l,m] - lse[l])
//   c[l]    = sum_d g[l,d] * o[l,d]          (the flash delta identity)
//   ds[l,m] = p[l,m] * (g[l] . v[m] - c[l])
//   dq[l]   = sum_m ds[l,m] * k[m]
//   dk[m]   = sum_l ds[l,m] * q[l]
//   dv[m]   = sum_l p[l,m] * g[l]
//   dtoep[h,l,m] = sum_b ds[b,h,l,m] * in_b[l] * in_b[m]   (float32)
// The offsets get no gradient. q arrives pre-scaled. Operands are
// contiguous (B, H, L, D) with D = 4 and L <= 256; toep is a contiguous
// (1, H, L, L) array in the operand dtype and offsets a contiguous (B,)
// float32 array. float32 and bfloat16 operands; every product, exp and sum
// is float32, dq, dk and dv are rounded once to the operand dtype, and
// dtoep is written in float32 (the caller casts it to toep's dtype). The
// TPU kernel rounds e and ds to bf16 before its products; this one does not.
//
// What bounds it: as for attention_bwd.cu, per (b, h) the work is
// 2*(5*L*L*D + 3*L*L) flops and L*L exps, with D = 4 below every
// tensor-core shape, so the products run on the CUDA cores in f32; by
// bytes it moves q, k, v, g, o, dq, dk, dv, lse, toep, offsets and dtoep
// once. Operations bound it at L >= 128 and bytes below. The per-window
// bias is never built in memory; the dtoep pass works only where a window
// can reach, the band |l - m| < W, and only for the b whose window holds
// both l and m.
//
// Design (a simple correct first version, three launches, as
// attention_bwd.cu; none of the TPU layout is kept — no (B, H, D, L)
// transpose, no lane packing, no pre-transposed packed toep):
// * dq pass: one thread per query row, K and V of the block's heads staged
//   in shared memory. A row inside its window adds toep[h, l, m] for the
//   keys m of the window only, a row outside it adds nothing (as in the
//   forward). Each thread also writes its row's c to a float32 (B, H, L)
//   scratch for the two later passes.
// * dk/dv pass: one thread per key row m, q, g, lse and c of the block's
//   heads staged in shared memory. A key inside its window adds
//   toep[h, l, m] for the query rows l of the window, read by column:
//   neighbouring threads read neighbouring addresses.
// * dtoep pass: one thread per (h, l, m). Outside the band |l - m| < W no
//   window holds both l and m, so the thread writes 0. Inside it, the
//   thread loops b = 0 .. B-1 in order, skips the b whose window misses l
//   or m, and adds ds[b, h, l, m] recomputed from q, k, v, g, lse and c.
//   The TPU walks the batch on a sequential grid with the output block as
//   accumulator; Hopper's blocks run in no order, so the loop inside one
//   thread takes its place.
// Every output element is summed by one thread in one fixed order: no
// atomics, and a call gives bit-identical results every time.

#include <cuda_bf16.h>
#include <cuda_runtime.h>

namespace {

constexpr int kD = 4;
constexpr int kRows = 128;
constexpr int kMaxL = 256;
constexpr int kToepThreads = 256;

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

// The integer positions i in [0, L) with off <= i < off + W, as [lo, hi)
// (the same test as attention_rpos_fwd.cu).
__device__ __forceinline__ void window(float off, int W, int L, int& lo,
                                       int& hi) {
  const float fl = static_cast<float>(L);
  lo = static_cast<int>(ceilf(fminf(fmaxf(off, 0.f), fl)));
  hi = static_cast<int>(ceilf(fminf(fmaxf(off + static_cast<float>(W), 0.f), fl)));
  if (hi < lo) hi = lo;
}

template <typename T>
__global__ void __launch_bounds__(kRows)
attention_rpos_bwd_dq_kernel(const T* __restrict__ q, const T* __restrict__ k,
                             const T* __restrict__ v,
                             const T* __restrict__ toep,
                             const float* __restrict__ offsets,
                             const T* __restrict__ g, const T* __restrict__ o,
                             const float* __restrict__ lse,
                             float* __restrict__ c, T* __restrict__ dq, int H,
                             int L, int W, int n_rows) {
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
  const int b = bh / H;
  const int h = bh - b * H;
  const float4* kh = ks + (bh * L - key0);
  const float4* vh = vs + (bh * L - key0);
  const float4 qr = load4(q + row * kD);
  const float4 gr = load4(g + row * kD);
  const float cr = dot4(gr, load4(o + row * kD));
  const float lr = lse[row];
  c[row] = cr;
  int lo, hi;
  window(offsets[b], W, L, lo, hi);
  if (l < lo || l >= hi) hi = lo;  // a row outside the window: no bias
  const unsigned width = static_cast<unsigned>(hi - lo);
  const T* trow = toep + (h * L + l) * L;

  float4 acc = make_float4(0.f, 0.f, 0.f, 0.f);
  for (int m = 0; m < L; ++m) {
    const float4 km = kh[m];
    float s = dot4(qr, km);
    if (static_cast<unsigned>(m - lo) < width) s += load1(trow + m);
    const float ds = __expf(s - lr) * (dot4(gr, vh[m]) - cr);
    fma4(ds, km, acc);
  }
  store4(dq + row * kD, acc);
}

template <typename T>
__global__ void __launch_bounds__(kRows)
attention_rpos_bwd_dkdv_kernel(const T* __restrict__ q,
                               const T* __restrict__ k,
                               const T* __restrict__ v,
                               const T* __restrict__ toep,
                               const float* __restrict__ offsets,
                               const T* __restrict__ g,
                               const float* __restrict__ lse,
                               const float* __restrict__ c,
                               T* __restrict__ dk, T* __restrict__ dv, int H,
                               int L, int W, int n_rows) {
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
  const int b = bh / H;
  const int h = bh - b * H;
  const int off = bh * L - first;
  const float4 kr = load4(k + row * kD);
  const float4 vr = load4(v + row * kD);
  int lo, hi;
  window(offsets[b], W, L, lo, hi);
  if (m < lo || m >= hi) hi = lo;  // a key outside the window: no bias
  const unsigned width = static_cast<unsigned>(hi - lo);
  const T* tcol = toep + h * L * L + m;  // toep[h, l, m] is tcol[l * L]

  float4 dk_acc = make_float4(0.f, 0.f, 0.f, 0.f);
  float4 dv_acc = make_float4(0.f, 0.f, 0.f, 0.f);
  for (int l = 0; l < L; ++l) {
    const float4 ql = qs[off + l];
    const float4 gl = gs[off + l];
    float s = dot4(ql, kr);
    if (static_cast<unsigned>(l - lo) < width) s += load1(tcol + l * L);
    const float p = __expf(s - ls[off + l]);
    fma4(p, gl, dv_acc);
    fma4(p * (dot4(gl, vr) - cs[off + l]), ql, dk_acc);
  }
  store4(dk + row * kD, dk_acc);
  store4(dv + row * kD, dv_acc);
}

template <typename T>
__global__ void __launch_bounds__(kToepThreads)
attention_rpos_bwd_dtoep_kernel(const T* __restrict__ q,
                                const T* __restrict__ k,
                                const T* __restrict__ v,
                                const T* __restrict__ toep,
                                const float* __restrict__ offsets,
                                const T* __restrict__ g,
                                const float* __restrict__ lse,
                                const float* __restrict__ c,
                                float* __restrict__ dtoep, int B, int H,
                                int L, int W) {
  const int idx = blockIdx.x * kToepThreads + threadIdx.x;  // (h, l, m)
  if (idx >= H * L * L) return;
  const int m = idx % L;
  const int hl = idx / L;
  const int l = hl % L;
  const int h = hl / L;
  float acc = 0.f;
  if (abs(l - m) < W) {  // outside the band no window holds both l and m
    const int first = min(l, m);
    const int last = max(l, m);
    const float tv = load1(toep + idx);
    const int stride = H * L;  // rows between consecutive batch elements
    int qrow = h * L + l;
    int krow = h * L + m;
    for (int b = 0; b < B; ++b, qrow += stride, krow += stride) {
      int lo, hi;
      window(offsets[b], W, L, lo, hi);
      if (first < lo || last >= hi) continue;
      const float p =
          __expf(dot4(load4(q + qrow * kD), load4(k + krow * kD)) + tv -
                 lse[qrow]);
      acc = fmaf(p, dot4(load4(g + qrow * kD), load4(v + krow * kD)) - c[qrow],
                 acc);
    }
  }
  dtoep[idx] = acc;
}

template <typename T>
cudaError_t launch(const void* q, const void* k, const void* v,
                   const void* toep, const float* offsets, const void* g,
                   const void* o, const float* lse, float* c, void* dq,
                   void* dk, void* dv, float* dtoep, int B, int H, int L,
                   int W, cudaStream_t stream) {
  const int n_rows = B * H * L;
  const dim3 grid((n_rows + kRows - 1) / kRows);
  const int cap = head_capacity(L);
  const size_t smem_dq = 2 * cap * sizeof(float4);
  const size_t smem_dkdv = cap * (2 * sizeof(float4) + 2 * sizeof(float));
  const T* qt = static_cast<const T*>(q);
  const T* kt = static_cast<const T*>(k);
  const T* vt = static_cast<const T*>(v);
  const T* tt = static_cast<const T*>(toep);
  const T* gt = static_cast<const T*>(g);
  attention_rpos_bwd_dq_kernel<T><<<grid, kRows, smem_dq, stream>>>(
      qt, kt, vt, tt, offsets, gt, static_cast<const T*>(o), lse, c,
      static_cast<T*>(dq), H, L, W, n_rows);
  cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess) return err;
  attention_rpos_bwd_dkdv_kernel<T><<<grid, kRows, smem_dkdv, stream>>>(
      qt, kt, vt, tt, offsets, gt, lse, c, static_cast<T*>(dk),
      static_cast<T*>(dv), H, L, W, n_rows);
  err = cudaGetLastError();
  if (err != cudaSuccess) return err;
  const dim3 grid_toep((H * L * L + kToepThreads - 1) / kToepThreads);
  attention_rpos_bwd_dtoep_kernel<T><<<grid_toep, kToepThreads, 0, stream>>>(
      qt, kt, vt, tt, offsets, gt, lse, c, dtoep, B, H, L, W);
  return cudaGetLastError();
}

}  // namespace

// Plain C interface for ctypes. dtype: 0 = float32, 1 = bfloat16. `lse` is
// the forward's float32 (B, H, L) residual, `c` a float32 (B, H, L)
// scratch the call fills and `dtoep` a float32 (1, H, L, L) output.
// Launches on `stream` of card `device`, does not synchronise and
// allocates nothing. Returns the first failing launch's cudaError_t
// (0 = success).
extern "C" int ecg_attention_rpos_bwd(const void* q, const void* k,
                                      const void* v, const void* toep,
                                      const void* offsets, const void* g,
                                      const void* o, const void* lse, void* c,
                                      void* dq, void* dk, void* dv,
                                      void* dtoep, int B, int H, int L, int D,
                                      int W, int dtype, int device,
                                      void* stream) {
  if (B < 1 || H < 1 || L < 1 || L > kMaxL || D != kD || W < 1 ||
      toep == nullptr || offsets == nullptr || dtoep == nullptr) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return static_cast<int>(err);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const float* off = static_cast<const float*>(offsets);
  const float* lse_f = static_cast<const float*>(lse);
  float* c_f = static_cast<float*>(c);
  float* dtoep_f = static_cast<float*>(dtoep);
  switch (dtype) {
    case 0:
      err = launch<float>(q, k, v, toep, off, g, o, lse_f, c_f, dq, dk, dv,
                          dtoep_f, B, H, L, W, s);
      break;
    case 1:
      err = launch<__nv_bfloat16>(q, k, v, toep, off, g, o, lse_f, c_f, dq,
                                  dk, dv, dtoep_f, B, H, L, W, s);
      break;
    default:
      err = cudaErrorInvalidValue;
  }
  return static_cast<int>(err);
}

extern "C" const char* ecg_cuda_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}
