// Dense-packed attention forward (B5) — RA-LENet's short-sequence attention
// stages on Hopper (sm_90a), the eval forward with ECG_ATTN_DENSE=1.
//
// Replaces the TPU kernel ecg_denoise_tpu/kernels/attention_pallas.py
// _fwd_dense_kernel (:449), launched through _fwd_dense (:524-559, the
// pallas_call at :546) from fused_attention -> _fused_single -> _fwd (:618)
// when the stage is lane-packable (_pack_factor: L < 128 a power of two,
// P = min(128 / L, H) > 1), ECG_ATTN_DENSE=1 and no softmax residual is
// wanted.
//
// Computes exactly attention_fwd.cu's function, without the lse:
//   out[b,h,l,:] = sum_m p[l,m] * v[b,h,m,:]
//   p[l,:]       = softmax_m(q[b,h,l,:] . k[b,h,m,:] + bias[0,h,l,m])
// q arrives pre-scaled. Operands are contiguous (B, H, L, D) with D = 4;
// bias is a contiguous (1, H, L, L) array shared by the batch, or absent.
// float32 and bfloat16 operands; logits, the row max, exp, the sums and the
// weighted sum are float32, and the output is rounded once.
//
// Where it parts from the TPU kernel on purpose: the TPU kernel subtracts
// ONE max over the whole packed (L, P*L) row, across all P heads, and
// clamps the sum at 1e-37; a head whose logits sit some 87 below another
// head's at the same query underflows to a zero sum and its output
// collapses. Here every head subtracts its own row max: the exact softmax.
// The two agree wherever the TPU kernel is exact (ROADMAP section C).
//
// What bounds it: per (b, h) the work is 2*(2*L*L*D + L*L) flops and L*L
// exps against 4*L*D operand elements plus the shared bias. At the four
// shapes the route takes in RA-LENet, B = 1024, f32, that is HBM: 33.7 MB
// at (L, H) = (64, 8), 33.6 MB at (32, 16), 33.5 MB at (16, 32) and 16.8 MB
// at (64, 4), about 10 us (5 us at (64, 4)) at 3.35 TB/s, against 9.0, 4.5,
// 2.3 and 4.5 us of f32 arithmetic at 67 TFLOP/s. D = 4 is below every
// tensor-core shape. What held attention_fwd.cu (B1) far above that bound
// at these shapes is its bias reads: one thread per query row, so one
// warp's loads of the bias touch 32 rows and 32 sectors.
//
// Design (the Hopper form of the TPU kernel's dense (L, P*L) tile):
// * A warp owns one query position l of a group of HP heads of one batch
//   element b; its 32 lanes cover the group's HP*L (head, key) pairs. HP
//   is the largest power of two that divides H and is at most min(P, 32),
//   so each head gets S = 32 / HP lanes, an aligned run of the warp, and
//   each lane C = ceil(L / S) <= 4 keys m = sub + i*S (HP*L <= P*L <= 128).
//   At the four shapes above HP = P and HP*L = 128: 4 keys a lane. Where
//   HP*L < 32 (L <= 8 with few heads) the lanes past L idle.
// * The block stages the group's K and V rows, converted to f32, in shared
//   memory (HP*L rows, contiguous in memory, at most 4 KB); its warps take
//   the L query positions in turn.
// * For load i, the S lanes of one head read S consecutive bias values of
//   that head's row l: a warp reads its HP bias rows as HP coalesced runs
//   where B1 makes 32 scattered reads.
// * The row max, then the sum and the four V-weighted sums (the TPU's
//   ones-row sum is a fifth accumulator beside them) are reduced over the
//   S lanes of a head with butterfly shuffles: offsets below S stay inside
//   the aligned run, so each head is reduced on its own. Lane sub = 0
//   writes the output row. No atomics: every output has one fixed order of
//   sums, so two calls give bit-identical outputs.

#include <cuda_bf16.h>
#include <cuda_runtime.h>

namespace {

constexpr int kD = 4;
constexpr int kLanes = 32;
constexpr int kMaxPairs = 128;                    // P*L of the route
constexpr int kMaxPerLane = kMaxPairs / kLanes;   // keys a lane holds
constexpr int kWarps = 8;

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

template <typename T, bool kBias>
__global__ void __launch_bounds__(kWarps * kLanes)
attention_dense_fwd_kernel(const T* __restrict__ q, const T* __restrict__ k,
                           const T* __restrict__ v, const T* __restrict__ bias,
                           T* __restrict__ o, int H, int L, int HP) {
  __shared__ float4 ks[kMaxPairs];
  __shared__ float4 vs[kMaxPairs];

  const int groups = H / HP;
  const int b = blockIdx.x / groups;
  const int h0 = (blockIdx.x - b * groups) * HP;
  const long long base = (static_cast<long long>(b) * H + h0) * L;  // (b, h0, 0)
  const int n_pairs = HP * L;
  for (int i = threadIdx.x; i < n_pairs; i += blockDim.x) {
    ks[i] = load4(k + (base + i) * kD);
    vs[i] = load4(v + (base + i) * kD);
  }
  __syncthreads();

  const int lane = threadIdx.x & (kLanes - 1);
  const int warp = threadIdx.x / kLanes;
  const int n_warps = blockDim.x / kLanes;
  const int S = kLanes / HP;         // lanes per head
  const int hp = lane / S;           // this lane's head in the group
  const int sub = lane - hp * S;     // its place among the head's lanes
  const int C = (L + S - 1) / S;     // keys per lane, <= kMaxPerLane
  const float4* kh = ks + hp * L;
  const float4* vh = vs + hp * L;
  const long long head_row0 = base + static_cast<long long>(hp) * L;  // (b, h, 0)

  // Warp-uniform loop: every lane of a warp takes the same positions, so
  // the full-mask shuffles below are safe.
  for (int l = warp; l < L; l += n_warps) {
    const long long row = head_row0 + l;
    const float4 qr = load4(q + row * kD);
    const T* brow = nullptr;
    if (kBias) brow = bias + (static_cast<long long>(h0 + hp) * L + l) * L;

    float s[kMaxPerLane];
    float mx = __int_as_float(0xff800000);  // -inf
#pragma unroll
    for (int i = 0; i < kMaxPerLane; ++i) {
      const int m = sub + i * S;
      s[i] = 0.f;
      if (i < C && m < L) {
        s[i] = dot4(qr, kh[m]);
        if (kBias) s[i] += load1(brow + m);
        mx = fmaxf(mx, s[i]);
      }
    }
    for (int off = S >> 1; off > 0; off >>= 1) {
      mx = fmaxf(mx, __shfl_xor_sync(0xffffffffu, mx, off));
    }

    float sum = 0.f;
    float4 acc = make_float4(0.f, 0.f, 0.f, 0.f);
#pragma unroll
    for (int i = 0; i < kMaxPerLane; ++i) {
      const int m = sub + i * S;
      if (i < C && m < L) {
        const float e = __expf(s[i] - mx);
        const float4 vv = vh[m];
        sum += e;
        acc.x = fmaf(e, vv.x, acc.x);
        acc.y = fmaf(e, vv.y, acc.y);
        acc.z = fmaf(e, vv.z, acc.z);
        acc.w = fmaf(e, vv.w, acc.w);
      }
    }
    for (int off = S >> 1; off > 0; off >>= 1) {
      sum += __shfl_xor_sync(0xffffffffu, sum, off);
      acc.x += __shfl_xor_sync(0xffffffffu, acc.x, off);
      acc.y += __shfl_xor_sync(0xffffffffu, acc.y, off);
      acc.z += __shfl_xor_sync(0xffffffffu, acc.z, off);
      acc.w += __shfl_xor_sync(0xffffffffu, acc.w, off);
    }
    if (sub == 0) {
      store4(o + row * kD,
             make_float4(acc.x / sum, acc.y / sum, acc.z / sum, acc.w / sum));
    }
  }
}

// Heads a warp takes: the largest power of two that divides H and is at
// most min(P, 32).
int heads_per_warp(int H, int P) {
  int hp = 1;
  while (2 * hp <= P && 2 * hp <= kLanes && H % (2 * hp) == 0) hp *= 2;
  return hp;
}

template <typename T>
cudaError_t launch(const void* q, const void* k, const void* v,
                   const void* bias, void* o, int B, int H, int L, int P,
                   cudaStream_t stream) {
  const int hp = heads_per_warp(H, P);
  const dim3 grid(static_cast<unsigned>(B) * (H / hp));
  const dim3 block(kLanes * (L < kWarps ? L : kWarps));
  const T* qt = static_cast<const T*>(q);
  const T* kt = static_cast<const T*>(k);
  const T* vt = static_cast<const T*>(v);
  const T* bt = static_cast<const T*>(bias);
  T* ot = static_cast<T*>(o);
  if (bias != nullptr) {
    attention_dense_fwd_kernel<T, true><<<grid, block, 0, stream>>>(
        qt, kt, vt, bt, ot, H, L, hp);
  } else {
    attention_dense_fwd_kernel<T, false><<<grid, block, 0, stream>>>(
        qt, kt, vt, bt, ot, H, L, hp);
  }
  return cudaGetLastError();
}

}  // namespace

// Plain C interface for ctypes. dtype: 0 = float32, 1 = bfloat16. `bias`
// may be null. P is the route's pack factor (dense_pack_factor in
// attention_dense.py): the call is refused unless L < 128 is a power of
// two, P > 1 divides H and P*L <= 128. Launches on `stream` of card
// `device`, does not synchronise and allocates nothing. Returns the
// launch's cudaError_t (0 = success).
extern "C" int ecg_attention_dense_fwd(const void* q, const void* k,
                                       const void* v, const void* bias,
                                       void* o, int B, int H, int L, int D,
                                       int P, int dtype, int device,
                                       void* stream) {
  if (B < 1 || H < 1 || L < 1 || L >= kMaxPairs || (L & (L - 1)) != 0 ||
      D != kD || P < 2 || H % P != 0 || P * L > kMaxPairs) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return static_cast<int>(err);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  switch (dtype) {
    case 0:
      err = launch<float>(q, k, v, bias, o, B, H, L, P, s);
      break;
    case 1:
      err = launch<__nv_bfloat16>(q, k, v, bias, o, B, H, L, P, s);
      break;
    default:
      err = cudaErrorInvalidValue;
  }
  return static_cast<int>(err);
}

extern "C" const char* ecg_cuda_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}
