// Precision probes: how each arithmetic path of Hopper (sm_90a) rounds a
// float32 product, a softmax row sum and a divide.
//
// Replaces the four TPU kernels of scripts/probe_precision.py, each a
// pallas_call on whole (L, L) = (256, 256) float32 tiles:
// * dot_kernel (:51, launched at :58): C = A.B at a given dot_general
//   precision (DEFAULT, one bf16 pass of the MXU; HIGHEST, multi-pass f32).
// * fold_kernel (:77, launched at :100): softmax(logits) times a (D, L) v
//   with the row sum folded into the product as a ones row of v (:81-86),
//   at a given precision.
// * tree_kernel (:89, launched at :106): the same with the row sum taken
//   first, as a tree, and p = e / sum before the product.
// * div_kernel (:115, launched at :119): an (8, 256) elementwise divide.
//
// The dot and the fold take a precision, one path of the card each:
//   0 ieee    f32 FMAs on the CUDA cores, one thread per output, k in order
//             (the port's attention kernels' own arithmetic; the TPU's HIGHEST)
//   1 tf32    mma.sync m16n8k8 TF32, inputs rounded by cvt.rna.tf32.f32
//             (what cuBLAS with allow_tf32 and Triton's default tl.dot give)
//   2 tf32x3  x = hi + lo, each part rounded rna to TF32; the same mma sums
//             lo.hi + hi.lo + hi.hi into one f32 accumulator (the tensor
//             cores' counterpart of the TPU's multi-pass HIGHEST)
//   3 bf16    inputs rounded RNE to bf16, mma.sync m16n8k16 with f32
//             accumulate (the TPU's one-pass DEFAULT)
// Every sum is this file's own: no cuBLAS, no CUTLASS GEMM. Inputs are
// converted explicitly: a TF32 mma fed raw f32 bits would truncate them.
//
// What bounds them: nothing that matters to a probe. At (256, 256, 256)
// the dot moves 0.79 MB and does 33.5 MFLOP (0.24 us of HBM, 0.5 us of
// the f32 CUDA-core peak, 0.07 us of the TF32 one); the fold, the tree and
// the divide move under 0.3 MB. Each kernel is the simplest that is right:
// one warp per 16x8 output tile, operands read straight from global memory
// (the L2 holds them), so its time is its latency, not a rate.
//
// The fold pads its D + 1 rows of [v; ones] to the mma's 16 rows with
// zeros: only row D is the ones row, and it goes through the same rounding
// as the en it sums, which is the fold's point. The tree sums each row in a
// warp, lane by lane in order and then across lanes by a butterfly
// __shfl_xor_sync, as B5 (attention_dense_fwd.cu) sums; B1
// (attention_fwd.cu) instead sums a row's exps in sequence, one thread per
// row, and divides once at the end. Both softmax kernels take the row max
// first and use expf, PyTorch's exp on the card: an exp one ulp apart can
// round to another TF32 or bf16 value, which the fold's product would show.
// The divide is `/` under the port's nvcc flags (no --use_fast_math), IEEE
// division rounded to nearest.

#include <cuda_bf16.h>
#include <cuda_runtime.h>

#include <cstdint>

namespace {

enum Precision { kIeee = 0, kTf32 = 1, kTf32x3 = 2, kBf16 = 3 };

constexpr int kMaxL = 1024;     // softmax row length the shared buffers hold
constexpr int kMaxD = 15;       // D + 1 rows of [v; ones] fit one mma tile
constexpr int kSoftmaxRows = 8;  // query rows per block: the mma's n = 8

__device__ __forceinline__ uint32_t tf32_rna(float x) {
  uint32_t r;
  asm("cvt.rna.tf32.f32 %0, %1;" : "=r"(r) : "f"(x));
  return r & 0xffffe000u;  // the TF32 value, its 13 dropped bits cleared
}

// Two values rounded RNE to bf16, the first in the low half.
__device__ __forceinline__ uint32_t bf16x2(float lo, float hi) {
  return static_cast<uint32_t>(__bfloat16_as_ushort(__float2bfloat16_rn(lo))) |
         static_cast<uint32_t>(__bfloat16_as_ushort(__float2bfloat16_rn(hi))) << 16;
}

__device__ __forceinline__ void mma_tf32(float (&c)[4], const uint32_t (&a)[4],
                                         const uint32_t (&b)[2]) {
  asm volatile(
      "mma.sync.aligned.m16n8k8.row.col.f32.tf32.tf32.f32 "
      "{%0, %1, %2, %3}, {%4, %5, %6, %7}, {%8, %9}, {%0, %1, %2, %3};\n"
      : "+f"(c[0]), "+f"(c[1]), "+f"(c[2]), "+f"(c[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b[0]), "r"(b[1]));
}

__device__ __forceinline__ void mma_bf16(float (&c)[4], const uint32_t (&a)[4],
                                         const uint32_t (&b)[2]) {
  asm volatile(
      "mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 "
      "{%0, %1, %2, %3}, {%4, %5, %6, %7}, {%8, %9}, {%0, %1, %2, %3};\n"
      : "+f"(c[0]), "+f"(c[1]), "+f"(c[2]), "+f"(c[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b[0]), "r"(b[1]));
}

// One warp adds A.B over k < K to its 16x8 tile c, on the tensor cores at
// precision P. a_at(r, k) is A[r][k] and b_at(k, n) is B[k][n] relative to
// the tile, 0 outside the matrices. Fragments (PTX ISA, mma.m16n8k8 .tf32
// and mma.m16n8k16 .bf16), with g = lane / 4 and t = lane % 4:
//   tf32 A: a0 (g, t), a1 (g+8, t), a2 (g, t+4), a3 (g+8, t+4)
//        B: b0 (t, g), b1 (t+4, g)
//   bf16 A: a0 (g, 2t..2t+1), a1 (g+8, 2t..), a2 (g, 2t+8..), a3 (g+8, 2t+8..)
//        B: b0 (2t..2t+1, g), b1 (2t+8..2t+9, g), lower k in the low half
//   C: c0 (g, 2t), c1 (g, 2t+1), c2 (g+8, 2t), c3 (g+8, 2t+1)
template <int P, class LoadA, class LoadB>
__device__ __forceinline__ void mma_tile(float (&c)[4], int K, LoadA a_at, LoadB b_at) {
  const int lane = threadIdx.x & 31;
  const int g = lane >> 2, t = lane & 3;
  if constexpr (P == kBf16) {
    for (int k0 = 0; k0 < K; k0 += 16) {
      const int k = k0 + 2 * t;
      const uint32_t a[4] = {bf16x2(a_at(g, k), a_at(g, k + 1)),
                             bf16x2(a_at(g + 8, k), a_at(g + 8, k + 1)),
                             bf16x2(a_at(g, k + 8), a_at(g, k + 9)),
                             bf16x2(a_at(g + 8, k + 8), a_at(g + 8, k + 9))};
      const uint32_t b[2] = {bf16x2(b_at(k, g), b_at(k + 1, g)),
                             bf16x2(b_at(k + 8, g), b_at(k + 9, g))};
      mma_bf16(c, a, b);
    }
  } else {
    for (int k0 = 0; k0 < K; k0 += 8) {
      const int k = k0 + t;
      const float af[4] = {a_at(g, k), a_at(g + 8, k), a_at(g, k + 4), a_at(g + 8, k + 4)};
      const float bf[2] = {b_at(k, g), b_at(k + 4, g)};
      uint32_t ah[4], bh[2];
#pragma unroll
      for (int i = 0; i < 4; ++i) ah[i] = tf32_rna(af[i]);
#pragma unroll
      for (int i = 0; i < 2; ++i) bh[i] = tf32_rna(bf[i]);
      if constexpr (P == kTf32x3) {
        // x - hi is exact in f32; the small products go in first.
        uint32_t al[4], bl[2];
#pragma unroll
        for (int i = 0; i < 4; ++i) al[i] = tf32_rna(af[i] - __uint_as_float(ah[i]));
#pragma unroll
        for (int i = 0; i < 2; ++i) bl[i] = tf32_rna(bf[i] - __uint_as_float(bh[i]));
        mma_tf32(c, al, bh);
        mma_tf32(c, ah, bl);
      }
      mma_tf32(c, ah, bh);
    }
  }
}

// --- dot: C (M, N) = A (M, K) . B (K, N), all row-major f32 ------------

constexpr int kDotWarps = 4;  // a block: 16 rows x (4 warps x 8 columns)

template <int P>
__global__ void __launch_bounds__(32 * kDotWarps)
probe_dot_mma(const float* __restrict__ A, const float* __restrict__ B,
              float* __restrict__ C, int M, int N, int K) {
  const int n0 = (blockIdx.x * kDotWarps + (threadIdx.x >> 5)) * 8;
  const int m0 = blockIdx.y * 16;
  if (n0 >= N) return;  // whole warps only: mma.sync needs all 32 lanes
  float c[4] = {0.f, 0.f, 0.f, 0.f};
  mma_tile<P>(
      c, K,
      [&](int r, int k) {
        return (m0 + r < M && k < K) ? A[static_cast<size_t>(m0 + r) * K + k] : 0.f;
      },
      [&](int k, int n) {
        return (k < K && n0 + n < N) ? B[static_cast<size_t>(k) * N + n0 + n] : 0.f;
      });
  const int lane = threadIdx.x & 31;
  const int g = lane >> 2, t = lane & 3;
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const int m = m0 + g + (i >> 1) * 8, n = n0 + 2 * t + (i & 1);
    if (m < M && n < N) C[static_cast<size_t>(m) * N + n] = c[i];
  }
}

__global__ void __launch_bounds__(256)
probe_dot_ieee(const float* __restrict__ A, const float* __restrict__ B,
               float* __restrict__ C, int M, int N, int K) {
  const int n = blockIdx.x * 32 + threadIdx.x;
  const int m = blockIdx.y * 8 + threadIdx.y;
  if (m >= M || n >= N) return;
  const float* a = A + static_cast<size_t>(m) * K;
  float acc = 0.f;
  for (int k = 0; k < K; ++k) acc = fmaf(a[k], B[static_cast<size_t>(k) * N + n], acc);
  C[static_cast<size_t>(m) * N + n] = acc;
}

// --- softmax row max and exp, shared by the fold and the tree ------------

__device__ __forceinline__ float warp_max(float x) {
#pragma unroll
  for (int off = 16; off > 0; off >>= 1) x = fmaxf(x, __shfl_xor_sync(0xffffffffu, x, off));
  return x;
}

__device__ __forceinline__ float warp_sum(float x) {
#pragma unroll
  for (int off = 16; off > 0; off >>= 1) x += __shfl_xor_sync(0xffffffffu, x, off);
  return x;
}

// One warp writes exp(row - max(row)) of logits row i into e[0..L), 0 for
// a row past L; returns this lane's sum of its own entries, in order.
__device__ __forceinline__ float row_exp(const float* __restrict__ logits, int i, int L,
                                         float* e) {
  const int lane = threadIdx.x & 31;
  float part = 0.f;
  if (i >= L) {
    for (int j = lane; j < L; j += 32) e[j] = 0.f;
    return part;
  }
  const float* row = logits + static_cast<size_t>(i) * L;
  float mx = __int_as_float(0xff800000);  // -inf
  for (int j = lane; j < L; j += 32) mx = fmaxf(mx, row[j]);
  mx = warp_max(mx);
  for (int j = lane; j < L; j += 32) {
    const float x = expf(row[j] - mx);
    e[j] = x;
    part += x;
  }
  return part;
}

// --- fold: o (D, L) = of[:D] / of[D], of = [v; ones] . en^T --------------

template <int P>
__global__ void __launch_bounds__(32 * kSoftmaxRows)
probe_fold(const float* __restrict__ logits, const float* __restrict__ v,
           float* __restrict__ o, int L, int D) {
  __shared__ float en[kSoftmaxRows][kMaxL];
  __shared__ float of[16][kSoftmaxRows];
  const int warp = threadIdx.x >> 5;
  const int i0 = blockIdx.x * kSoftmaxRows;
  row_exp(logits, i0 + warp, L, en[warp]);
  __syncthreads();
  // vx = [v; ones], rows past D zero (never ones), columns past L zero.
  auto vx = [&](int r, int k) {
    return (k >= L || r > D) ? 0.f : (r == D ? 1.f : v[static_cast<size_t>(r) * L + k]);
  };
  if constexpr (P == kIeee) {
    const int r = threadIdx.x / kSoftmaxRows, n = threadIdx.x % kSoftmaxRows;
    if (r <= D) {
      float acc = 0.f;
      for (int k = 0; k < L; ++k) acc = fmaf(vx(r, k), en[n][k], acc);
      of[r][n] = acc;
    }
  } else if (warp == 0) {
    float c[4] = {0.f, 0.f, 0.f, 0.f};
    mma_tile<P>(c, L, vx, [&](int k, int n) { return k < L ? en[n][k] : 0.f; });
    const int g = (threadIdx.x & 31) >> 2, t = threadIdx.x & 3;
    of[g][2 * t] = c[0];
    of[g][2 * t + 1] = c[1];
    of[g + 8][2 * t] = c[2];
    of[g + 8][2 * t + 1] = c[3];
  }
  __syncthreads();
  const int r = threadIdx.x / kSoftmaxRows, n = threadIdx.x % kSoftmaxRows;
  if (r < D && i0 + n < L) o[static_cast<size_t>(r) * L + i0 + n] = of[r][n] / of[D][n];
}

// --- tree: p = e / tree_sum(e), o (D, L) = v . p^T on the CUDA cores -----

__global__ void __launch_bounds__(32 * kSoftmaxRows)
probe_tree(const float* __restrict__ logits, const float* __restrict__ v,
           float* __restrict__ o, int L, int D) {
  __shared__ float p[kSoftmaxRows][kMaxL];
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int i = blockIdx.x * kSoftmaxRows + warp;
  if (i >= L) return;  // whole warps; no block-wide barrier follows
  const float sum = warp_sum(row_exp(logits, i, L, p[warp]));
  for (int j = lane; j < L; j += 32) p[warp][j] /= sum;
  __syncwarp();
  if (lane < D) {
    const float* vr = v + static_cast<size_t>(lane) * L;
    float acc = 0.f;
    for (int j = 0; j < L; ++j) acc = fmaf(vr[j], p[warp][j], acc);
    o[static_cast<size_t>(lane) * L + i] = acc;
  }
}

// --- divide ----------------------------------------------------------------

__global__ void __launch_bounds__(256)
probe_div(const float* __restrict__ n, const float* __restrict__ d, float* __restrict__ o,
          int count) {
  const int i = blockIdx.x * 256 + threadIdx.x;
  if (i < count) o[i] = n[i] / d[i];
}

template <int P>
void launch_dot(const float* a, const float* b, float* c, int M, int N, int K,
                cudaStream_t stream) {
  if constexpr (P == kIeee) {
    probe_dot_ieee<<<dim3((N + 31) / 32, (M + 7) / 8), dim3(32, 8), 0, stream>>>(
        a, b, c, M, N, K);
  } else {
    const dim3 grid((N + 8 * kDotWarps - 1) / (8 * kDotWarps), (M + 15) / 16);
    probe_dot_mma<P><<<grid, 32 * kDotWarps, 0, stream>>>(a, b, c, M, N, K);
  }
}

template <int P>
void launch_fold(const float* logits, const float* v, float* o, int L, int D,
                 cudaStream_t stream) {
  probe_fold<P><<<(L + kSoftmaxRows - 1) / kSoftmaxRows, 32 * kSoftmaxRows, 0, stream>>>(
      logits, v, o, L, D);
}

}  // namespace

// Plain C interface for ctypes. Every operand is a contiguous float32
// array on card `device`; each function launches on `stream`, does not
// synchronise, allocates nothing, and returns the launch's cudaError_t
// (0 = success). `precision` is 0 ieee, 1 tf32, 2 tf32x3, 3 bf16.

// c (M, N) = a (M, K) . b (K, N).
extern "C" int ecg_probe_dot(const void* a, const void* b, void* c, int M, int N, int K,
                             int precision, int device, void* stream) {
  if (M < 1 || N < 1 || K < 1 || (M + 7) / 8 > 65535) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return static_cast<int>(err);
  const auto* A = static_cast<const float*>(a);
  const auto* B = static_cast<const float*>(b);
  auto* C = static_cast<float*>(c);
  const auto s = static_cast<cudaStream_t>(stream);
  switch (precision) {
    case kIeee: launch_dot<kIeee>(A, B, C, M, N, K, s); break;
    case kTf32: launch_dot<kTf32>(A, B, C, M, N, K, s); break;
    case kTf32x3: launch_dot<kTf32x3>(A, B, C, M, N, K, s); break;
    case kBf16: launch_dot<kBf16>(A, B, C, M, N, K, s); break;
    default: return static_cast<int>(cudaErrorInvalidValue);
  }
  return static_cast<int>(cudaGetLastError());
}

// o (D, L) = softmax(logits (L, L)) . v (D, L)^T with the row sum folded
// into the product; 1 <= L <= 1024, 1 <= D <= 15.
extern "C" int ecg_probe_fold(const void* logits, const void* v, void* o, int L, int D,
                              int precision, int device, void* stream) {
  if (L < 1 || L > kMaxL || D < 1 || D > kMaxD) return static_cast<int>(cudaErrorInvalidValue);
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return static_cast<int>(err);
  const auto* lg = static_cast<const float*>(logits);
  const auto* vv = static_cast<const float*>(v);
  auto* out = static_cast<float*>(o);
  const auto s = static_cast<cudaStream_t>(stream);
  switch (precision) {
    case kIeee: launch_fold<kIeee>(lg, vv, out, L, D, s); break;
    case kTf32: launch_fold<kTf32>(lg, vv, out, L, D, s); break;
    case kTf32x3: launch_fold<kTf32x3>(lg, vv, out, L, D, s); break;
    case kBf16: launch_fold<kBf16>(lg, vv, out, L, D, s); break;
    default: return static_cast<int>(cudaErrorInvalidValue);
  }
  return static_cast<int>(cudaGetLastError());
}

// o (D, L) = (e / tree_sum(e)) . v^T, e = exp(logits - row max), in f32 on
// the CUDA cores; 1 <= L <= 1024, 1 <= D <= 15.
extern "C" int ecg_probe_tree(const void* logits, const void* v, void* o, int L, int D,
                              int device, void* stream) {
  if (L < 1 || L > kMaxL || D < 1 || D > kMaxD) return static_cast<int>(cudaErrorInvalidValue);
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return static_cast<int>(err);
  probe_tree<<<(L + kSoftmaxRows - 1) / kSoftmaxRows, 32 * kSoftmaxRows, 0,
               static_cast<cudaStream_t>(stream)>>>(
      static_cast<const float*>(logits), static_cast<const float*>(v),
      static_cast<float*>(o), L, D);
  return static_cast<int>(cudaGetLastError());
}

// o = n / d elementwise over `count` >= 1 values.
extern "C" int ecg_probe_div(const void* n, const void* d, void* o, int count, int device,
                             void* stream) {
  if (count < 1) return static_cast<int>(cudaErrorInvalidValue);
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return static_cast<int>(err);
  probe_div<<<(count + 255) / 256, 256, 0, static_cast<cudaStream_t>(stream)>>>(
      static_cast<const float*>(n), static_cast<const float*>(d), static_cast<float*>(o),
      count);
  return static_cast<int>(cudaGetLastError());
}

extern "C" const char* ecg_cuda_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}
