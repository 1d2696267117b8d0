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
//   0 ieee    f32 FMAs on the CUDA cores, one chain per output, k in order
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
// the divide move under 0.3 MB. So their time is latency, not a rate. The
// fold, the tree and the divide are the simplest kernels that are right
// (the fold: one warp per 16x8 output tile, operands read straight from
// global memory, which the L2 holds). The dot is tiled through shared
// memory, double-buffered, its inputs rounded once as they are staged,
// with several independent accumulation chains a warp (see its section):
// its first version, built like the fold, lost 1.6-1.8 times to cuBLAS.
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
// precision P, rounding each input as it loads it (the fold's product; the
// dot rounds its inputs once, in shared memory, with the same layouts). a_at(r, k) is A[r][k] and b_at(k, n) is B[k][n] relative to
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
//
// A block of 8 warps owns a 32x32 tile of C. It stages a whole k-panel of
// A and B, up to 256 wide (the probe's K in one piece), in shared memory
// with cp.async (16-byte copies where K, resp. N, and the pointer allow,
// 4-byte ones elsewhere; out of the matrices the copies fill zeros), waits
// once, and runs its k-loop from shared memory with no barrier inside, so
// the loads of the next k-steps are in flight while this one computes.
// (Tiled versions that synchronised on every 32-wide k-tile, with 4 warps,
// were slower than the first version: a k-tile's compute is short against
// a barrier and a load's latency, and one warp a scheduler hides neither.)
// * ieee: each thread keeps a 2x2 register tile of C (4 independent FMA
//   chains, two warps a scheduler) fed from the raw panel, k in order,
//   exactly K FMAs per output.
// * tf32, tf32x3, bf16: the panel is rounded once, in shared memory, after
//   it lands (TF32 hi in place and lo beside it, by cvt.rna, masked; bf16
//   pairs RNE), a warp a row of A and a lane a column of B, with no
//   division in the loops; the fragments are read from the rounded panel.
//   Each warp holds one 16x8 accumulator tile, so each scheduler
//   interleaves two mma chains. Per output the sequence of roundings is
//   the first version's: the same mma.sync, the k-steps in order up to the
//   last one that holds a k < K, and for tf32x3 lo.hi, hi.lo, hi.hi in
//   that order.
// Bank conflicts: A's panels ([m][k]) have a row stride of 260 words
// (4 mod 32), so the ieee path's A reads (rows 4w, 4w + 2 of a warp) and
// the A fragments (g * 260 + t = 4g + t) hit distinct banks; B's panels
// ([k][n], bf16 pairs [k / 2][n]) have a stride of 40 words, so the B
// fragments (t * 40 + g = 8t + g) do too; packed bf16 A has a stride of
// 132 words (4g + t again).

constexpr int kDotTile = 32;     // C rows and columns of a block
constexpr int kDotPanel = 256;   // the k-panel
constexpr int kDotWarps = 8;
constexpr int kDotThreads = 32 * kDotWarps;
constexpr int kAStride = kDotPanel + 4;     // words; 16-byte aligned rows
constexpr int kBStride = kDotTile + 8;      // words; 16-byte aligned rows
constexpr int kBf16AStride = kDotPanel / 2 + 4;
constexpr int kAWords = kDotTile * kAStride, kBWords = kDotPanel * kBStride;

// Shared memory: the raw panels (rounded to TF32 hi in place), then the lo
// panels (tf32x3) or the packed bf16 panels.
template <int P>
constexpr int dot_smem_bytes() {
  return 4 * (kAWords + kBWords +
              (P == kTf32x3 ? kAWords + kBWords
                            : P == kBf16 ? kDotTile * kBf16AStride + kDotPanel / 2 * kBStride
                                         : 0));
}

__device__ __forceinline__ void cp_async_f32(float* dst, const float* src, bool in, bool vec) {
  const unsigned s = static_cast<unsigned>(__cvta_generic_to_shared(dst));
  if (vec) {
    asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::"r"(s), "l"(src),
                 "r"(in ? 16 : 0));
  } else {
    asm volatile("cp.async.ca.shared.global [%0], [%1], 4, %2;\n" ::"r"(s), "l"(src),
                 "r"(in ? 4 : 0));
  }
}

template <int P>
__global__ void __launch_bounds__(kDotThreads)
probe_dot_kernel(const float* __restrict__ A, const float* __restrict__ B,
                 float* __restrict__ C, int M, int N, int K, bool a_vec, bool b_vec) {
  extern __shared__ __align__(16) float dot_smem[];
  auto a_raw = reinterpret_cast<float(*)[kAStride]>(dot_smem);
  auto b_raw = reinterpret_cast<float(*)[kBStride]>(dot_smem + kAWords);
  auto a_hi = reinterpret_cast<uint32_t(*)[kAStride]>(a_raw);  // in place
  auto b_hi = reinterpret_cast<uint32_t(*)[kBStride]>(b_raw);
  uint32_t* extra = reinterpret_cast<uint32_t*>(dot_smem + kAWords + kBWords);
  auto a_lo = reinterpret_cast<uint32_t(*)[kAStride]>(extra);
  auto b_lo = reinterpret_cast<uint32_t(*)[kBStride]>(extra + kAWords);
  auto a_bf = reinterpret_cast<uint32_t(*)[kBf16AStride]>(extra);  // pairs along k
  auto b_bf = reinterpret_cast<uint32_t(*)[kBStride]>(extra + kDotTile * kBf16AStride);
  const int m0 = blockIdx.y * kDotTile, n0 = blockIdx.x * kDotTile;
  const int tid = threadIdx.x, warp = tid >> 5, lane = tid & 31;
  // ieee: rows 2ty, 2ty + 1 and columns 2tx, 2tx + 1 of the block's tile.
  const int ty = tid >> 4, tx = tid & 15;
  float acc[2][2] = {};
  // mma: warp w holds the 16x8 tile at rows 16 (w & 1), columns 8 (w >> 1).
  const int g = lane >> 2, t = lane & 3;
  const int mt = (warp & 1) * 16, nt = (warp >> 1) * 8;
  float c[4] = {};

  for (int k0 = 0; k0 < K; k0 += kDotPanel) {
    const int kn = min(kDotPanel, K - k0);  // the panel's k < K
    const int kload = min(kDotPanel, (kn + 15) & ~15);  // zero-filled to whole k-steps
    if (k0 > 0) __syncthreads();  // every thread is done with the last panel
    // A: a warp a row, lanes along k; B: 8 lanes a row of 32 (16-byte
    // copies) or 32 (4-byte ones).
    for (int r = warp; r < kDotTile; r += kDotWarps) {
      const int m = m0 + r;
      if (a_vec) {
        for (int j = 4 * lane; j < kload; j += 128) {
          const bool in = m < M && k0 + j < K;
          cp_async_f32(&a_raw[r][j], in ? A + static_cast<size_t>(m) * K + k0 + j : A, in, true);
        }
      } else {
        for (int j = lane; j < kload; j += 32) {
          const bool in = m < M && k0 + j < K;
          cp_async_f32(&a_raw[r][j], in ? A + static_cast<size_t>(m) * K + k0 + j : A, in, false);
        }
      }
    }
    if (b_vec) {
      for (int r = tid >> 3; r < kload; r += kDotThreads / 8) {
        const int j = 4 * (lane & 7), k = k0 + r, n = n0 + j;
        const bool in = k < K && n < N;
        cp_async_f32(&b_raw[r][j], in ? B + static_cast<size_t>(k) * N + n : B, in, true);
      }
    } else {
      for (int r = warp; r < kload; r += kDotWarps) {
        const int k = k0 + r, n = n0 + lane;
        const bool in = k < K && n < N;
        cp_async_f32(&b_raw[r][lane], in ? B + static_cast<size_t>(k) * N + n : B, in, false);
      }
    }
    asm volatile("cp.async.commit_group;\n" ::);
    asm volatile("cp.async.wait_group 0;\n" ::);
    __syncthreads();  // the panel is in, for every thread

    if constexpr (P == kIeee) {
#pragma unroll 8
      for (int kk = 0; kk < kn; ++kk) {
        const float a0 = a_raw[2 * ty][kk], a1 = a_raw[2 * ty + 1][kk];
        const float2 bv = *reinterpret_cast<const float2*>(&b_raw[kk][2 * tx]);
        acc[0][0] = fmaf(a0, bv.x, acc[0][0]);
        acc[0][1] = fmaf(a0, bv.y, acc[0][1]);
        acc[1][0] = fmaf(a1, bv.x, acc[1][0]);
        acc[1][1] = fmaf(a1, bv.y, acc[1][1]);
      }
    } else {
      // Round the panel once: a warp a row of A, a lane a column of B.
      if constexpr (P == kBf16) {
        for (int r = warp; r < kDotTile; r += kDotWarps) {
#pragma unroll 4
          for (int j = lane; j < kload / 2; j += 32) {
            a_bf[r][j] = bf16x2(a_raw[r][2 * j], a_raw[r][2 * j + 1]);
          }
        }
#pragma unroll 4
        for (int j = warp; j < kload / 2; j += kDotWarps) {
          b_bf[j][lane] = bf16x2(b_raw[2 * j][lane], b_raw[2 * j + 1][lane]);
        }
      } else {
        for (int r = warp; r < kDotTile; r += kDotWarps) {
#pragma unroll 4
          for (int j = lane; j < kload; j += 32) {
            const float x = a_raw[r][j];
            const uint32_t xh = tf32_rna(x);
            a_hi[r][j] = xh;
            if constexpr (P == kTf32x3) a_lo[r][j] = tf32_rna(x - __uint_as_float(xh));
          }
        }
#pragma unroll 4
        for (int r = warp; r < kload; r += kDotWarps) {
          const float y = b_raw[r][lane];
          const uint32_t yh = tf32_rna(y);
          b_hi[r][lane] = yh;
          if constexpr (P == kTf32x3) b_lo[r][lane] = tf32_rna(y - __uint_as_float(yh));
        }
      }
      __syncthreads();
      const int n = nt + g;
      if constexpr (P == kBf16) {
#pragma unroll 4
        for (int kk = 0; kk < kn; kk += 16) {
          const int j = kk / 2 + t;
          const uint32_t a[4] = {a_bf[mt + g][j], a_bf[mt + g + 8][j], a_bf[mt + g][j + 4],
                                 a_bf[mt + g + 8][j + 4]};
          const uint32_t b[2] = {b_bf[j][n], b_bf[j + 4][n]};
          mma_bf16(c, a, b);
        }
      } else {
#pragma unroll 4
        for (int kk = 0; kk < kn; kk += 8) {
          const int k = kk + t;
          const uint32_t ah[4] = {a_hi[mt + g][k], a_hi[mt + g + 8][k], a_hi[mt + g][k + 4],
                                  a_hi[mt + g + 8][k + 4]};
          const uint32_t bh[2] = {b_hi[k][n], b_hi[k + 4][n]};
          if constexpr (P == kTf32x3) {  // the small products go in first
            const uint32_t al[4] = {a_lo[mt + g][k], a_lo[mt + g + 8][k], a_lo[mt + g][k + 4],
                                    a_lo[mt + g + 8][k + 4]};
            const uint32_t bl[2] = {b_lo[k][n], b_lo[k + 4][n]};
            mma_tf32(c, al, bh);
            mma_tf32(c, ah, bl);
          }
          mma_tf32(c, ah, bh);
        }
      }
    }
  }

  if constexpr (P == kIeee) {
#pragma unroll
    for (int i = 0; i < 2; ++i) {
#pragma unroll
      for (int j = 0; j < 2; ++j) {
        const int m = m0 + 2 * ty + i, n = n0 + 2 * tx + j;
        if (m < M && n < N) C[static_cast<size_t>(m) * N + n] = acc[i][j];
      }
    }
  } else {
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      const int m = m0 + mt + g + (i >> 1) * 8, n = n0 + nt + 2 * t + (i & 1);
      if (m < M && n < N) C[static_cast<size_t>(m) * N + n] = c[i];
    }
  }
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
cudaError_t launch_dot(const float* a, const float* b, float* c, int M, int N, int K,
                       cudaStream_t stream) {
  // Above 48 KB a block's dynamic shared memory must be allowed, once.
  static const cudaError_t allowed = cudaFuncSetAttribute(
      probe_dot_kernel<P>, cudaFuncAttributeMaxDynamicSharedMemorySize, dot_smem_bytes<P>());
  if (allowed != cudaSuccess) return allowed;
  const dim3 grid((N + kDotTile - 1) / kDotTile, (M + kDotTile - 1) / kDotTile);
  const bool a_vec = K % 4 == 0 && reinterpret_cast<uintptr_t>(a) % 16 == 0;
  const bool b_vec = N % 4 == 0 && reinterpret_cast<uintptr_t>(b) % 16 == 0;
  probe_dot_kernel<P><<<grid, kDotThreads, dot_smem_bytes<P>(), stream>>>(a, b, c, M, N, K,
                                                                         a_vec, b_vec);
  return cudaGetLastError();
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
  if (M < 1 || N < 1 || K < 1 || (M + kDotTile - 1) / kDotTile > 65535) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return static_cast<int>(err);
  const auto* A = static_cast<const float*>(a);
  const auto* B = static_cast<const float*>(b);
  auto* C = static_cast<float*>(c);
  const auto s = static_cast<cudaStream_t>(stream);
  switch (precision) {
    case kIeee: return static_cast<int>(launch_dot<kIeee>(A, B, C, M, N, K, s));
    case kTf32: return static_cast<int>(launch_dot<kTf32>(A, B, C, M, N, K, s));
    case kTf32x3: return static_cast<int>(launch_dot<kTf32x3>(A, B, C, M, N, K, s));
    case kBf16: return static_cast<int>(launch_dot<kBf16>(A, B, C, M, N, K, s));
    default: return static_cast<int>(cudaErrorInvalidValue);
  }
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
