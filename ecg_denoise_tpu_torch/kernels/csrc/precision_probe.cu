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
// dot is tiled through shared memory, its inputs rounded once as they are
// staged, with several independent accumulation chains a warp (see its
// section): its first version, which read and rounded its operands from
// global memory inside the chain, lost 1.6-1.8 times to cuBLAS. The fold
// and the tree (see their section) keep one pinned chain per output, so
// each is built to reach it after one memory latency: a logits row read
// once into registers, v copied by cp.async behind the softmax and rounded
// once in shared memory, and the chain fed from conflict-free shared
// memory. The divide is one block of 16-byte accesses (see its section).
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
// The divide is __fdiv_rn, IEEE division rounded to nearest.

#include <cuda_bf16.h>
#include <cuda_runtime.h>

#include <cstdint>
#include <type_traits>

namespace {

enum Precision { kIeee = 0, kTf32 = 1, kTf32x3 = 2, kBf16 = 3 };

constexpr int kMaxL = 1024;     // softmax row length the shared buffers hold
constexpr int kMaxD = 15;       // D + 1 rows of [v; ones] fit one mma tile

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

// Fragments of the mma.sync tiles (PTX ISA, mma.m16n8k8 .tf32 and
// mma.m16n8k16 .bf16), with g = lane / 4 and t = lane % 4:
//   tf32 A: a0 (g, t), a1 (g+8, t), a2 (g, t+4), a3 (g+8, t+4)
//        B: b0 (t, g), b1 (t+4, g)
//   bf16 A: a0 (g, 2t..2t+1), a1 (g+8, 2t..), a2 (g, 2t+8..), a3 (g+8, 2t+8..)
//        B: b0 (2t..2t+1, g), b1 (2t+8..2t+9, g), lower k in the low half
//   C: c0 (g, 2t), c1 (g, 2t+1), c2 (g+8, 2t), c3 (g+8, 2t+1)
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

// --- softmax rows, shared by the fold and the tree -----------------------
//
// Both kernels stage what the sums read in shared memory before they start
// and run each pinned chain from there:
// * A warp takes a logits row: each lane issues all its loads at once
//   (j = lane + 32 m, m < NPL, NPL a compile-time bucket of L) and keeps
//   them in registers for the max and the exp, so the row is read once.
// * v is copied by cp.async, issued before the softmax, so its latency
//   hides behind the row's; each thread rounds the elements it copied
//   itself once they land (no extra barrier).
// * Row strides are odd multiples of 4 words, so 16-byte rows, and the 8
//   rows read at one k (the ieee fold's en[n][k], the mma fragments
//   g * stride + t) fall in 8 different banks.

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

// One warp's exp(row - max(row)) of logits row i: e[m] for j = lane + 32 m,
// 0 for j >= L and for a row past L. 32 NPL >= L.
template <int NPL>
__device__ __forceinline__ void row_exp(const float* __restrict__ logits, int i, int L,
                                        float (&e)[NPL]) {
  const int lane = threadIdx.x & 31;
  if (i >= L) {  // warp-uniform
#pragma unroll
    for (int m = 0; m < NPL; ++m) e[m] = 0.f;
    return;
  }
  const float* row = logits + static_cast<size_t>(i) * L;
  const float neg_inf = __int_as_float(0xff800000);
#pragma unroll
  for (int m = 0; m < NPL; ++m) e[m] = lane + 32 * m < L ? row[lane + 32 * m] : neg_inf;
  float mx = neg_inf;
#pragma unroll
  for (int m = 0; m < NPL; ++m) mx = fmaxf(mx, e[m]);
  mx = warp_max(mx);
#pragma unroll
  for (int m = 0; m < NPL; ++m) e[m] = lane + 32 * m < L ? expf(e[m] - mx) : 0.f;
}

// acc = fmaf(a[k], b[k], acc) for k = 0 .. n - 1 in order, from shared
// memory: 16 elements of each operand a group, by 16-byte loads (a and b
// 16-byte aligned), the next group's loads in flight while this one's 16
// FMAs run (64 cycles against a load's 30 or so), so the chain waits on
// the FMAs alone.
__device__ __forceinline__ float fma_chain(const float* a, const float* b, int n) {
  const float4* a4 = reinterpret_cast<const float4*>(a);
  const float4* b4 = reinterpret_cast<const float4*>(b);
  const int groups = n / 16;
  float4 x[4], y[4];
  if (groups > 0) {
#pragma unroll
    for (int u = 0; u < 4; ++u) {
      x[u] = a4[u];
      y[u] = b4[u];
    }
  }
  float acc = 0.f;
  for (int q = 0; q < groups; ++q) {
    const int next = 4 * min(q + 1, groups - 1);  // the last group loads itself again
    float4 nx[4], ny[4];
#pragma unroll
    for (int u = 0; u < 4; ++u) {
      nx[u] = a4[next + u];
      ny[u] = b4[next + u];
    }
#pragma unroll
    for (int u = 0; u < 4; ++u) {
      acc = fmaf(x[u].x, y[u].x, acc);
      acc = fmaf(x[u].y, y[u].y, acc);
      acc = fmaf(x[u].z, y[u].z, acc);
      acc = fmaf(x[u].w, y[u].w, acc);
    }
#pragma unroll
    for (int u = 0; u < 4; ++u) {
      x[u] = nx[u];
      y[u] = ny[u];
    }
  }
  for (int k = 16 * groups; k < n; ++k) acc = fmaf(a[k], b[k], acc);
  return acc;
}

// The row buckets the kernels are built for: L <= 32 NPL.
template <class Launch>
cudaError_t by_bucket(int L, Launch launch) {
  if (L <= 64) return launch(std::integral_constant<int, 2>{});
  if (L <= 256) return launch(std::integral_constant<int, 8>{});
  return launch(std::integral_constant<int, 32>{});
}

// A row stride of words that is an odd multiple of 4 and holds n words.
__host__ __device__ constexpr int odd_quad_stride(int n) { return 8 * ((n + 7) / 8) + 4; }

// --- fold: o (D, L) = of[:D] / of[D], of = [v; ones] . en^T --------------
//
// A block owns 8 query rows (the mma's n), a warp a row's softmax. The k
// extent is padded to whole bf16 k-steps, kpad = L rounded up to 16, with
// zeros (rows past D of [v; ones] and columns past L), as the fragments
// of the first version read them. Shared memory, in words, stride
// sw = odd_quad_stride(kpad) (sb = odd_quad_stride(kpad / 2) for packed
// bf16 pairs):
//   vs  [16][sw]  raw [v; ones]: f32 (ieee), TF32 hi in place (tf32, tf32x3)
//   en  [8][sw]   exp rows: f32 (ieee), TF32 hi (tf32, tf32x3)
//   tf32x3: vlo [16][sw], enlo [8][sw]; bf16: vb [16][sb], enb [8][sb]
// * ieee: thread (r, n) for r <= D runs its fmaf chain over k in order
//   (fma_chain).
// * tf32, tf32x3, bf16: warp 0 walks the k-steps of its 16x8 tile in order
//   on the staged, rounded fragments, each step's loaded during the step
//   before; the chain waits only on mma.sync.

constexpr int kFoldRows = 8;

__host__ __device__ constexpr int fold_kpad(int L) { return (L + 15) & ~15; }

template <int P>
__host__ __device__ constexpr int fold_smem_words(int L) {
  const int sw = odd_quad_stride(fold_kpad(L)), sb = odd_quad_stride(fold_kpad(L) / 2);
  return P == kTf32x3 ? 48 * sw : P == kBf16 ? 16 * sw + 24 * sb : 24 * sw;
}

template <int P, int NPL>
__global__ void __launch_bounds__(32 * kFoldRows, 1)
probe_fold(const float* __restrict__ logits, const float* __restrict__ v,
           float* __restrict__ o, int L, int D) {
  extern __shared__ __align__(16) float fold_smem[];
  __shared__ float of[16][kFoldRows];
  const int kpad = fold_kpad(L), sw = odd_quad_stride(kpad), sb = odd_quad_stride(kpad / 2);
  float* vs = fold_smem;
  float* en = vs + 16 * sw;
  uint32_t* vlo = reinterpret_cast<uint32_t*>(en + kFoldRows * sw);  // tf32x3
  uint32_t* enlo = vlo + 16 * sw;
  uint32_t* vb = reinterpret_cast<uint32_t*>(en);  // bf16: en holds no f32 rows
  uint32_t* enb = vb + 16 * sb;
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int i0 = blockIdx.x * kFoldRows;

  // v's rows into vs, raw, a warp two rows, a lane pairs (k, k + 1); zeros
  // past L.
  for (int r = warp; r < D; r += kFoldRows) {
    for (int k = 2 * lane; k < kpad; k += 64) {
      const float* src = v + static_cast<size_t>(r) * L + k;
      cp_async_f32(&vs[r * sw + k], k < L ? src : v, k < L, false);
      cp_async_f32(&vs[r * sw + k + 1], k + 1 < L ? src + 1 : v, k + 1 < L, false);
    }
  }
  asm volatile("cp.async.commit_group;\n" ::);

  float e[NPL];
  row_exp<NPL>(logits, i0 + warp, L, e);
#pragma unroll
  for (int m = 0; m < NPL; ++m) {
    const int k = lane + 32 * m;
    if constexpr (P == kBf16) {
      const float next = __shfl_down_sync(0xffffffffu, e[m], 1);
      if (k < kpad && !(lane & 1)) enb[warp * sb + k / 2] = bf16x2(e[m], next);
    } else if (k < kpad) {
      if constexpr (P == kIeee) {
        en[warp * sw + k] = e[m];
      } else {
        const uint32_t h = tf32_rna(e[m]);
        reinterpret_cast<uint32_t*>(en)[warp * sw + k] = h;
        if constexpr (P == kTf32x3) enlo[warp * sw + k] = tf32_rna(e[m] - __uint_as_float(h));
      }
    }
  }

  // [v; ones] in the path's form: ieee takes the raw rows and the ones;
  // the others round the pairs this thread copied and write the ones row
  // and the zero rows.
  asm volatile("cp.async.wait_group 0;\n" ::);
  if constexpr (P == kIeee) {
    if (warp == 0) {
      for (int k = lane; k < L; k += 32) vs[D * sw + k] = 1.f;
    }
  } else {
    for (int r = warp; r < 16; r += kFoldRows) {
      for (int k = 2 * lane; k < kpad; k += 64) {
        float x0 = r == D && k < L ? 1.f : 0.f, x1 = r == D && k + 1 < L ? 1.f : 0.f;
        if (r < D) {
          x0 = vs[r * sw + k];
          x1 = vs[r * sw + k + 1];
        }
        if constexpr (P == kBf16) {
          vb[r * sb + k / 2] = bf16x2(x0, x1);
        } else {
          const uint32_t h0 = tf32_rna(x0), h1 = tf32_rna(x1);
          reinterpret_cast<uint32_t*>(vs)[r * sw + k] = h0;
          reinterpret_cast<uint32_t*>(vs)[r * sw + k + 1] = h1;
          if constexpr (P == kTf32x3) {
            vlo[r * sw + k] = tf32_rna(x0 - __uint_as_float(h0));
            vlo[r * sw + k + 1] = tf32_rna(x1 - __uint_as_float(h1));
          }
        }
      }
    }
  }
  __syncthreads();

  if constexpr (P == kIeee) {
    const int r = threadIdx.x / kFoldRows, n = threadIdx.x % kFoldRows;
    if (r <= D) of[r][n] = fma_chain(vs + r * sw, en + n * sw, L);
  } else if (warp == 0) {
    const int g = lane >> 2, t = lane & 3;
    float c[4] = {0.f, 0.f, 0.f, 0.f};
    // Each k-step's fragments are loaded during the step before (the last
    // step loads its own again).
    if constexpr (P == kBf16) {
      const uint32_t* a0 = vb + g * sb + t;
      const uint32_t* a1 = a0 + 8 * sb;
      const uint32_t* b0 = enb + g * sb + t;
      const int last = (L - 1) / 16 * 8;  // the last k-step's word
      uint32_t a[4] = {a0[0], a1[0], a0[4], a1[4]}, b[2] = {b0[0], b0[4]};
      for (int k0 = 0; k0 < L; k0 += 16) {
        const int j = min(k0 / 2 + 8, last);
        const uint32_t na[4] = {a0[j], a1[j], a0[j + 4], a1[j + 4]};
        const uint32_t nb[2] = {b0[j], b0[j + 4]};
        mma_bf16(c, a, b);
#pragma unroll
        for (int u = 0; u < 4; ++u) a[u] = na[u];
        b[0] = nb[0];
        b[1] = nb[1];
      }
    } else {
      constexpr int kParts = P == kTf32x3 ? 2 : 1;  // hi, and lo for tf32x3
      const uint32_t* a0[2] = {reinterpret_cast<const uint32_t*>(vs) + g * sw + t,
                               vlo + g * sw + t};
      const uint32_t* b0[2] = {reinterpret_cast<const uint32_t*>(en) + g * sw + t,
                               enlo + g * sw + t};
      uint32_t a[2][4], b[2][2];
#pragma unroll
      for (int h = 0; h < kParts; ++h) {
        a[h][0] = a0[h][0];
        a[h][1] = a0[h][8 * sw];
        a[h][2] = a0[h][4];
        a[h][3] = a0[h][8 * sw + 4];
        b[h][0] = b0[h][0];
        b[h][1] = b0[h][4];
      }
      const int last = (L - 1) / 8 * 8;  // the last k-step
      for (int k0 = 0; k0 < L; k0 += 8) {
        const int k = min(k0 + 8, last);
        uint32_t na[2][4], nb[2][2];
#pragma unroll
        for (int h = 0; h < kParts; ++h) {
          na[h][0] = a0[h][k];
          na[h][1] = a0[h][8 * sw + k];
          na[h][2] = a0[h][k + 4];
          na[h][3] = a0[h][8 * sw + k + 4];
          nb[h][0] = b0[h][k];
          nb[h][1] = b0[h][k + 4];
        }
        if constexpr (P == kTf32x3) {  // the small products go in first
          mma_tf32(c, a[1], b[0]);
          mma_tf32(c, a[0], b[1]);
        }
        mma_tf32(c, a[0], b[0]);
#pragma unroll
        for (int h = 0; h < kParts; ++h) {
#pragma unroll
          for (int u = 0; u < 4; ++u) a[h][u] = na[h][u];
          b[h][0] = nb[h][0];
          b[h][1] = nb[h][1];
        }
      }
    }
    of[g][2 * t] = c[0];
    of[g][2 * t + 1] = c[1];
    of[g + 8][2 * t] = c[2];
    of[g + 8][2 * t + 1] = c[3];
  }
  __syncthreads();
  const int r = threadIdx.x / kFoldRows, n = threadIdx.x % kFoldRows;
  if (r < D && i0 + n < L) o[static_cast<size_t>(r) * L + i0 + n] = of[r][n] / of[D][n];
}

// --- tree: p = e / tree_sum(e), o (D, L) = v . p^T on the CUDA cores -----
//
// A warp owns a query row: each lane sums its own exps in order (j = lane,
// lane + 32, ...), the butterfly sums the lanes, p = e / sum goes to shared
// memory, and lanes d < D run their fmaf chain over j in order (fma_chain)
// on v, staged by cp.async before the softmax, and p. Four rows a block:
// on an H100 eight were 0.8 us slower a call, two level (PERF.md, PR 10).
// Shared memory, in words, stride sw = odd_quad_stride(L): vs [D][sw],
// then p [kTreeRows][sw].

constexpr int kTreeRows = 4;

template <int NPL>
__global__ void __launch_bounds__(32 * kTreeRows)
probe_tree(const float* __restrict__ logits, const float* __restrict__ v,
           float* __restrict__ o, int L, int D) {
  extern __shared__ __align__(16) float tree_smem[];
  const int sw = odd_quad_stride(L);
  float* vs = tree_smem;
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  float* p = tree_smem + (D + warp) * sw;
  const int i = blockIdx.x * kTreeRows + warp;
  for (int r = warp; r < D; r += kTreeRows) {
    for (int k = lane; k < L; k += 32) {
      cp_async_f32(&vs[r * sw + k], v + static_cast<size_t>(r) * L + k, true, false);
    }
  }
  asm volatile("cp.async.commit_group;\n" ::);
  float e[NPL];
  row_exp<NPL>(logits, i, L, e);
  if (i < L) {  // warp-uniform
    float part = 0.f;
#pragma unroll
    for (int m = 0; m < NPL; ++m) {
      if (lane + 32 * m < L) part += e[m];
    }
    const float sum = warp_sum(part);
#pragma unroll
    for (int m = 0; m < NPL; ++m) {
      if (lane + 32 * m < L) p[lane + 32 * m] = e[m] / sum;
    }
  }
  asm volatile("cp.async.wait_group 0;\n" ::);
  __syncthreads();
  if (i < L && lane < D) o[static_cast<size_t>(lane) * L + i] = fma_chain(vs + lane * sw, p, L);
}

// --- divide ----------------------------------------------------------------
//
// The probe's (8, 256) divide is 2,048 values, 24 KB moved: its time is the
// launch. Each __fdiv_rn is IEEE division rounded to nearest whatever the
// compiler's flags, as torch.div on the card and numpy on the host. Where
// all three operands are 16-byte aligned, probe_div_vector takes
// kDivVectorThreads threads a block, each loading one 16-byte vector of n
// and of d and storing one of o: the probe's 2,048 values are one block,
// a quarter of the scalar design's memory instructions. Its cost: each
// __fdiv_rn compiles to a reciprocal, a range check and a branch to a slow
// path, so a thread's four divides run one after another. Otherwise
// probe_div, one value a thread, kDivThreads a block.

constexpr int kDivThreads = 256;
constexpr int kDivVectorThreads = 512;

__global__ void __launch_bounds__(kDivThreads)
probe_div(const float* __restrict__ n, const float* __restrict__ d, float* __restrict__ o,
          int count) {
  const int i = blockIdx.x * kDivThreads + threadIdx.x;
  if (i < count) o[i] = __fdiv_rn(n[i], d[i]);
}

__global__ void __launch_bounds__(kDivVectorThreads)
probe_div_vector(const float* __restrict__ n, const float* __restrict__ d,
                 float* __restrict__ o, int count) {
  const int count4 = count / 4;
  const int j = blockIdx.x * kDivVectorThreads + threadIdx.x;
  if (j < count4) {
    const float4 a = reinterpret_cast<const float4*>(n)[j];
    const float4 b = reinterpret_cast<const float4*>(d)[j];
    reinterpret_cast<float4*>(o)[j] = make_float4(__fdiv_rn(a.x, b.x), __fdiv_rn(a.y, b.y),
                                                  __fdiv_rn(a.z, b.z), __fdiv_rn(a.w, b.w));
  }
  const int k = 4 * count4 + threadIdx.x;  // the last 0-3 values
  if (blockIdx.x == 0 && k < count) o[k] = __fdiv_rn(n[k], d[k]);
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

// Above 48 KB a block's dynamic shared memory must be allowed, once per
// kernel, for the largest L of its bucket.
template <int P>
cudaError_t launch_fold(const float* logits, const float* v, float* o, int L, int D,
                        cudaStream_t stream) {
  return by_bucket(L, [&](auto bucket) {
    constexpr int NPL = decltype(bucket)::value;
    static const cudaError_t allowed =
        cudaFuncSetAttribute(probe_fold<P, NPL>, cudaFuncAttributeMaxDynamicSharedMemorySize,
                             4 * fold_smem_words<P>(32 * NPL));
    if (allowed != cudaSuccess) return allowed;
    probe_fold<P, NPL><<<(L + kFoldRows - 1) / kFoldRows, 32 * kFoldRows,
                         4 * fold_smem_words<P>(L), stream>>>(logits, v, o, L, D);
    return cudaGetLastError();
  });
}

cudaError_t launch_tree(const float* logits, const float* v, float* o, int L, int D,
                        cudaStream_t stream) {
  return by_bucket(L, [&](auto bucket) {
    constexpr int NPL = decltype(bucket)::value;
    static const cudaError_t allowed =
        cudaFuncSetAttribute(probe_tree<NPL>, cudaFuncAttributeMaxDynamicSharedMemorySize,
                             4 * (kMaxD + kTreeRows) * odd_quad_stride(32 * NPL));
    if (allowed != cudaSuccess) return allowed;
    probe_tree<NPL><<<(L + kTreeRows - 1) / kTreeRows, 32 * kTreeRows,
                      4 * (D + kTreeRows) * odd_quad_stride(L), stream>>>(logits, v, o, L, D);
    return cudaGetLastError();
  });
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
    case kIeee: return static_cast<int>(launch_fold<kIeee>(lg, vv, out, L, D, s));
    case kTf32: return static_cast<int>(launch_fold<kTf32>(lg, vv, out, L, D, s));
    case kTf32x3: return static_cast<int>(launch_fold<kTf32x3>(lg, vv, out, L, D, s));
    case kBf16: return static_cast<int>(launch_fold<kBf16>(lg, vv, out, L, D, s));
    default: return static_cast<int>(cudaErrorInvalidValue);
  }
}

// o (D, L) = (e / tree_sum(e)) . v^T, e = exp(logits - row max), in f32 on
// the CUDA cores; 1 <= L <= 1024, 1 <= D <= 15.
extern "C" int ecg_probe_tree(const void* logits, const void* v, void* o, int L, int D,
                              int device, void* stream) {
  if (L < 1 || L > kMaxL || D < 1 || D > kMaxD) return static_cast<int>(cudaErrorInvalidValue);
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return static_cast<int>(err);
  return static_cast<int>(launch_tree(static_cast<const float*>(logits),
                                      static_cast<const float*>(v), static_cast<float*>(o), L,
                                      D, static_cast<cudaStream_t>(stream)));
}

// o = n / d elementwise over `count` >= 1 values.
extern "C" int ecg_probe_div(const void* n, const void* d, void* o, int count, int device,
                             void* stream) {
  if (count < 1) return static_cast<int>(cudaErrorInvalidValue);
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return static_cast<int>(err);
  const auto* nn = static_cast<const float*>(n);
  const auto* dd = static_cast<const float*>(d);
  auto* oo = static_cast<float*>(o);
  const auto s = static_cast<cudaStream_t>(stream);
  if ((reinterpret_cast<uintptr_t>(n) | reinterpret_cast<uintptr_t>(d) |
       reinterpret_cast<uintptr_t>(o)) % 16 == 0) {
    const int values = 4 * kDivVectorThreads;
    probe_div_vector<<<(count + values - 1) / values, kDivVectorThreads, 0, s>>>(nn, dd, oo,
                                                                                 count);
  } else {
    probe_div<<<(count + kDivThreads - 1) / kDivThreads, kDivThreads, 0, s>>>(nn, dd, oo, count);
  }
  return static_cast<int>(cudaGetLastError());
}

extern "C" const char* ecg_cuda_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}
