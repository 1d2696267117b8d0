// The tensor-core kernels of the fused attention forward: B1's template on
// D for head_dim 8, 16, 32 and 64 (attention_fwd.cu), and the wide kernel
// for every multiple of 64 past 64, for B1 (attention_fwd.cu, no window)
// and B3 (attention_rpos_fwd.cu, kWin). Each source instantiates only its
// own mode, so B1's kernels compile in attention_fwd.cu and B3's in
// attention_rpos_fwd.cu, in parallel, and B1's are the same code with or
// without B3's beside them. B3 at D <= 64 has its own kernel
// (attention_rpos_fwd_mma.cuh), which uses this file's fragment helpers.
//
// The wide kernel's window mode (kWin, B3: R-peak attention, replacing the
// TPU kernel ecg_denoise_tpu/kernels/attention_pallas.py _fwd_rpos_kernel
// (:827) past D = 64). The bias is toep (1, H, L, L), shared by the batch
// as B1's bias is, times in_b[l] * in_b[m] for the head's batch element b
// (attention_window.cuh). A row outside its window, or a key outside the
// row's window, adds no bias: the toep entry is not read and the logit is
// left as it is, where JAX adds exactly 0.0 (the same logit). Everything
// else is B1's arithmetic: the window costs two compares per (row, key),
// and it skips the bias loads that B1 makes outside it.

#pragma once

#include <cuda_bf16.h>
#include <cuda_runtime.h>

#include <cstdint>

#include "attention_window.cuh"

namespace {
namespace mma_fwd {

__device__ __forceinline__ float to_float(float x) { return x; }
__device__ __forceinline__ float to_float(__nv_bfloat16 x) { return __bfloat162float(x); }

// ---------------------------------------------------------------------------
// head_dim 8, 16, 32 and 64: one template on D, on Hopper's tensor cores.
// Transformer1d's heads are 32 wide; the wrapper (kernels/attention.py)
// zero-pads any other D <= 64 to the next instantiated one, and a D = 4
// call past 256 keys to 8. The D = 4 kernel of attention_fwd.cu is left as
// it is, bit for bit.
//
// What bounds it. Per (b, h) the work is 4*L*L*D flops (q.k and p.v)
// against 4*L*D operand elements. On the CUDA cores in f32 (the first
// design) that is 67 TFLOP/s; on the tensor cores it is 495 TFLOP/s
// in TF32 and 989 in bf16. f32 operands need the float32 bar (1e-5 of the
// output), which one TF32 pass misses (3.6e-4 of max|exact| for a 256-deep
// dot, the precision probe) and three passes meet (2.6e-6): x = hi + lo, each
// rounded to TF32 by cvt.rna, and a.b = a_lo.b_hi + a_hi.b_lo + a_hi.b_hi,
// the small terms first, each k-step's (q.k^T) or key tile's (p.v)
// products summed apart and added to the f32 sums on the CUDA cores
// (`mma_3xtf32`). At (L, H, B) = (256, 4, 256) that is 3 x 8.6
// GFLOP, 0.052 ms at 495 TFLOP/s, under its bytes (q, k, v, o, 134 MB,
// 0.040 ms): a short call is near the line, a long one (L = 1000) is bound
// by the operations. bf16 operands go to mma.m16n8k16 bf16 with f32 sums:
// q.k of bf16 values is exact in f32, and p is rounded to bf16 before p.v,
// where attention_reference and the TPU kernel round it.
//
// Design (mma.sync, which the readings show as the limit: the time follows
// the count of TF32 mma, PERF.md; wgmma's 64-row warpgroup tiles fed by a
// producer warp are the next design):
// * A block is 4 warps, a warp 16 query rows of one (b, h). Where a head
//   has more rows than 32, the block's 64 rows are one head's and the grid
//   walks its row tiles; at L <= 32 (L <= 16) a block packs 2 (4) heads,
//   2 (1) warps each, so no warp idles on a head of few rows.
// * q's fragments are loaded once into registers (f32: already split into
//   TF32 hi and lo; bf16: as pairs).
// * K and V stream through shared memory in tiles of 64 keys (16 or 32
//   a head where the block packs heads), in a ring of two stages filled by
//   cp.async (16-byte copies; rows past L are zero-filled), the next tile in
//   flight while this one is used. Rows are padded to D + 4 floats (f32) or
//   D + 8 bf16 values: the f32 fragment loads, K at (key g, dim t) and V at
//   (key 2t, dim g), fall in 32 banks, and so do ldmatrix's 8 rows.
// * S = q.k^T by mma into C fragments; the bias (no model of the repo
//   passes one at these head dims: Transformer1d's calls have none) is
//   added from global memory, where the batch finds it in L2; keys past L
//   are masked to -inf.
// * The online softmax runs in f32 on the C fragments: each row's tile max
//   reduced across its quad by two shuffles, the running max kept (logits
//   reach 191.5 in RA-LENet; every exp is of a value <= 0), sum and output
//   rescaled by exp(old - new). The quad's partial row sums are added once
//   at the end.
// * P goes from the C fragment of q.k^T to the A fragment of p.v without
//   shuffles or shared memory: f32, by a permutation of each 8-key k-step
//   (A column t takes key 2t, column t + 4 key 2t + 1, which is what a lane
//   holds; V's rows are read in the same order); bf16, the C pairs of two
//   n-tiles are the A pairs of one 16-key k-step, and V's B fragments come
//   by ldmatrix.trans.
// * The output is divided by the row sum once and rounded once to the
//   operand dtype; the lse, max + log(sum), is written for the backward. No
//   atomics: a call gives bit-identical results every time.

constexpr int kMmaWarps = 4;
constexpr int kMmaThreads = 32 * kMmaWarps;
constexpr int kKeyTile = 64;  // K and V rows of one stage, all heads of the block

// The tiling of one call at length L, the same on host and device.
struct MmaTiling {
  int warps;  // warps a head: 1 (L <= 16), 2 (L <= 32), else 4
  int heads;  // (b, h) heads of a block: 4 / warps
  int rows;   // query rows, and keys of a stage, a head: 16 * warps
  int tiles;  // row tiles, and key tiles, of a head (1 where the block packs heads)
  __host__ __device__ explicit MmaTiling(int L) {
    warps = L <= 16 ? 1 : L <= 32 ? 2 : kMmaWarps;
    heads = kMmaWarps / warps;
    rows = 16 * warps;
    tiles = (L + rows - 1) / rows;
  }
};

// A staged row's stride in elements: D + 4 floats, D + 8 bf16 values.
template <typename T, int D>
__host__ __device__ constexpr int mma_stride() { return sizeof(T) == 4 ? D + 4 : D + 8; }

template <typename T, int D>
__host__ __device__ constexpr int mma_smem_bytes() {
  return 2 * 2 * kKeyTile * mma_stride<T, D>() * static_cast<int>(sizeof(T));
}

__device__ __forceinline__ uint32_t tf32_rna(float x) {
  uint32_t r;
  asm("cvt.rna.tf32.f32 %0, %1;" : "=r"(r) : "f"(x));
  return r & 0xffffe000u;  // the TF32 value, its 13 dropped bits cleared
}

// x = hi + lo, each rounded to TF32.
__device__ __forceinline__ void split_tf32(float x, uint32_t& hi, uint32_t& lo) {
  hi = tf32_rna(x);
  lo = tf32_rna(x - __uint_as_float(hi));
}

// Fragments of the mma.sync tiles (PTX ISA), g = lane / 4, t = lane % 4:
//   tf32 m16n8k8  A: a0 (g, t), a1 (g+8, t), a2 (g, t+4), a3 (g+8, t+4)
//                 B: b0 (t, g), b1 (t+4, g)
//   bf16 m16n8k16 A: a0 (g, 2t..2t+1), a1 (g+8, ..), a2 (g, 2t+8..), a3 (g+8, 2t+8..)
//                 B: b0 (2t..2t+1, g), b1 (2t+8..2t+9, g), lower k in the low half
//   C: c0 (g, 2t), c1 (g, 2t+1), c2 (g+8, 2t), c3 (g+8, 2t+1)
__device__ __forceinline__ void mma_tf32(float (&c)[4], const uint32_t (&a)[4], uint32_t b0,
                                         uint32_t b1) {
  asm volatile(
      "mma.sync.aligned.m16n8k8.row.col.f32.tf32.tf32.f32 "
      "{%0, %1, %2, %3}, {%4, %5, %6, %7}, {%8, %9}, {%0, %1, %2, %3};\n"
      : "+f"(c[0]), "+f"(c[1]), "+f"(c[2]), "+f"(c[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}

__device__ __forceinline__ void mma_bf16(float (&c)[4], const uint32_t (&a)[4], uint32_t b0,
                                         uint32_t b1) {
  asm volatile(
      "mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 "
      "{%0, %1, %2, %3}, {%4, %5, %6, %7}, {%8, %9}, {%0, %1, %2, %3};\n"
      : "+f"(c[0]), "+f"(c[1]), "+f"(c[2]), "+f"(c[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}

// c += a.b over one 8-deep k-step at 3xTF32, the small terms first. The
// tensor core's f32 sum does not round to nearest: fed one running sum
// over the 125 k-steps of 1,000 keys its errors add up (2e-5 of the
// output, against the 1e-5 bar; PERF.md). So the callers give it a
// fresh fragment, a k-step's (q.k^T) or a key tile's (p.v), and add that
// to their sums on the CUDA cores.
__device__ __forceinline__ void mma_3xtf32(float (&c)[4], const uint32_t (&ah)[4],
                                           const uint32_t (&al)[4], float b0, float b1) {
  uint32_t h0, l0, h1, l1;
  split_tf32(b0, h0, l0);
  split_tf32(b1, h1, l1);
  mma_tf32(c, al, h0, h1);
  mma_tf32(c, ah, l0, l1);
  mma_tf32(c, ah, h0, h1);
}

// Two f32 values rounded RNE to bf16, the first in the low half.
__device__ __forceinline__ uint32_t bf16x2(float lo, float hi) {
  return static_cast<uint32_t>(__bfloat16_as_ushort(__float2bfloat16_rn(lo))) |
         static_cast<uint32_t>(__bfloat16_as_ushort(__float2bfloat16_rn(hi))) << 16;
}

__device__ __forceinline__ void ldmatrix_x4(uint32_t (&r)[4], const void* row) {
  const unsigned s = static_cast<unsigned>(__cvta_generic_to_shared(row));
  asm volatile("ldmatrix.sync.aligned.m8n8.x4.shared.b16 {%0, %1, %2, %3}, [%4];\n"
               : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
               : "r"(s));
}

__device__ __forceinline__ void ldmatrix_x4_trans(uint32_t (&r)[4], const void* row) {
  const unsigned s = static_cast<unsigned>(__cvta_generic_to_shared(row));
  asm volatile("ldmatrix.sync.aligned.m8n8.x4.trans.shared.b16 {%0, %1, %2, %3}, [%4];\n"
               : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
               : "r"(s));
}

// 16 bytes by cp.async, zero-filled where `in` is false.
__device__ __forceinline__ void cp_async16(void* dst, const void* src, bool in) {
  const unsigned s = static_cast<unsigned>(__cvta_generic_to_shared(dst));
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::"r"(s), "l"(src),
               "r"(in ? 16 : 0));
}


__device__ __forceinline__ void store2(float* p, float a, float b) {
  *reinterpret_cast<float2*>(p) = make_float2(a, b);
}

__device__ __forceinline__ void store2(__nv_bfloat16* p, float a, float b) {
  *reinterpret_cast<__nv_bfloat162*>(p) = __floats2bfloat162_rn(a, b);
}

// Stage key tile `kt` of every head of the block: K and V rows into the
// ring's buffer `buf`, a head's rows at slot * rows. Rows past L, and heads
// past B * H, are zero-filled.
template <typename T, int D>
__device__ __forceinline__ void stage_kv(T* buf, const T* __restrict__ k,
                                         const T* __restrict__ v, const MmaTiling& t,
                                         long long head0, long long n_heads, int L, int kt) {
  constexpr int kPer = 16 / sizeof(T);  // values a copy
  constexpr int kChunks = D / kPer;     // copies a row
  constexpr int kS = mma_stride<T, D>();
  T* vbuf = buf + kKeyTile * kS;
  for (int i = threadIdx.x; i < kKeyTile * kChunks; i += kMmaThreads) {
    const int row = i / kChunks, c = i - row * kChunks;
    const int slot = row / t.rows, key = kt * t.rows + row - slot * t.rows;
    const long long bh = head0 + slot;
    const bool in = slot < t.heads && bh < n_heads && key < L;
    const size_t at = in ? (static_cast<size_t>(bh) * L + key) * D + c * kPer : 0;
    cp_async16(buf + row * kS + c * kPer, k + at, in);
    cp_async16(vbuf + row * kS + c * kPer, v + at, in);
  }
  asm volatile("cp.async.commit_group;\n" ::);
}

template <typename T, int D, bool kBias>
__global__ void __launch_bounds__(kMmaThreads)
attention_fwd_mma_kernel(const T* __restrict__ q, const T* __restrict__ k,
                         const T* __restrict__ v, const T* __restrict__ bias,
                         T* __restrict__ o, float* __restrict__ lse, int B, int H, int L) {
  constexpr bool kF32 = sizeof(T) == 4;
  constexpr int kS = mma_stride<T, D>();
  constexpr int kNT = kKeyTile / 8;  // n-tiles of S at the widest stage
  extern __shared__ __align__(16) unsigned char smem[];
  T* ring = reinterpret_cast<T*>(smem);  // [stage][K, V][kKeyTile][kS]
  const MmaTiling t(L);
  const long long n_heads = static_cast<long long>(B) * H;
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int g = lane >> 2, tq = lane & 3;
  const long long head0 = static_cast<long long>(blockIdx.x / t.tiles) * t.heads;
  const int slot = warp / t.warps;
  const long long bh = head0 + slot;
  const bool head_ok = bh < n_heads;
  const int h = static_cast<int>(bh % H);
  const int row0 = (blockIdx.x % t.tiles) * t.rows + (warp - slot * t.warps) * 16;
  const int r0 = row0 + g, r1 = r0 + 8;  // this lane's two rows
  const bool ok0 = head_ok && r0 < L, ok1 = head_ok && r1 < L;
  const size_t base = static_cast<size_t>(head_ok ? bh : 0) * L;  // the head's first row
  const int nj = t.rows / 8;  // n-tiles of S a stage

  // q's A fragments: f32 split hi / lo for 3xTF32 (k-steps of 8 dims),
  // bf16 as pairs (k-steps of 16).
  constexpr int kKS = kF32 ? D / 8 : D / 16;
  uint32_t qa[kKS][4], ql[kF32 ? kKS : 1][4];
#pragma unroll
  for (int kk = 0; kk < kKS; ++kk) {
    if constexpr (kF32) {
      const float* p0 = reinterpret_cast<const float*>(q) + (base + r0) * D + 8 * kk + tq;
      const float* p1 = p0 + 8 * D;
      const float x[4] = {ok0 ? p0[0] : 0.f, ok1 ? p1[0] : 0.f, ok0 ? p0[4] : 0.f,
                          ok1 ? p1[4] : 0.f};
#pragma unroll
      for (int i = 0; i < 4; ++i) split_tf32(x[i], qa[kk][i], ql[kk][i]);
    } else {
      const uint32_t* p0 = reinterpret_cast<const uint32_t*>(q + (base + r0) * D + 16 * kk) + tq;
      const uint32_t* p1 = p0 + 4 * D;  // 8 rows of D bf16 = 4 D words
      qa[kk][0] = ok0 ? p0[0] : 0u;
      qa[kk][1] = ok1 ? p1[0] : 0u;
      qa[kk][2] = ok0 ? p0[4] : 0u;
      qa[kk][3] = ok1 ? p1[4] : 0u;
    }
  }

  float acc[D / 8][4];
#pragma unroll
  for (int n = 0; n < D / 8; ++n) acc[n][0] = acc[n][1] = acc[n][2] = acc[n][3] = 0.f;
  float mx0 = __int_as_float(0xff800000), mx1 = mx0;  // running row maxima, -inf
  float sum0 = 0.f, sum1 = 0.f;                       // this lane's partial row sums
  const T* brow0 = kBias ? bias + (static_cast<size_t>(h) * L + (ok0 ? r0 : 0)) * L : nullptr;
  const T* brow1 = kBias ? bias + (static_cast<size_t>(h) * L + (ok1 ? r1 : 0)) * L : nullptr;

  stage_kv<T, D>(ring, k, v, t, head0, n_heads, L, 0);
  for (int kt = 0; kt < t.tiles; ++kt) {
    asm volatile("cp.async.wait_group 0;\n" ::);
    // Tile kt is in for every thread, and every thread is done with the
    // buffer tile kt + 1 overwrites (used for tile kt - 1).
    __syncthreads();
    if (kt + 1 < t.tiles) {
      stage_kv<T, D>(ring + ((kt + 1) & 1) * 2 * kKeyTile * kS, k, v, t, head0, n_heads, L,
                     kt + 1);
    }
    const T* ks = ring + (kt & 1) * 2 * kKeyTile * kS + slot * t.rows * kS;
    const T* vs = ks + kKeyTile * kS;
    const int key0 = kt * t.rows;

    // S = q.k^T, a 16 x rows strip; bias; keys past L to -inf.
    float s[kNT][4];
#pragma unroll
    for (int j = 0; j < kNT; ++j) {
      if (j >= nj) break;
      s[j][0] = s[j][1] = s[j][2] = s[j][3] = 0.f;
#pragma unroll
      for (int kk = 0; kk < kKS; ++kk) {
        if constexpr (kF32) {
          const float* kr = reinterpret_cast<const float*>(ks) + (8 * j + g) * kS + 8 * kk + tq;
          float t[4] = {0.f, 0.f, 0.f, 0.f};  // this k-step's products, summed apart
          mma_3xtf32(t, qa[kk], ql[kk], kr[0], kr[4]);
#pragma unroll
          for (int i = 0; i < 4; ++i) s[j][i] += t[i];
        } else {
          const uint32_t* kr =
              reinterpret_cast<const uint32_t*>(ks + (8 * j + g) * kS + 16 * kk) + tq;
          mma_bf16(s[j], qa[kk], kr[0], kr[4]);
        }
      }
      const int m = key0 + 8 * j + 2 * tq;  // the key of c0 and c2; m + 1 of c1 and c3
      if constexpr (kBias) {
        if (m < L) {
          s[j][0] += ok0 ? to_float(brow0[m]) : 0.f;
          s[j][2] += ok1 ? to_float(brow1[m]) : 0.f;
        }
        if (m + 1 < L) {
          s[j][1] += ok0 ? to_float(brow0[m + 1]) : 0.f;
          s[j][3] += ok1 ? to_float(brow1[m + 1]) : 0.f;
        }
      }
      if (m >= L) s[j][0] = s[j][2] = __int_as_float(0xff800000);
      if (m + 1 >= L) s[j][1] = s[j][3] = __int_as_float(0xff800000);
    }

    // The online softmax of rows r0 and r1: the tile max across the quad.
    float t0 = __int_as_float(0xff800000), t1 = t0;
#pragma unroll
    for (int j = 0; j < kNT; ++j) {
      if (j >= nj) break;
      t0 = fmaxf(t0, fmaxf(s[j][0], s[j][1]));
      t1 = fmaxf(t1, fmaxf(s[j][2], s[j][3]));
    }
#pragma unroll
    for (int x = 1; x <= 2; x <<= 1) {
      t0 = fmaxf(t0, __shfl_xor_sync(0xffffffffu, t0, x));
      t1 = fmaxf(t1, __shfl_xor_sync(0xffffffffu, t1, x));
    }
    const float new0 = fmaxf(mx0, t0), new1 = fmaxf(mx1, t1);
    const float sc0 = __expf(mx0 - new0), sc1 = __expf(mx1 - new1);  // 0 at the first tile
    mx0 = new0;
    mx1 = new1;
    sum0 *= sc0;
    sum1 *= sc1;
#pragma unroll
    for (int j = 0; j < kNT; ++j) {
      if (j >= nj) break;
      s[j][0] = __expf(s[j][0] - mx0);
      s[j][1] = __expf(s[j][1] - mx0);
      s[j][2] = __expf(s[j][2] - mx1);
      s[j][3] = __expf(s[j][3] - mx1);
      sum0 += s[j][0] + s[j][1];
      sum1 += s[j][2] + s[j][3];
    }

    // O = O * exp(old max - new max) + P.V.
    if constexpr (kF32) {
      // The tile's P.V in a fresh fragment, added by the rescale's FMA.
      // k-step j: A column tq is key 8j + 2tq (c0, c2), column tq + 4 key
      // 8j + 2tq + 1 (c1, c3); V's rows in the same order.
      float pv[D / 8][4];
#pragma unroll
      for (int n = 0; n < D / 8; ++n) pv[n][0] = pv[n][1] = pv[n][2] = pv[n][3] = 0.f;
#pragma unroll
      for (int j = 0; j < kNT; ++j) {
        if (j >= nj) break;
        uint32_t ph[4], pl[4];
        split_tf32(s[j][0], ph[0], pl[0]);
        split_tf32(s[j][2], ph[1], pl[1]);
        split_tf32(s[j][1], ph[2], pl[2]);
        split_tf32(s[j][3], ph[3], pl[3]);
        const float* vr = reinterpret_cast<const float*>(vs) + (8 * j + 2 * tq) * kS + g;
#pragma unroll
        for (int n = 0; n < D / 8; ++n) mma_3xtf32(pv[n], ph, pl, vr[8 * n], vr[kS + 8 * n]);
      }
#pragma unroll
      for (int n = 0; n < D / 8; ++n) {
        acc[n][0] = fmaf(acc[n][0], sc0, pv[n][0]);
        acc[n][1] = fmaf(acc[n][1], sc0, pv[n][1]);
        acc[n][2] = fmaf(acc[n][2], sc1, pv[n][2]);
        acc[n][3] = fmaf(acc[n][3], sc1, pv[n][3]);
      }
    } else {
#pragma unroll
      for (int n = 0; n < D / 8; ++n) {
        acc[n][0] *= sc0;
        acc[n][1] *= sc0;
        acc[n][2] *= sc1;
        acc[n][3] *= sc1;
      }
      // k-step jj: keys 16jj .. 16jj + 15, the C pairs of n-tiles 2jj and
      // 2jj + 1 rounded to bf16; V's B fragments by ldmatrix.trans, two
      // 8-dim n-tiles a call.
#pragma unroll
      for (int jj = 0; jj < kNT / 2; ++jj) {
        if (2 * jj >= nj) break;
        const uint32_t pa[4] = {bf16x2(s[2 * jj][0], s[2 * jj][1]),
                                bf16x2(s[2 * jj][2], s[2 * jj][3]),
                                bf16x2(s[2 * jj + 1][0], s[2 * jj + 1][1]),
                                bf16x2(s[2 * jj + 1][2], s[2 * jj + 1][3])};
        const T* vrow = vs + (16 * jj + (lane & 15)) * kS + (lane >> 4) * 8;
#pragma unroll
        for (int n = 0; n < D / 16; ++n) {
          uint32_t b[4];
          ldmatrix_x4_trans(b, vrow + 16 * n);
          mma_bf16(acc[2 * n], pa, b[0], b[1]);
          mma_bf16(acc[2 * n + 1], pa, b[2], b[3]);
        }
      }
    }
  }

#pragma unroll
  for (int x = 1; x <= 2; x <<= 1) {
    sum0 += __shfl_xor_sync(0xffffffffu, sum0, x);
    sum1 += __shfl_xor_sync(0xffffffffu, sum1, x);
  }
#pragma unroll
  for (int n = 0; n < D / 8; ++n) {
    if (ok0) store2(o + (base + r0) * D + 8 * n + 2 * tq, acc[n][0] / sum0, acc[n][1] / sum0);
    if (ok1) store2(o + (base + r1) * D + 8 * n + 2 * tq, acc[n][2] / sum1, acc[n][3] / sum1);
  }
  if (lse != nullptr && tq == 0) {
    if (ok0) lse[base + r0] = mx0 + logf(sum0);
    if (ok1) lse[base + r1] = mx1 + logf(sum1);
  }
}

template <typename T, int D, bool kBias>
cudaError_t launch_mma_one(const T* q, const T* k, const T* v, const T* bias, T* o,
                           float* lse, int B, int H, int L, cudaStream_t stream) {
  // Above 48 KB a block's dynamic shared memory must be allowed once per
  // instantiation.
  static const cudaError_t allowed = cudaFuncSetAttribute(
      attention_fwd_mma_kernel<T, D, kBias>, cudaFuncAttributeMaxDynamicSharedMemorySize,
      mma_smem_bytes<T, D>());
  if (allowed != cudaSuccess) return allowed;
  const MmaTiling t(L);
  const long long groups = (static_cast<long long>(B) * H + t.heads - 1) / t.heads;
  const long long blocks = groups * t.tiles;
  if (blocks > 0x7fffffffLL) return cudaErrorInvalidValue;
  attention_fwd_mma_kernel<T, D, kBias>
      <<<static_cast<int>(blocks), kMmaThreads, mma_smem_bytes<T, D>(), stream>>>(
          q, k, v, bias, o, lse, B, H, L);
  return cudaGetLastError();
}

template <typename T, int D>
cudaError_t launch_mma_d(const void* q, const void* k, const void* v, const void* bias,
                         void* o, float* lse, int B, int H, int L, cudaStream_t stream) {
  const T* qt = static_cast<const T*>(q);
  const T* kt = static_cast<const T*>(k);
  const T* vt = static_cast<const T*>(v);
  const T* bt = static_cast<const T*>(bias);
  T* ot = static_cast<T*>(o);
  if (bias != nullptr) {
    return launch_mma_one<T, D, true>(qt, kt, vt, bt, ot, lse, B, H, L, stream);
  }
  return launch_mma_one<T, D, false>(qt, kt, vt, bt, ot, lse, B, H, L, stream);
}

// B1's template at head dim D: 8 (f32 only: bf16's mma is 16 deep), 16, 32
// or 64; any other D is refused.
template <typename T>
cudaError_t launch_mma(const void* q, const void* k, const void* v, const void* bias, void* o,
                       float* lse, int B, int H, int L, int D, cudaStream_t stream) {
  switch (D) {
    case 8:
      if constexpr (sizeof(T) == 4) {
        return launch_mma_d<T, 8>(q, k, v, bias, o, lse, B, H, L, stream);
      }
      return cudaErrorInvalidValue;
    case 16: return launch_mma_d<T, 16>(q, k, v, bias, o, lse, B, H, L, stream);
    case 32: return launch_mma_d<T, 32>(q, k, v, bias, o, lse, B, H, L, stream);
    case 64: return launch_mma_d<T, 64>(q, k, v, bias, o, lse, B, H, L, stream);
    default: return cudaErrorInvalidValue;
  }
}

// ---------------------------------------------------------------------------
// head_dim past 64: one kernel for every D that is a multiple of 64 (the
// wrapper zero-pads any other D > 64 up to the next one: 72 to 128, 200 to
// 256). Transformer1d at its published widths with num_heads (1, 1, 2, 4)
// calls it at D = 128 and 256, B3 at any D past 64. The mma template above
// is left as it is.
//
// What bounds it on this card. The work is the template's, 4*L*L*D flops a
// (b, h), on mma.sync at 3xTF32 (f32) or bf16, but a kernel templated on D
// keeps state that grows with D (q's fragments, the output's
// accumulators, a ring of K and V tiles: 266,240 bytes at D = 256, past the
// 232,448 a block may have), so D is cut into 64-wide chunks. The first
// design gave each block one 64-wide output part and had every
// block contract S = q.k^T over the whole D: at D = 256 the q.k^T products
// ran four times over, q and K were read four times and q was staged again
// for every key tile, and the kernel ran at 2.4 times SDPA. This design
// computes S once per (row tile, key tile) across a thread-block cluster:
// * The blocks of one row tile (4 warps, 64 query rows of one (b, h), or 2
//   or 4 packed heads at L <= 32: the template's tiling) form a cluster
//   along gridDim.y. Block `rank` owns `per` consecutive chunks of D and
//   those chunks' output parts (WideSplit): at f32 one chunk a block, D /
//   64 blocks, up to D = 512; at bf16, whose products are cheap beside the
//   exchange, two chunks a block, their two parts held at once (D / 128
//   blocks, one at D = 128); past that at most 8 blocks.
// * Per key tile a block contracts the partial S over its own chunks only,
//   writes it to its shared memory (one 64 x 64 f32 tile, 16 KB), and after
//   a cluster barrier reads every block's partial through distributed
//   shared memory (mapa, ld.shared::cluster), summing them in rank order,
//   so that every block of the cluster holds the same S, bit for bit. Each
//   then runs the template's bias, mask and online softmax on it, and O +=
//   P.V over its own parts (a plane of V a part). No chunk of q or K is
//   contracted by two blocks; each is read once a key tile, and q's chunks
//   are staged once and held (per <= hold).
// * Where a block owns more chunks than it holds parts (f32 past D = 512)
//   it walks the key tiles once for each part it holds, the cluster forming
//   S again each time (its chunks' products only), so a block's state stays
//   bounded and every D runs in the same shared memory; its (q, K) chunks
//   are then staged together, key tile by key tile.
// * Registers: at f32 168 a thread (three blocks an SM) without spills,
//   P.V taken a quarter of the part at a time into a fresh fragment; at
//   bf16 q's and K's fragments come by ldmatrix, which keeps its place
//   between the mma, so the compiler does not hold a chunk's fragments at
//   once beside the two parts' accumulators. Shared memory: 68,608 bytes a
//   block at f32 (two one-plane stages, q's chunk, the exchange), 71,680 at
//   bf16 (two two-plane stages, q's two chunks, the exchange).
// * Each block divides its parts by the row sum and rounds them once; rank
//   0 writes the lse. No atomics, and the rank-order sum fixes every add: a
//   call gives bit-identical results.

constexpr int kWideD = 64;      // dims of a chunk of D, and of a block's output part
constexpr int kMaxCluster = 8;  // blocks of a portable cluster

// Output parts a block holds in registers at once: 1 at f32, 2 at bf16
// (whose products are cheap beside the cluster's exchange: fewer blocks,
// each contracting two chunks, halve the exchange's traffic).
template <typename T>
__host__ __device__ constexpr int wide_hold() { return sizeof(T) == 2 ? 2 : 1; }

// How a wide call cuts D, the same on host and device: `chunks` 64-wide
// chunks, `per` consecutive chunks (and output parts) a block (a multiple
// of `hold`, at least ceil(chunks / 8)), clusters of `size` blocks, and
// `passes` walks over the key tiles, one for each `hold` of a block's parts.
struct WideSplit {
  int chunks, per, size, passes;
  __host__ __device__ WideSplit(int D, int hold) {
    chunks = D / kWideD;
    const int least = (chunks + kMaxCluster - 1) / kMaxCluster;
    per = (least + hold - 1) / hold * hold;
    size = (chunks + per - 1) / per;
    passes = per / hold;
  }
};

// Thread-block clusters (sm_90): the block's rank; the cluster barrier,
// whose arrive releases and whose wait acquires, so that shared-memory
// writes before a block's arrive are seen by every block after its wait;
// and the shared memory of a block of the cluster.
__device__ __forceinline__ int cluster_rank() {
  uint32_t r;
  asm volatile("mov.u32 %0, %%cluster_ctarank;\n" : "=r"(r));
  return static_cast<int>(r);
}

__device__ __forceinline__ void cluster_arrive() {
  asm volatile("barrier.cluster.arrive.release.aligned;\n" ::: "memory");
}

__device__ __forceinline__ void cluster_wait() {
  asm volatile("barrier.cluster.wait.acquire.aligned;\n" ::: "memory");
}

// The shared::cluster address of `p`, in this block's shared memory, in
// the block of rank `rank`.
__device__ __forceinline__ uint32_t cluster_map(const void* p, int rank) {
  uint32_t out;
  asm volatile("mapa.shared::cluster.u32 %0, %1, %2;\n"
               : "=r"(out)
               : "r"(static_cast<uint32_t>(__cvta_generic_to_shared(p))), "r"(rank));
  return out;
}

// x += the four floats at shared::cluster address `at`, the load and the
// adds in one asm statement: the compiler cannot hoist a strip's loads
// ahead of their adds and hold them all at once (64 registers in the
// backward's exchange).
__device__ __forceinline__ void add_cluster(float (&x)[4], uint32_t at) {
  asm volatile(
      "{\n"
      " .reg .f32 a, b, c, d;\n"
      " ld.shared::cluster.v4.f32 {a, b, c, d}, [%4];\n"
      " add.f32 %0, %0, a;\n"
      " add.f32 %1, %1, b;\n"
      " add.f32 %2, %2, c;\n"
      " add.f32 %3, %3, d;\n"
      "}\n"
      : "+f"(x[0]), "+f"(x[1]), "+f"(x[2]), "+f"(x[3])
      : "r"(at)
      : "memory");
}

// x = the sum of the cluster's `size` blocks' x, in rank order from 0 (0 +
// x_0 + x_1 + ...), so that every block gets the same bits. Each thread
// holds kN C fragments, at the same (row, key) in every block; `buf` (kN *
// kMmaThreads float4 of this block's shared memory) takes this block's, a
// fragment's threads contiguous (a warp reads 512 contiguous bytes). Every
// thread calls it after a cluster_arrive that frees `buf`: it waits until
// every block is done with the last exchange, and arrives again once it
// has read. (A reduce-scatter and all-gather, as the backward's, reads
// less at four blocks but costs a third barrier: slower here.)
template <int kN>
__device__ __forceinline__ void cluster_sum(float (&x)[kN][4], float4* buf, int size) {
  cluster_wait();
#pragma unroll
  for (int j = 0; j < kN; ++j) {
    buf[j * kMmaThreads + threadIdx.x] = make_float4(x[j][0], x[j][1], x[j][2], x[j][3]);
    x[j][0] = x[j][1] = x[j][2] = x[j][3] = 0.f;
  }
  cluster_arrive();
  cluster_wait();
  for (int r = 0; r < size; ++r) {
    const uint32_t at = cluster_map(buf + threadIdx.x, r);
#pragma unroll
    for (int j = 0; j < kN; ++j) add_cluster(x[j], at + j * kMmaThreads * 16);
  }
  cluster_arrive();
}

// A ring plane: 64 rows x 64 dims, rows padded (mma_stride).
template <typename T>
__host__ __device__ constexpr int wide_plane() { return kKeyTile * mma_stride<T, kWideD>(); }

// Planes a ring stage holds: the V parts a block holds at once, and, where
// q's chunks are not resident, a K and a q chunk (hold <= 2).
template <typename T>
__host__ __device__ constexpr int wide_stage_planes(bool resident) {
  return resident ? wide_hold<T>() : 2;
}

// Dynamic shared memory of a block at `per` chunks a block: the ring (two
// stages), q's `per` resident chunks where the block holds all its parts at
// once (per <= hold), then the exchange buffer (64 x 64 f32).
template <typename T>
__host__ __device__ constexpr int wide_smem_bytes(int per) {
  return (2 * wide_stage_planes<T>(per <= wide_hold<T>()) + (per <= wide_hold<T>() ? per : 0)) *
             wide_plane<T>() * static_cast<int>(sizeof(T)) +
         kKeyTile * kKeyTile * 4;
}

// Start the copies of 64 rows x 64 dims (dims col0 ..) of x into `dst`
// (stride mma_stride<T, kWideD>()): the block's heads' rows of tile
// `tile`, a head's rows at slot * t.rows. Rows past L, and heads past
// n_heads, are zero-filled.
template <typename T>
__device__ __forceinline__ void stage_wide(T* dst, const T* __restrict__ x, const MmaTiling& t,
                                           long long head0, long long n_heads, int L, int D,
                                           int tile, int col0) {
  constexpr int kPer = 16 / sizeof(T);    // values a copy
  constexpr int kChunks = kWideD / kPer;  // copies a row
  constexpr int kS = mma_stride<T, kWideD>();
  for (int i = threadIdx.x; i < kKeyTile * kChunks; i += kMmaThreads) {
    const int row = i / kChunks, c = i - row * kChunks;
    const int slot = row / t.rows, r = tile * t.rows + row - slot * t.rows;
    const long long bh = head0 + slot;
    const bool in = slot < t.heads && bh < n_heads && r < L;
    const size_t at = in ? (static_cast<size_t>(bh) * L + r) * D + col0 + c * kPer : 0;
    cp_async16(dst + row * kS + c * kPer, x + at, in);
  }
}

// A block's part: O = O * exp(old max - new max) + P.V over the part's 64
// dims at one key tile, V's rows at `vs` (stride kS). f32: P from the C
// fragments `s`; bf16: P's A fragments `pp`, rounded once. sc0 and sc1 are
// the rows' rescales.
template <typename T>
__device__ __forceinline__ void add_pv(float (&a)[kWideD / 8][4], const float (&s)[kKeyTile / 8][4],
                                       const uint32_t (&pp)[kKeyTile / 16][4], const T* vs,
                                       float sc0, float sc1, int nj, int lane) {
  constexpr int kS = mma_stride<T, kWideD>();
  constexpr int kNT = kKeyTile / 8;
  const int g = lane >> 2, tq = lane & 3;
  if constexpr (sizeof(T) == 4) {
    // The tile's P.V in a fresh fragment, a quarter of the part's dims at
    // a time (8 registers, not 32: the kernel keeps to 168 registers, three
    // blocks an SM, without spills), added by the rescale's FMA.
#pragma unroll
    for (int quarter = 0; quarter < 4; ++quarter) {
      constexpr int kN = kWideD / 32;  // n-tiles of a quarter
      float pv[kN][4];
#pragma unroll
      for (int n = 0; n < kN; ++n) pv[n][0] = pv[n][1] = pv[n][2] = pv[n][3] = 0.f;
#pragma unroll
      for (int j = 0; j < kNT; ++j) {
        if (j >= nj) break;
        uint32_t ph[4], pl[4];
        split_tf32(s[j][0], ph[0], pl[0]);
        split_tf32(s[j][2], ph[1], pl[1]);
        split_tf32(s[j][1], ph[2], pl[2]);
        split_tf32(s[j][3], ph[3], pl[3]);
        const float* vr =
            reinterpret_cast<const float*>(vs) + (8 * j + 2 * tq) * kS + 16 * quarter + g;
#pragma unroll
        for (int n = 0; n < kN; ++n) mma_3xtf32(pv[n], ph, pl, vr[8 * n], vr[kS + 8 * n]);
      }
#pragma unroll
      for (int n = 0; n < kN; ++n) {
        float (&an)[4] = a[kN * quarter + n];
        an[0] = fmaf(an[0], sc0, pv[n][0]);
        an[1] = fmaf(an[1], sc0, pv[n][1]);
        an[2] = fmaf(an[2], sc1, pv[n][2]);
        an[3] = fmaf(an[3], sc1, pv[n][3]);
      }
    }
  } else {
#pragma unroll
    for (int n = 0; n < kWideD / 8; ++n) {
      a[n][0] *= sc0;
      a[n][1] *= sc0;
      a[n][2] *= sc1;
      a[n][3] *= sc1;
    }
#pragma unroll
    for (int jj = 0; jj < kNT / 2; ++jj) {
      if (2 * jj >= nj) break;
      const T* vrow = vs + (16 * jj + (lane & 15)) * kS + (lane >> 4) * 8;
#pragma unroll
      for (int n = 0; n < kWideD / 16; ++n) {
        uint32_t b[4];
        ldmatrix_x4_trans(b, vrow + 16 * n);
        mma_bf16(a[2 * n], pp[jj], b[0], b[1]);
        mma_bf16(a[2 * n + 1], pp[jj], b[2], b[3]);
      }
    }
  }
}

template <typename T, bool kBias, bool kWin>
__global__ void __launch_bounds__(kMmaThreads)
attention_fwd_wide_kernel(const T* __restrict__ q, const T* __restrict__ k,
                          const T* __restrict__ v, const T* __restrict__ bias,
                          T* __restrict__ o, float* __restrict__ lse, int B, int H, int L,
                          int D, const float* __restrict__ offsets, int W) {
  constexpr bool kF32 = sizeof(T) == 4;
  constexpr int kS = mma_stride<T, kWideD>();
  constexpr int kPlane = wide_plane<T>();
  constexpr int kNT = kKeyTile / 8;  // n-tiles of S at the widest stage
  constexpr int kHold = wide_hold<T>();
  extern __shared__ __align__(16) unsigned char smem[];
  const WideSplit sp(D, kHold);
  const bool resident = sp.per <= kHold;  // q's chunks held; else staged with K
  const int planes = wide_stage_planes<T>(resident);
  T* ring = reinterpret_cast<T*>(smem);  // [stage][planes][kPlane]
  T* qres = ring + 2 * planes * kPlane;  // resident: q's chunks
  float4* xchg = reinterpret_cast<float4*>(qres + (resident ? sp.per : 0) * kPlane);
  // A block of its own (bf16 at D = 128) exchanges nothing. (At f32 a
  // cluster has two blocks or more, and the test, known true, costs the
  // kernel no registers.)
  const bool clustered = kHold == 1 || sp.size > 1;
  const int rank = cluster_rank();
  const int c0 = rank * sp.per;                  // this block's chunks c0 ..
  const int nc = min(sp.per, sp.chunks - c0);    // .. c0 + nc - 1
  const MmaTiling t(L);
  const long long n_heads = static_cast<long long>(B) * H;
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int g = lane >> 2, tq = lane & 3;
  const int qtile = blockIdx.x % t.tiles;
  const long long head0 = static_cast<long long>(blockIdx.x / t.tiles) * t.heads;
  const int slot = warp / t.warps;
  const long long bh = head0 + slot;
  const bool head_ok = bh < n_heads;
  const int h = static_cast<int>(bh % H);
  const int r0 = qtile * t.rows + (warp - slot * t.warps) * 16 + g, r1 = r0 + 8;
  const bool ok0 = head_ok && r0 < L, ok1 = head_ok && r1 < L;
  const size_t base = static_cast<size_t>(head_ok ? bh : 0) * L;  // the head's first row
  const int nj = t.rows / 8;  // n-tiles of S a key tile

  // The block walks the key tiles once a pass: pass p outputs the kHold
  // parts c0 + p * kHold .., those it owns (the cluster's last block may
  // own fewer chunks: its extra passes and parts only contract, for the
  // others). Per key tile: nc stages of its K (and q) chunks, then one
  // stage of the held parts' V.
  const int per_tile = nc + 1;
  const int n_stages = sp.passes * t.tiles * per_tile;
  auto stage = [&](int st) {
    T* buf = ring + (st & 1) * planes * kPlane;
    const int tc = st / per_tile, ix = st - tc * per_tile;
    const int kt = tc % t.tiles, first = tc / t.tiles * kHold;
    if (ix < nc) {
      stage_wide<T>(buf, k, t, head0, n_heads, L, D, kt, (c0 + ix) * kWideD);
      if (!resident) stage_wide<T>(buf + kPlane, q, t, head0, n_heads, L, D, qtile, (c0 + ix) * kWideD);
    } else {
#pragma unroll
      for (int hh = 0; hh < kHold; ++hh) {
        if (first + hh < nc) {
          stage_wide<T>(buf + hh * kPlane, v, t, head0, n_heads, L, D, kt,
                        (c0 + first + hh) * kWideD);
        }
      }
    }
    asm volatile("cp.async.commit_group;\n" ::);
  };

  float acc[kHold][kWideD / 8][4];
#pragma unroll
  for (int hh = 0; hh < kHold; ++hh) {
#pragma unroll
    for (int n = 0; n < kWideD / 8; ++n) acc[hh][n][0] = acc[hh][n][1] = acc[hh][n][2] = acc[hh][n][3] = 0.f;
  }
  float s[kNT][4];
  uint32_t pp[kNT / 2][4];  // bf16: P's A fragments, rounded once for the held parts
  float mx0 = __int_as_float(0xff800000), mx1 = mx0;  // running row maxima, -inf
  float sum0 = 0.f, sum1 = 0.f;                       // this lane's partial row sums
  float sc0 = 0.f, sc1 = 0.f;                         // this key tile's rescale
  const T* brow0 = kBias ? bias + (static_cast<size_t>(h) * L + (ok0 ? r0 : 0)) * L : nullptr;
  const T* brow1 = kBias ? bias + (static_cast<size_t>(h) * L + (ok1 ? r1 : 0)) * L : nullptr;
  if constexpr (kWin) {  // the window of the head's batch element
    if (lane == 0) {
      warp_windows<kMmaWarps>()[warp] =
          window_of(head_ok ? offsets[static_cast<int>(bh) / H] : 0.f, W, L);
    }
  }

  if (resident) {  // joins stage 0's group
    for (int i = 0; i < nc; ++i) {
      stage_wide<T>(qres + i * kPlane, q, t, head0, n_heads, L, D, qtile, (c0 + i) * kWideD);
    }
  }
  stage(0);
  if (clustered) cluster_arrive();  // this block's exchange buffer is free
  for (int st = 0; st < n_stages; ++st) {
    asm volatile("cp.async.wait_group 0;\n" ::);
    // Stage st is in for every thread, and every thread is done with the
    // buffer stage st + 1 overwrites (used for stage st - 1).
    __syncthreads();
    if (st + 1 < n_stages) stage(st + 1);
    const T* buf = ring + (st & 1) * planes * kPlane;
    const int tc = st / per_tile, ix = st - tc * per_tile;
    const int kt = tc % t.tiles, pass = tc / t.tiles;
    if (ix < nc) {
      if (ix == 0) {
#pragma unroll
        for (int j = 0; j < kNT; ++j) s[j][0] = s[j][1] = s[j][2] = s[j][3] = 0.f;
      }
      // This warp's q rows: chunk ix of the resident ones (at f32 the one),
      // or the stage's.
      const T* qs = (resident ? qres + (kHold > 1 ? ix * kPlane : 0) : buf + kPlane) + 16 * warp * kS;
      const T* ks = buf + slot * t.rows * kS;  // its head's keys
      // S += q.k^T over this chunk's 64 dims.
      if constexpr (kF32) {
#pragma unroll
        for (int kk = 0; kk < kWideD / 8; ++kk) {
          const float* qp = reinterpret_cast<const float*>(qs) + g * kS + 8 * kk + tq;
          uint32_t ah[4], al[4];
          split_tf32(qp[0], ah[0], al[0]);
          split_tf32(qp[8 * kS], ah[1], al[1]);
          split_tf32(qp[4], ah[2], al[2]);
          split_tf32(qp[8 * kS + 4], ah[3], al[3]);
#pragma unroll
          for (int j = 0; j < kNT; ++j) {
            if (j >= nj) break;
            const float* kr = reinterpret_cast<const float*>(ks) + (8 * j + g) * kS + 8 * kk + tq;
            float tf[4] = {0.f, 0.f, 0.f, 0.f};  // this k-step's products, summed apart
            mma_3xtf32(tf, ah, al, kr[0], kr[4]);
#pragma unroll
            for (int i = 0; i < 4; ++i) s[j][i] += tf[i];
          }
        }
      } else {
        // q's A fragments and K's B fragments by ldmatrix (four 8 x 8
        // matrices a load): an asm that keeps its place between the mma,
        // so the compiler holds one k-step's fragments, not all of them (at
        // the two parts' 64 accumulators it spilled otherwise).
        const T* qrow = qs + (lane & 15) * kS + (lane >> 4) * 8;
        const T* krow = ks + ((lane & 7) + ((lane >> 4) << 3)) * kS + ((lane >> 3) & 1) * 8;
#pragma unroll
        for (int kk = 0; kk < kWideD / 16; ++kk) {
          uint32_t a[4];
          ldmatrix_x4(a, qrow + 16 * kk);
#pragma unroll
          for (int j = 0; j < kNT; j += 2) {
            if (j >= nj) break;
            uint32_t b[4];  // n-tile j's b0, b1, then n-tile j + 1's
            ldmatrix_x4(b, krow + 8 * j * kS + 16 * kk);
            mma_bf16(s[j], a, b[0], b[1]);
            mma_bf16(s[j + 1], a, b[2], b[3]);
          }
        }
      }
      if (ix + 1 < nc) continue;

      // This block's chunks are in: S over the whole D from the cluster,
      // then bias, keys past L to -inf, the online softmax.
      if (clustered) cluster_sum<kNT>(s, xchg, sp.size);
      const int key0 = kt * t.rows;
#pragma unroll
      for (int j = 0; j < kNT; ++j) {
        if (j >= nj) break;
        const int m = key0 + 8 * j + 2 * tq;  // the key of c0 and c2; m + 1 of c1 and c3
        if constexpr (kBias) {
          // The rows that take a bias, and the keys (the template's).
          const Window win = bias_window<kWin, kMmaWarps, sizeof(T) == 4>(warp, L);
          const bool in0 = kWin ? ok0 && win.has(r0) : ok0, in1 = kWin ? ok1 && win.has(r1) : ok1;
          if (in_bias<kWin>(win, m, L)) {
            s[j][0] += in0 ? to_float(brow0[m]) : 0.f;
            s[j][2] += in1 ? to_float(brow1[m]) : 0.f;
          }
          if (in_bias<kWin>(win, m + 1, L)) {
            s[j][1] += in0 ? to_float(brow0[m + 1]) : 0.f;
            s[j][3] += in1 ? to_float(brow1[m + 1]) : 0.f;
          }
        }
        if (m >= L) s[j][0] = s[j][2] = __int_as_float(0xff800000);
        if (m + 1 >= L) s[j][1] = s[j][3] = __int_as_float(0xff800000);
      }
      float t0 = __int_as_float(0xff800000), t1 = t0;
#pragma unroll
      for (int j = 0; j < kNT; ++j) {
        if (j >= nj) break;
        t0 = fmaxf(t0, fmaxf(s[j][0], s[j][1]));
        t1 = fmaxf(t1, fmaxf(s[j][2], s[j][3]));
      }
#pragma unroll
      for (int x = 1; x <= 2; x <<= 1) {
        t0 = fmaxf(t0, __shfl_xor_sync(0xffffffffu, t0, x));
        t1 = fmaxf(t1, __shfl_xor_sync(0xffffffffu, t1, x));
      }
      const float new0 = fmaxf(mx0, t0), new1 = fmaxf(mx1, t1);
      sc0 = __expf(mx0 - new0);  // 0 at the first key tile
      sc1 = __expf(mx1 - new1);
      mx0 = new0;
      mx1 = new1;
      sum0 *= sc0;
      sum1 *= sc1;
#pragma unroll
      for (int j = 0; j < kNT; ++j) {
        if (j >= nj) break;
        s[j][0] = __expf(s[j][0] - mx0);
        s[j][1] = __expf(s[j][1] - mx0);
        s[j][2] = __expf(s[j][2] - mx1);
        s[j][3] = __expf(s[j][3] - mx1);
        sum0 += s[j][0] + s[j][1];
        sum1 += s[j][2] + s[j][3];
      }
      if constexpr (!kF32) {
        // k-step jj of P.V: keys 16jj .. 16jj + 15, the C pairs of n-tiles
        // 2jj and 2jj + 1 rounded to bf16 (the template's).
#pragma unroll
        for (int jj = 0; jj < kNT / 2; ++jj) {
          if (2 * jj >= nj) break;
          pp[jj][0] = bf16x2(s[2 * jj][0], s[2 * jj][1]);
          pp[jj][1] = bf16x2(s[2 * jj][2], s[2 * jj][3]);
          pp[jj][2] = bf16x2(s[2 * jj + 1][0], s[2 * jj + 1][1]);
          pp[jj][3] = bf16x2(s[2 * jj + 1][2], s[2 * jj + 1][3]);
        }
      }
      continue;
    }

    // The V stage: the held parts' V, a plane each.
    const int first = pass * kHold;  // the pass's first part of c0 ..
#pragma unroll
    for (int hh = 0; hh < kHold; ++hh) {
      if (first + hh < nc) {
        add_pv<T>(acc[hh], s, pp, buf + hh * kPlane + slot * t.rows * kS, sc0, sc1, nj, lane);
      }
    }
    if (kt + 1 < t.tiles) continue;

    // The pass's last key tile: its parts are done.
    float tot0 = sum0, tot1 = sum1;
#pragma unroll
    for (int x = 1; x <= 2; x <<= 1) {
      tot0 += __shfl_xor_sync(0xffffffffu, tot0, x);
      tot1 += __shfl_xor_sync(0xffffffffu, tot1, x);
    }
#pragma unroll
    for (int hh = 0; hh < kHold; ++hh) {
      if (first + hh < nc) {
        T* o0 = o + (base + r0) * D + (c0 + first + hh) * kWideD + 2 * tq;
        T* o1 = o0 + 8 * static_cast<size_t>(D);
#pragma unroll
        for (int n = 0; n < kWideD / 8; ++n) {
          if (ok0) store2(o0 + 8 * n, acc[hh][n][0] / tot0, acc[hh][n][1] / tot0);
          if (ok1) store2(o1 + 8 * n, acc[hh][n][2] / tot1, acc[hh][n][3] / tot1);
        }
      }
#pragma unroll
      for (int n = 0; n < kWideD / 8; ++n) {
        acc[hh][n][0] = acc[hh][n][1] = acc[hh][n][2] = acc[hh][n][3] = 0.f;
      }
    }
    if (lse != nullptr && rank == 0 && pass == 0 && tq == 0) {
      if (ok0) lse[base + r0] = mx0 + logf(tot0);
      if (ok1) lse[base + r1] = mx1 + logf(tot1);
    }
    mx0 = mx1 = __int_as_float(0xff800000);
    sum0 = sum1 = 0.f;
  }
  // Pairs the last exchange's arrive: no block leaves while its buffer is read.
  if (clustered) cluster_wait();
}

// A launch on grid (blocks, size) in clusters of (1, size, 1) blocks. Used
// in place: cfg points at attr.
struct ClusterLaunch {
  cudaLaunchConfig_t cfg;
  cudaLaunchAttribute attr[1];
  ClusterLaunch(unsigned blocks, int size, int smem, cudaStream_t stream) : cfg{}, attr{} {
    cfg.gridDim = dim3(blocks, static_cast<unsigned>(size), 1);
    cfg.blockDim = dim3(kMmaThreads, 1, 1);
    cfg.dynamicSmemBytes = static_cast<size_t>(smem);
    cfg.stream = stream;
    attr[0].id = cudaLaunchAttributeClusterDimension;
    attr[0].val.clusterDim.x = 1;
    attr[0].val.clusterDim.y = static_cast<unsigned>(size);
    attr[0].val.clusterDim.z = 1;
    cfg.attrs = attr;
    cfg.numAttrs = 1;
  }
  ClusterLaunch(const ClusterLaunch&) = delete;
};

// Above 48 KB a block's dynamic shared memory must be allowed once per
// instantiation: the larger layout's.
template <typename T, bool kBias, bool kWin>
cudaError_t allow_wide() {
  static const cudaError_t allowed = cudaFuncSetAttribute(
      attention_fwd_wide_kernel<T, kBias, kWin>, cudaFuncAttributeMaxDynamicSharedMemorySize,
      wide_smem_bytes<T>(2));
  return allowed;
}

template <typename T, bool kBias, bool kWin>
cudaError_t launch_wide_one(const T* q, const T* k, const T* v, const T* bias, T* o,
                            float* lse, int B, int H, int L, int D, const float* offsets, int W,
                            cudaStream_t stream) {
  const cudaError_t allowed = allow_wide<T, kBias, kWin>();
  if (allowed != cudaSuccess) return allowed;
  const MmaTiling t(L);
  const WideSplit sp(D, wide_hold<T>());
  const long long groups = (static_cast<long long>(B) * H + t.heads - 1) / t.heads;
  const long long blocks = groups * t.tiles;
  if (blocks > 0x7fffffffLL) return cudaErrorInvalidValue;
  ClusterLaunch launch(static_cast<unsigned>(blocks), sp.size, wide_smem_bytes<T>(sp.per),
                       stream);
  const cudaError_t err = cudaLaunchKernelEx(&launch.cfg, attention_fwd_wide_kernel<T, kBias, kWin>,
                                             q, k, v, bias, o, lse, B, H, L, D, offsets, W);
  return err != cudaSuccess ? err : cudaGetLastError();
}

// The wide kernel at D, a multiple of 64 past 64; any other D is refused.
// kWin: B3, `bias` the toep and `offsets` and W the windows (both
// required); else B1, offsets unused.
template <typename T, bool kWin>
cudaError_t launch_wide(const void* q, const void* k, const void* v, const void* bias, void* o,
                        float* lse, int B, int H, int L, int D, const float* offsets, int W,
                        cudaStream_t stream) {
  if (D <= kWideD || D % kWideD) return cudaErrorInvalidValue;
  const T* qt = static_cast<const T*>(q);
  const T* kt = static_cast<const T*>(k);
  const T* vt = static_cast<const T*>(v);
  const T* bt = static_cast<const T*>(bias);
  T* ot = static_cast<T*>(o);
  if constexpr (kWin) {
    return launch_wide_one<T, true, true>(qt, kt, vt, bt, ot, lse, B, H, L, D, offsets, W,
                                          stream);
  } else {
    if (bias != nullptr) {
      return launch_wide_one<T, true, false>(qt, kt, vt, bt, ot, lse, B, H, L, D, nullptr, 0,
                                             stream);
    }
    return launch_wide_one<T, false, false>(qt, kt, vt, bt, ot, lse, B, H, L, D, nullptr, 0,
                                            stream);
  }
}

template <typename T, bool kBias, bool kWin>
cudaError_t wide_clusters_one(int D, int* clusters) {
  const cudaError_t allowed = allow_wide<T, kBias, kWin>();
  if (allowed != cudaSuccess) return allowed;
  const WideSplit sp(D, wide_hold<T>());
  ClusterLaunch launch(1, sp.size, wide_smem_bytes<T>(sp.per), nullptr);
  return cudaOccupancyMaxActiveClusters(
      clusters, reinterpret_cast<const void*>(attention_fwd_wide_kernel<T, kBias, kWin>),
      &launch.cfg);
}

// The wide kernel's clusters at D that the card holds at once
// (cudaOccupancyMaxActiveClusters), and their size.
template <typename T, bool kWin>
cudaError_t wide_clusters(int D, bool with_bias, int* clusters, int* size) {
  if (D <= kWideD || D % kWideD) return cudaErrorInvalidValue;
  *size = WideSplit(D, wide_hold<T>()).size;
  if constexpr (kWin) {
    return wide_clusters_one<T, true, true>(D, clusters);
  } else {
    return with_bias ? wide_clusters_one<T, true, false>(D, clusters)
                     : wide_clusters_one<T, false, false>(D, clusters);
  }
}

}  // namespace mma_fwd
}  // namespace
