// B3's window kernel: attention with a per-window R-peak bias, forward, on
// Hopper's tensor cores (sm_90a), at head_dim 4 past 256 keys and at 8,
// 16, 32 and 64 (bf16: 4 past 256 keys, 16, 32 and 64), any L.
//
// Replaces the TPU kernel ecg_denoise_tpu/kernels/attention_pallas.py
// _fwd_rpos_kernel (:827, launched through _rpos_call :978) at those
// shapes; attention_rpos_fwd.cu keeps its D = 4 kernel at L <= 256 and the
// wide kernel (attention_fwd_mma.cuh, kWin) past D = 64. The function is
// that file's: for every (b, h, l)
//   out[b,h,l,:] = softmax_m(q[b,h,l,:] . k[b,h,m,:] + bias_b[h,l,m]) . v[b,h,:,:]
//   bias_b[h,l,m] = toep[0,h,l,m] * in_b[l] * in_b[m],  in_b[i] = (off_b <= i < off_b + W)
// with the window compared in float32 (attention_window.cuh), and each
// row's log-sum-exp for the backward (attention_rpos_bwd.cu).
//
// What bounds it. Per (b, h) 4 L^2 D flops of products (q.k^T and p.v, at
// three TF32 passes for f32: 3xTF32) and L^2 exps. At D <= 8 the products
// are few beside the exps: at (L, H) = (1000, 2) and B = 1,024 the
// B H L^2 = 2.05e9 exps take 0.49 ms a call on the special-function units
// (16 a clock an SM, 132 SMs, 1.98 GHz), above the products' 0.20 ms at
// the TF32 peak; at D = 32 the products set the bound. So the design cuts
// the instructions a (row, key) pair costs beside the exp.
//
// The first version was B1's D >= 8 template switched into a
// window mode. It padded D = 4 to 8 (16 in bf16), so half (three
// quarters) of its products were of zeros; it tested the window on every
// 16 x 8 n-tile of every key tile, where the W x W window meets 3 % of the
// (row strip, key tile) pairs at (1000, 125); and each of a block's four
// warps split every staged K and V value into TF32 halves for itself.
//
// Design (mma.sync; the tiles are too small at D <= 8 for a warpgroup's
// 64-row wgmma to be the limit):
// * A block is 4 warps and owns 64 * kMF consecutive query rows of one
//   (b, h); a warp owns 16 * kMF of them (kMF m16 fragments: 2 at f32 D =
//   16 and 32, where each K and V fragment load then feeds twice the rows;
//   1 elsewhere, where 32 rows a warp measured slower), and the grid walks
//   (b, h) by row tiles. Rows past L compute on q = 0 and store nothing (a
//   warp wholly past L too: a flag held across the tile loop made ptxas
//   spill).
// * K and V stream through shared memory in tiles of kKeys keys (64; 32 at
//   f32 D = 64, whose registers hold q's 64 dims), in a ring of cp.async
//   stages with the next tiles' copies in flight (keys past L
//   zero-filled). Tiles of 128 keys at D <= 8, paying the barrier, the quad
//   max and the rescale half as often, measured slower at f32 (the strip
//   of S took registers from occupancy) and level at bf16.
// * f32: after a tile lands, the block splits each K and V value once
//   into TF32 hi and lo (hi = x rounded by its bits, lo = x - hi whole,
//   B5's split) into planes laid out so that one 8- or 16-byte load gives
//   a lane a fragment's halves, each pair in consecutive registers, bank
//   conflict-free: K as [key][dim pair (t, t + 4)][hi, hi, lo, lo] (D = 4:
//   [key][dim][hi, lo]), V as [key pair (2t, 2t + 1)][dim][hi, hi, lo, lo]
//   (the key order of P's A fragment, below). The warps only load
//   fragments. At D = 32 q's halves wait in shared memory too (below).
// * D = 4 unpadded. f32 q.k^T runs on mma.m16n8k4 TF32 at three passes;
//   bf16 on mma.m16n8k8 with q's k = 4-7 zero in registers and the staged
//   K rows padded with zeros to 8. p.v at D = 4 takes an 8-wide n-tile: f32
//   V's planes hold a ones column at dim 4, so that p.v sums each row's
//   exps on the tensor cores (no FADD a pair), zeros at 5-7; bf16's staged
//   rows zeros at 4-7, read by ldmatrix.trans.
// * The window is tested once a (warp, key tile): Window::meets on the
//   warp's rows and the tile's keys, warp-uniform. A tile that does not
//   meet the window runs no bias code at all; one that does adds toep[h,
//   l, m] where row and key are both inside it (a predicated load from
//   global memory, where the batch finds toep in L2). Keys past L get -inf
//   on the last tile only.
// * The online softmax in the log2 domain: each row's running max is kept
//   scaled by log2(e), each exp is one FFMA and ex2.approx (FA2's fold),
//   the rescale is ex2 of the difference of two scaled maxima (exactly 1
//   when the max holds), and the lse is (max + log2 sum) * ln 2, the
//   normaliser of the exps actually summed.
// * P goes from q.k^T's C fragment to p.v's A fragment in registers (f32:
//   A column t takes key 2t, column t + 4 key 2t + 1, split by truncation,
//   two instructions; bf16: the C pairs of two n-tiles). f32 sums each
//   k-step's q.k^T and each 64 keys' p.v in fresh fragments and adds them
//   on the CUDA cores: the tensor core's f32 sums do not round to nearest
//   (attention_fwd_mma.cuh); p.v's hi.hi products go to fragments of their
//   own, so that its chains of dependent mma are half as long.
// * No atomics: a call gives bit-identical results every time.

#pragma once

#include <cuda_bf16.h>
#include <cuda_runtime.h>

#include <cstdint>

#include "attention_fwd_mma.cuh"
#include "attention_window.cuh"

namespace {
namespace rpos_fwd {

using mma_fwd::bf16x2;
using mma_fwd::ldmatrix_x4_trans;
using mma_fwd::mma_bf16;
using mma_fwd::mma_tf32;
using mma_fwd::store2;
using mma_fwd::to_float;

constexpr int kWarps = 4;
constexpr int kThreads = 32 * kWarps;
constexpr float kLog2e = 1.4426950408889634f;
constexpr float kLn2 = 0.6931471805599453f;

// The tiling and shared memory of one instantiation.
template <typename T, int D>
struct RposTile {
  static constexpr bool kF32 = sizeof(T) == 4;
  static constexpr int kMF = kF32 && (D == 16 || D == 32) ? 2 : 1;  // m16 fragments a warp
  static constexpr int kKeys = kF32 && D == 64 ? 32 : 64;             // keys a tile
  static constexpr int kWarpRows = 16 * kMF;
  static constexpr int kRows = kWarps * kWarpRows;  // query rows a block
  static constexpr int kNT = kKeys / 8;             // n-tiles of S a tile
  static constexpr int kDv = D < 8 ? 8 : D;         // p.v's output dims (D = 4: 4 zero)
  // Stages of the ring. f32 D = 64 keeps one, so that two blocks fit an SM:
  // the split planes are a second buffer, and the next tile's copy is in
  // flight while the planes are used.
  static constexpr int kStages = kF32 && D == 64 ? 1 : 2;
  // A staged row's stride in elements: f32 dense (only the split reads it,
  // 16 bytes a thread); bf16 D + 8 (fragment loads and ldmatrix
  // conflict-free), D = 4 padded to 8 with zeros.
  static constexpr int kRawS = kF32 ? D : D == 4 ? 8 : D + 8;
  static constexpr int kRawElems = 2 * kKeys * kRawS;  // K and V of one stage
  // f32 planes: K a key's row, its stride = 16 mod 32 floats past D = 4
  // (the 16-byte loads of 8 lanes fall in 32 banks); V a key pair's row,
  // its stride = 8 mod 32.
  static constexpr int kKRow = D == 4 ? 8 : (2 * D) % 32 == 16 ? 2 * D : 2 * D + 16;
  static constexpr int kVRow = 4 * kDv + 8;
  static constexpr int kPlaneFloats = kF32 ? kKeys * kKRow + kKeys / 2 * kVRow : 0;
  // f32 at D >= 32 with 32 rows a warp: q's TF32 halves wait in shared
  // memory, a warp's own words, loaded a k-step at a time, so that the
  // registers hold the two strips of S instead (ptxas spilled them else).
  static constexpr bool kQSmem = kF32 && kMF == 2 && D >= 32;
  static constexpr int kQWords = kQSmem ? D / 8 * kMF * 2 * 32 * 4 : 0;  // a warp's
  static constexpr int kSmemBytes = kStages * kRawElems * static_cast<int>(sizeof(T)) +
                                    (kPlaneFloats + kWarps * kQWords) * 4;
};

__device__ __forceinline__ float ex2(float x) {
  float y;
  asm("ex2.approx.ftz.f32 %0, %1;" : "=f"(y) : "f"(x));
  return y;
}

// x = hi + lo: hi is x rounded to TF32 by its bits (half a TF32 ulp added,
// the 13 dropped bits cleared), lo = x - hi exactly, passed whole: the
// tensor core reads its TF32 bits, an error of at most 2^-21 |x| (B5's
// split, attention_dense_fwd.cu).
__device__ __forceinline__ void split_tf32(float x, uint32_t& hi, uint32_t& lo) {
  hi = (__float_as_uint(x) + 0x1000u) & 0xffffe000u;
  lo = __float_as_uint(x - __uint_as_float(hi));
}

// P's halves for p.v: hi is p truncated to TF32 (its 13 low bits cleared),
// lo = p - hi exactly (|lo| < 2^-10 p), passed whole. One instruction fewer
// than split_tf32; the product p.v then errs by at most about 2^-20 of
// p |v|, against the 1e-5 bar.
__device__ __forceinline__ void split_p(float x, uint32_t& hi, uint32_t& lo) {
  hi = __float_as_uint(x) & 0xffffe000u;
  lo = __float_as_uint(x - __uint_as_float(hi));
}

// tf32 m16n8k4: A a0 (g, t), a1 (g + 8, t); B b0 (t, g); C as m16n8k8.
__device__ __forceinline__ void mma_tf32_k4(float (&c)[4], uint32_t a0, uint32_t a1,
                                            uint32_t b0) {
  asm volatile(
      "mma.sync.aligned.m16n8k4.row.col.f32.tf32.tf32.f32 "
      "{%0, %1, %2, %3}, {%4, %5}, {%6}, {%0, %1, %2, %3};\n"
      : "+f"(c[0]), "+f"(c[1]), "+f"(c[2]), "+f"(c[3])
      : "r"(a0), "r"(a1), "r"(b0));
}

// bf16 m16n8k8: A a0 (g, 2t..2t+1), a1 (g + 8, 2t..2t+1); B b0 (2t..2t+1, g).
__device__ __forceinline__ void mma_bf16_k8(float (&c)[4], uint32_t a0, uint32_t a1,
                                            uint32_t b0) {
  asm volatile(
      "mma.sync.aligned.m16n8k8.row.col.f32.bf16.bf16.f32 "
      "{%0, %1, %2, %3}, {%4, %5}, {%6}, {%0, %1, %2, %3};\n"
      : "+f"(c[0]), "+f"(c[1]), "+f"(c[2]), "+f"(c[3])
      : "r"(a0), "r"(a1), "r"(b0));
}

// `kBytes` by cp.async, zero-filled where `in` is false: 16 bytes through
// L2 only (.cg), 8 (a bf16 row at D = 4) through L1 (.ca, the only size
// .cg lacks).
template <int kBytes>
__device__ __forceinline__ void cp_async(void* dst, const void* src, bool in) {
  const unsigned s = static_cast<unsigned>(__cvta_generic_to_shared(dst));
  if constexpr (kBytes == 16) {
    asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::"r"(s), "l"(src),
                 "r"(in ? 16 : 0));
  } else {
    asm volatile("cp.async.ca.shared.global [%0], [%1], 8, %2;\n" ::"r"(s), "l"(src),
                 "r"(in ? 8 : 0));
  }
}

// Stage key tile `kt` of the block's head (its first row `base`) into the
// ring's buffer `buf`: K rows, then V rows, kRawS apart; a commit group.
template <typename T, int D>
__device__ __forceinline__ void stage_kv(T* buf, const T* __restrict__ k,
                                         const T* __restrict__ v, int base, int L, int kt) {
  using C = RposTile<T, D>;
  constexpr int kBytes = D * sizeof(T) < 16 ? D * sizeof(T) : 16;
  constexpr int kPer = kBytes / sizeof(T);  // values a copy
  constexpr int kChunks = D / kPer;         // copies a row
  T* vbuf = buf + C::kKeys * C::kRawS;
  for (int i = threadIdx.x; i < C::kKeys * kChunks; i += kThreads) {
    const int row = i / kChunks, c = i - row * kChunks;
    const int key = kt * C::kKeys + row;
    const bool in = key < L;
    const int at = in ? (base + key) * D + c * kPer : 0;  // q.numel() < 2^31 (the wrapper)
    cp_async<kBytes>(buf + row * C::kRawS + c * kPer, k + at, in);
    cp_async<kBytes>(vbuf + row * C::kRawS + c * kPer, v + at, in);
  }
  asm volatile("cp.async.commit_group;\n" ::);
}

// The TF32 halves of four values, as uint32 bits.
__device__ __forceinline__ void split4(float4 x, uint32_t (&h)[4], uint32_t (&l)[4]) {
  split_tf32(x.x, h[0], l[0]);
  split_tf32(x.y, h[1], l[1]);
  split_tf32(x.z, h[2], l[2]);
  split_tf32(x.w, h[3], l[3]);
}

__device__ __forceinline__ void store4(float* p, uint32_t a, uint32_t b, uint32_t c, uint32_t d) {
  *reinterpret_cast<uint4*>(p) = make_uint4(a, b, c, d);
}

// f32: split a landed stage into the planes, each value once. K at D = 4:
// [key][dim t][hi, lo], a lane's m16n8k4 B fragment (key g, dim t) one
// 8-byte load. K past it: [key][k-step][t][hi(t), hi(t + 4), lo(t), lo(t +
// 4)], a lane's m16n8k8 B fragment (b0 at dim t, b1 at t + 4) one 16-byte
// load with each half's pair in consecutive registers. V: [key pair
// p][dim][hi(2p), hi(2p + 1), lo(2p), lo(2p + 1)], p.v's B fragment (b0 at
// key 2t, b1 at 2t + 1, P's key order) the same way.
template <int D>
__device__ __forceinline__ void split_kv(const float* raw, float* kp, float* vp) {
  using C = RposTile<float, D>;
  constexpr int kKItems = D == 4 ? C::kKeys : C::kKeys * D / 8;  // K: a key, or a key's 8 dims
  constexpr int kVItems = C::kKeys / 2 * (D / 4);                // V: a key pair's 4 dims
  const float* vraw = raw + C::kKeys * D;
  uint32_t h[4], l[4], h2[4], l2[4];
  // K's items, then V's, spread over the block.
  for (int i = threadIdx.x; i < kKItems + kVItems; i += kThreads) {
    if (i < kKItems) {
      if constexpr (D == 4) {
        split4(*reinterpret_cast<const float4*>(raw + i * 4), h, l);
        store4(kp + i * C::kKRow, h[0], l[0], h[1], l[1]);
        store4(kp + i * C::kKRow + 4, h[2], l[2], h[3], l[3]);
      } else {
        const int key = i / (D / 8), kk = i - key * (D / 8);  // dims 8kk .. 8kk + 7
        const float* x = raw + key * D + 8 * kk;
        split4(*reinterpret_cast<const float4*>(x), h, l);
        split4(*reinterpret_cast<const float4*>(x + 4), h2, l2);
#pragma unroll
        for (int t = 0; t < 4; ++t) {
          store4(kp + key * C::kKRow + 16 * kk + 4 * t, h[t], h2[t], l[t], l2[t]);
        }
      }
    } else {
      const int p = (i - kKItems) / (D / 4);  // keys 2p, 2p + 1 at dims 4c .. 4c + 3
      const int c = i - kKItems - p * (D / 4);
      split4(*reinterpret_cast<const float4*>(vraw + 2 * p * D + 4 * c), h, l);
      split4(*reinterpret_cast<const float4*>(vraw + (2 * p + 1) * D + 4 * c), h2, l2);
#pragma unroll
      for (int u = 0; u < 4; ++u) {
        store4(vp + p * C::kVRow + (4 * c + u) * 4, h[u], h2[u], l[u], l2[u]);
      }
    }
  }
}

template <typename T, int D>
__global__ void __launch_bounds__(kThreads)
attention_rpos_fwd_mma_kernel(const T* __restrict__ q, const T* __restrict__ k,
                              const T* __restrict__ v, const T* __restrict__ toep,
                              const float* __restrict__ offsets, T* __restrict__ o,
                              float* __restrict__ lse, int H, int L, int W) {
  using C = RposTile<T, D>;
  constexpr bool kF32 = C::kF32;
  constexpr int kMF = C::kMF, kNT = C::kNT, kKeys = C::kKeys;
  constexpr int kKS = kF32 ? (D == 4 ? 1 : D / 8) : (D == 4 ? 1 : D / 16);  // q.k^T k-steps
  constexpr int kNV = C::kDv / 8;  // p.v's n-tiles
  constexpr bool kOnes = kF32 && D == 4;  // the row sums from V's ones column
  extern __shared__ __align__(16) unsigned char smem[];
  T* ring = reinterpret_cast<T*>(smem);  // [stage][K, V][kKeys][kRawS]
  float* kp = reinterpret_cast<float*>(smem + C::kStages * C::kRawElems * sizeof(T));
  float* vp = kp + kKeys * C::kKRow;
  uint32_t* qs = reinterpret_cast<uint32_t*>(vp + kKeys / 2 * C::kVRow) +
                 (threadIdx.x >> 5) * C::kQWords;  // kQSmem: this warp's q halves

  const int row_tiles = (L + C::kRows - 1) / C::kRows;
  const int bh = blockIdx.x / row_tiles;
  const int h = bh % H;
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int g = lane >> 2, tq = lane & 3;
  const int wrow0 = (blockIdx.x - bh * row_tiles) * C::kRows + warp * C::kWarpRows;
  const int base = bh * L;  // the head's first row
  const Window win = window_of(offsets[bh / H], W, L);  // attention_window.cuh
  const int n_tiles = (L + kKeys - 1) / kKeys;

  // What is read in place of D = 4's missing dims, written once: f32 V's
  // planes at dims 4-7 hold a ones column (dim 4: hi 1, lo 0), so that p.v
  // sums each row's exps into output column 4 on the tensor cores, then
  // zeros; bf16's staged rows zeros at dims 4-7 (bf16 sums the exps in f32
  // on the CUDA cores, unrounded, for the lse).
  if constexpr (D == 4) {
    if constexpr (kF32) {
      for (int i = threadIdx.x; i < kKeys / 2 * 16; i += kThreads) {
        vp[(i >> 4) * C::kVRow + 16 + (i & 15)] = (i & 15) < 2 ? 1.f : 0.f;
      }
    } else {
      for (int i = threadIdx.x; i < C::kStages * 2 * kKeys; i += kThreads) {
        reinterpret_cast<uint2*>(ring + i * 8)[1] = make_uint2(0u, 0u);
      }
    }
  }

  // q's A fragments, rows r0 = wrow0 + 16 mf + g and r1 = r0 + 8. f32: split
  // into hi and lo (D = 4: a0 (r0, t), a1 (r1, t); past it k-steps of 8);
  // bf16: pairs (D = 4: k = 4-7 zero; past it k-steps of 16).
  uint32_t qh[kMF][kKS][4], ql[kMF][kF32 ? kKS : 1][4];
#pragma unroll
  for (int mf = 0; mf < kMF; ++mf) {
    const int r0 = wrow0 + 16 * mf + g;
    const bool ok[2] = {r0 < L, r0 + 8 < L};  // rows past L: q = 0, nothing stored
    const int at0 = (base + (ok[0] ? r0 : 0)) * D;
    const int at1 = (base + (ok[1] ? r0 + 8 : 0)) * D;
#pragma unroll
    for (int kk = 0; kk < kKS; ++kk) {
      if constexpr (kF32) {
        const float* q0 = reinterpret_cast<const float*>(q) + at0 + 8 * kk + tq;
        const float* q1 = reinterpret_cast<const float*>(q) + at1 + 8 * kk + tq;
        if constexpr (D == 4) {
          split_tf32(ok[0] ? q0[0] : 0.f, qh[mf][kk][0], ql[mf][kk][0]);
          split_tf32(ok[1] ? q1[0] : 0.f, qh[mf][kk][1], ql[mf][kk][1]);
        } else {
          const float x[4] = {ok[0] ? q0[0] : 0.f, ok[1] ? q1[0] : 0.f,
                              ok[0] ? q0[4] : 0.f, ok[1] ? q1[4] : 0.f};
#pragma unroll
          for (int i = 0; i < 4; ++i) split_tf32(x[i], qh[mf][kk][i], ql[mf][kk][i]);
          if constexpr (C::kQSmem) {  // [k-step][mf][hi, lo][lane][4]: 16 bytes a lane
            uint32_t* w = qs + ((kk * kMF + mf) * 2 * 32 + lane) * 4;
            *reinterpret_cast<uint4*>(w) =
                make_uint4(qh[mf][kk][0], qh[mf][kk][1], qh[mf][kk][2], qh[mf][kk][3]);
            *reinterpret_cast<uint4*>(w + 32 * 4) =
                make_uint4(ql[mf][kk][0], ql[mf][kk][1], ql[mf][kk][2], ql[mf][kk][3]);
          }
        }
      } else {
        const uint32_t* q0 = reinterpret_cast<const uint32_t*>(q + at0 + 16 * kk) + tq;
        const uint32_t* q1 = reinterpret_cast<const uint32_t*>(q + at1 + 16 * kk) + tq;
        if constexpr (D == 4) {
          qh[mf][kk][0] = ok[0] && tq < 2 ? q0[0] : 0u;
          qh[mf][kk][1] = ok[1] && tq < 2 ? q1[0] : 0u;
        } else {
          qh[mf][kk][0] = ok[0] ? q0[0] : 0u;
          qh[mf][kk][1] = ok[1] ? q1[0] : 0u;
          qh[mf][kk][2] = ok[0] ? q0[4] : 0u;
          qh[mf][kk][3] = ok[1] ? q1[4] : 0u;
        }
      }
    }
  }

  float acc[kMF][kNV][4];
  float ms[kMF][2], sum[kMF][2];  // running maxima times log2(e); partial row sums
#pragma unroll
  for (int mf = 0; mf < kMF; ++mf) {
#pragma unroll
    for (int n = 0; n < kNV; ++n) {
      acc[mf][n][0] = acc[mf][n][1] = acc[mf][n][2] = acc[mf][n][3] = 0.f;
    }
    ms[mf][0] = ms[mf][1] = __int_as_float(0xff800000);  // -inf
    sum[mf][0] = sum[mf][1] = 0.f;
  }

  // The ring: f32 fills every stage ahead (a stage is free once split);
  // bf16 keeps one stage for the tile in use.
  constexpr int kAhead = kF32 ? C::kStages : C::kStages - 1;
#pragma unroll
  for (int s = 0; s < kAhead; ++s) {
    if (s < n_tiles) {
      stage_kv<T, D>(ring + s * C::kRawElems, k, v, base, L, s);
    } else {
      asm volatile("cp.async.commit_group;\n" ::);
    }
  }

  for (int kt = 0; kt < n_tiles; ++kt) {
    asm volatile("cp.async.wait_group %0;\n" ::"n"(kAhead - 1));
    // Tile kt is in for every thread, and every warp is done with tile kt - 1.
    __syncthreads();
    const T* ks = ring + (kt % C::kStages) * C::kRawElems;  // tile kt as it landed
    const T* vs = ks + kKeys * C::kRawS;
    if constexpr (kF32) {
      split_kv<D>(reinterpret_cast<const float*>(ks), kp, vp);
      __syncthreads();  // the planes are in; the stage is free
      if (kt + C::kStages < n_tiles) {
        stage_kv<T, D>(ring + (kt % C::kStages) * C::kRawElems, k, v, base, L,
                       kt + C::kStages);
      } else {
        asm volatile("cp.async.commit_group;\n" ::);
      }
    } else {
      if (kt + kAhead < n_tiles) {
        stage_kv<T, D>(ring + ((kt + kAhead) % C::kStages) * C::kRawElems, k, v, base, L,
                       kt + kAhead);
      } else {
        asm volatile("cp.async.commit_group;\n" ::);
      }
    }
    const int key0 = kt * kKeys;

    // S = q.k^T, kMF strips of 16 x kKeys.
    float s[kMF][kNT][4];
#pragma unroll
    for (int j = 0; j < kNT; ++j) {
#pragma unroll
      for (int mf = 0; mf < kMF; ++mf) s[mf][j][0] = s[mf][j][1] = s[mf][j][2] = s[mf][j][3] = 0.f;
    }
    if constexpr (kF32 && D == 4) {
#pragma unroll
      for (int j = 0; j < kNT; ++j) {
        const float2 b = *reinterpret_cast<const float2*>(kp + (8 * j + g) * C::kKRow + 2 * tq);
        const uint32_t bh = __float_as_uint(b.x), bl = __float_as_uint(b.y);
#pragma unroll
        for (int mf = 0; mf < kMF; ++mf) {
          mma_tf32_k4(s[mf][j], ql[mf][0][0], ql[mf][0][1], bh);
          mma_tf32_k4(s[mf][j], qh[mf][0][0], qh[mf][0][1], bl);
          mma_tf32_k4(s[mf][j], qh[mf][0][0], qh[mf][0][1], bh);
        }
      }
    } else if constexpr (kF32) {
#pragma unroll
      for (int kk = 0; kk < kKS; ++kk) {
        uint32_t ah[kMF][4], al[kMF][4];  // q's fragments at k-step kk
#pragma unroll
        for (int mf = 0; mf < kMF; ++mf) {
          if constexpr (C::kQSmem) {
            const uint4* w = reinterpret_cast<const uint4*>(qs) + (kk * kMF + mf) * 2 * 32 + lane;
            const uint4 x = w[0], y = w[32];
            ah[mf][0] = x.x, ah[mf][1] = x.y, ah[mf][2] = x.z, ah[mf][3] = x.w;
            al[mf][0] = y.x, al[mf][1] = y.y, al[mf][2] = y.z, al[mf][3] = y.w;
          } else {
#pragma unroll
            for (int i = 0; i < 4; ++i) {
              ah[mf][i] = qh[mf][kk][i];
              al[mf][i] = ql[mf][kk][i];
            }
          }
        }
#pragma unroll
        for (int j = 0; j < kNT; ++j) {
          const uint4 b =
              *reinterpret_cast<const uint4*>(kp + (8 * j + g) * C::kKRow + 16 * kk + 4 * tq);
#pragma unroll
          for (int mf = 0; mf < kMF; ++mf) {
            float t[4] = {0.f, 0.f, 0.f, 0.f};  // this k-step's products, summed apart
            mma_tf32(t, al[mf], b.x, b.y);
            mma_tf32(t, ah[mf], b.z, b.w);
            mma_tf32(t, ah[mf], b.x, b.y);
#pragma unroll
            for (int i = 0; i < 4; ++i) s[mf][j][i] += t[i];
          }
        }
      }
    } else if constexpr (D == 4) {
#pragma unroll
      for (int j = 0; j < kNT; ++j) {
        const uint32_t b = reinterpret_cast<const uint32_t*>(ks + (8 * j + g) * C::kRawS)[tq];
#pragma unroll
        for (int mf = 0; mf < kMF; ++mf) mma_bf16_k8(s[mf][j], qh[mf][0][0], qh[mf][0][1], b);
      }
    } else {
#pragma unroll
      for (int j = 0; j < kNT; ++j) {
#pragma unroll
        for (int kk = 0; kk < kKS; ++kk) {
          const uint32_t* b =
              reinterpret_cast<const uint32_t*>(ks + (8 * j + g) * C::kRawS + 16 * kk) + tq;
          const uint32_t b0 = b[0], b1 = b[4];
#pragma unroll
          for (int mf = 0; mf < kMF; ++mf) mma_bf16(s[mf][j], qh[mf][kk], b0, b1);
        }
      }
    }

    // The bias, where the window meets the warp's rows and the tile's keys.
    if (win.meets(wrow0, C::kWarpRows, key0, kKeys)) {
#pragma unroll
      for (int mf = 0; mf < kMF; ++mf) {
        const int r0 = wrow0 + 16 * mf + g;
        const bool in0 = win.has(r0), in1 = win.has(r0 + 8);
        const T* b0 = toep + static_cast<size_t>(h * L + r0) * L;  // read where in0
        const T* b1 = b0 + 8 * static_cast<size_t>(L);              // where in1
#pragma unroll
        for (int j = 0; j < kNT; ++j) {
          const int m = key0 + 8 * j + 2 * tq;  // the key of c0 and c2; m + 1 of c1 and c3
          if (win.has(m)) {
            if (in0) s[mf][j][0] += to_float(b0[m]);
            if (in1) s[mf][j][2] += to_float(b1[m]);
          }
          if (win.has(m + 1)) {
            if (in0) s[mf][j][1] += to_float(b0[m + 1]);
            if (in1) s[mf][j][3] += to_float(b1[m + 1]);
          }
        }
      }
    }
    if (key0 + kKeys > L) {  // the last tile: keys past L to -inf
#pragma unroll
      for (int mf = 0; mf < kMF; ++mf) {
#pragma unroll
        for (int j = 0; j < kNT; ++j) {
          const int m = key0 + 8 * j + 2 * tq;
          if (m >= L) s[mf][j][0] = s[mf][j][2] = __int_as_float(0xff800000);
          if (m + 1 >= L) s[mf][j][1] = s[mf][j][3] = __int_as_float(0xff800000);
        }
      }
    }

    // The online softmax: the tile max across the quad, the scaled maxima,
    // the exps by one FFMA and ex2 each, the rescale of sums and outputs.
    float sc[kMF][2];
#pragma unroll
    for (int mf = 0; mf < kMF; ++mf) {
      float t0 = __int_as_float(0xff800000), t1 = t0;
#pragma unroll
      for (int j = 0; j < kNT; ++j) {
        t0 = fmaxf(t0, fmaxf(s[mf][j][0], s[mf][j][1]));
        t1 = fmaxf(t1, fmaxf(s[mf][j][2], s[mf][j][3]));
      }
#pragma unroll
      for (int x = 1; x <= 2; x <<= 1) {
        t0 = fmaxf(t0, __shfl_xor_sync(0xffffffffu, t0, x));
        t1 = fmaxf(t1, __shfl_xor_sync(0xffffffffu, t1, x));
      }
      const float n0 = fmaxf(ms[mf][0], t0 * kLog2e), n1 = fmaxf(ms[mf][1], t1 * kLog2e);
      sc[mf][0] = ex2(ms[mf][0] - n0);  // 0 at the first tile, 1 where the max holds
      sc[mf][1] = ex2(ms[mf][1] - n1);
      ms[mf][0] = n0;
      ms[mf][1] = n1;
#pragma unroll
      for (int j = 0; j < kNT; ++j) {
        s[mf][j][0] = ex2(fmaf(s[mf][j][0], kLog2e, -n0));
        s[mf][j][1] = ex2(fmaf(s[mf][j][1], kLog2e, -n0));
        s[mf][j][2] = ex2(fmaf(s[mf][j][2], kLog2e, -n1));
        s[mf][j][3] = ex2(fmaf(s[mf][j][3], kLog2e, -n1));
      }
      if constexpr (!kOnes) {
        float a0 = 0.f, a1 = 0.f;
#pragma unroll
        for (int j = 0; j < kNT; ++j) {
          a0 += s[mf][j][0] + s[mf][j][1];
          a1 += s[mf][j][2] + s[mf][j][3];
        }
        sum[mf][0] = fmaf(sum[mf][0], sc[mf][0], a0);
        sum[mf][1] = fmaf(sum[mf][1], sc[mf][1], a1);
      }
    }

    // O = O * rescale + P.V.
    if constexpr (kF32) {
      // Each 64 keys' P.V in fresh fragments, added on the CUDA cores (the
      // first with the rescale, by one FMA). k-step j: A column t is key
      // 8j + 2t (c0, c2), column t + 4 key 8j + 2t + 1 (c1, c3); V's planes
      // hold the keys in that order. The hi.hi products go to fragments of
      // their own, apart from the two small ones, so that the chains of mma
      // that wait on the one before are half as long; not at D = 32, whose
      // two strips of 32 rows leave no registers for it (ptxas spilled).
      constexpr int kSets = kMF == 2 && kNV >= 4 ? 1 : 2;
      float pv[kSets][kMF][kNV][4];
      auto fold = [&](bool first) {
#pragma unroll
        for (int mf = 0; mf < kMF; ++mf) {
#pragma unroll
          for (int n = 0; n < kNV; ++n) {
#pragma unroll
            for (int i = 0; i < 4; ++i) {
              float x = pv[0][mf][n][i];
#pragma unroll
              for (int u = 1; u < kSets; ++u) x += pv[u][mf][n][i];
              acc[mf][n][i] = first ? fmaf(acc[mf][n][i], sc[mf][i >> 1], x) : acc[mf][n][i] + x;
            }
          }
        }
      };
#pragma unroll
      for (int j = 0; j < kNT; ++j) {
        if (j % 8 == 0) {
          if (j > 0) fold(j == 8);
#pragma unroll
          for (int u = 0; u < kSets; ++u) {
#pragma unroll
            for (int mf = 0; mf < kMF; ++mf) {
#pragma unroll
              for (int n = 0; n < kNV; ++n) {
                pv[u][mf][n][0] = pv[u][mf][n][1] = pv[u][mf][n][2] = pv[u][mf][n][3] = 0.f;
              }
            }
          }
        }
        constexpr int big = 0, small = kSets - 1;
        uint32_t ph[kMF][4], pl[kMF][4];
#pragma unroll
        for (int mf = 0; mf < kMF; ++mf) {
          split_p(s[mf][j][0], ph[mf][0], pl[mf][0]);
          split_p(s[mf][j][2], ph[mf][1], pl[mf][1]);
          split_p(s[mf][j][1], ph[mf][2], pl[mf][2]);
          split_p(s[mf][j][3], ph[mf][3], pl[mf][3]);
        }
#pragma unroll
        for (int n = 0; n < kNV; ++n) {
          const uint4 b =
              *reinterpret_cast<const uint4*>(vp + (4 * j + tq) * C::kVRow + (8 * n + g) * 4);
#pragma unroll
          for (int mf = 0; mf < kMF; ++mf) {
            mma_tf32(pv[small][mf][n], pl[mf], b.x, b.y);
            mma_tf32(pv[small][mf][n], ph[mf], b.z, b.w);
            mma_tf32(pv[big][mf][n], ph[mf], b.x, b.y);
          }
        }
      }
      fold(kNT <= 8);
    } else {
#pragma unroll
      for (int mf = 0; mf < kMF; ++mf) {
#pragma unroll
        for (int n = 0; n < kNV; ++n) {
#pragma unroll
          for (int i = 0; i < 4; ++i) acc[mf][n][i] *= sc[mf][i >> 1];
        }
      }
      // k-step jj: keys 16jj .. 16jj + 15, the C pairs of n-tiles 2jj and
      // 2jj + 1 rounded to bf16 (P's A fragment); V's B fragments by
      // ldmatrix.trans: at D = 4 one call a 32 keys (rows of 8 values,
      // dims 4-7 zero; b[0], b[1] the first k-step, b[2], b[3] the second),
      // past it one a 16 keys and 16 dims.
      [[maybe_unused]] uint32_t bq[4];  // D = 4: the next k-step's V fragment
#pragma unroll
      for (int jj = 0; jj < kNT / 2; ++jj) {
        uint32_t pa[kMF][4];
#pragma unroll
        for (int mf = 0; mf < kMF; ++mf) {
          pa[mf][0] = bf16x2(s[mf][2 * jj][0], s[mf][2 * jj][1]);
          pa[mf][1] = bf16x2(s[mf][2 * jj][2], s[mf][2 * jj][3]);
          pa[mf][2] = bf16x2(s[mf][2 * jj + 1][0], s[mf][2 * jj + 1][1]);
          pa[mf][3] = bf16x2(s[mf][2 * jj + 1][2], s[mf][2 * jj + 1][3]);
        }
        if constexpr (D == 4) {
          if (jj % 2 == 0) ldmatrix_x4_trans(bq, vs + (16 * jj + lane) * C::kRawS);
#pragma unroll
          for (int mf = 0; mf < kMF; ++mf) {
            mma_bf16(acc[mf][0], pa[mf], bq[2 * (jj % 2)], bq[2 * (jj % 2) + 1]);
          }
        } else {
          const T* vrow = vs + (16 * jj + (lane & 15)) * C::kRawS + (lane >> 4) * 8;
#pragma unroll
          for (int n = 0; n < D / 16; ++n) {
            uint32_t b[4];
            ldmatrix_x4_trans(b, vrow + 16 * n);
#pragma unroll
            for (int mf = 0; mf < kMF; ++mf) {
              mma_bf16(acc[mf][2 * n], pa[mf], b[0], b[1]);
              mma_bf16(acc[mf][2 * n + 1], pa[mf], b[2], b[3]);
            }
          }
        }
      }
    }
  }

#pragma unroll
  for (int mf = 0; mf < kMF; ++mf) {
    float s0 = sum[mf][0], s1 = sum[mf][1];
    if constexpr (kOnes) {  // the row sums: p.v's output column 4, lane t = 2's
      s0 = __shfl_sync(0xffffffffu, acc[mf][0][0], (lane & ~3) | 2);
      s1 = __shfl_sync(0xffffffffu, acc[mf][0][2], (lane & ~3) | 2);
    } else {
#pragma unroll
      for (int x = 1; x <= 2; x <<= 1) {
        s0 += __shfl_xor_sync(0xffffffffu, s0, x);
        s1 += __shfl_xor_sync(0xffffffffu, s1, x);
      }
    }
    const float i0 = 1.f / s0, i1 = 1.f / s1;
    const int r0 = wrow0 + 16 * mf + g;
    const bool ok0 = r0 < L, ok1 = r0 + 8 < L;
    const int row0 = base + r0, row1 = row0 + 8;
#pragma unroll
    for (int n = 0; n < kNV; ++n) {
      const int d = 8 * n + 2 * tq;  // this lane's output dims d, d + 1
      if (d < D) {
        if (ok0) store2(o + row0 * D + d, acc[mf][n][0] * i0, acc[mf][n][1] * i0);
        if (ok1) store2(o + row1 * D + d, acc[mf][n][2] * i1, acc[mf][n][3] * i1);
      }
    }
    if (lse != nullptr && tq == 0) {
      if (ok0) lse[row0] = (ms[mf][0] + log2f(s0)) * kLn2;
      if (ok1) lse[row1] = (ms[mf][1] + log2f(s1)) * kLn2;
    }
  }
}

template <typename T, int D>
cudaError_t launch_d(const void* q, const void* k, const void* v, const void* toep,
                     const float* offsets, void* o, float* lse, int B, int H, int L, int W,
                     cudaStream_t stream) {
  using C = RposTile<T, D>;
  // Above 48 KB a block's dynamic shared memory must be allowed once per
  // instantiation.
  static const cudaError_t allowed =
      cudaFuncSetAttribute(attention_rpos_fwd_mma_kernel<T, D>,
                           cudaFuncAttributeMaxDynamicSharedMemorySize, C::kSmemBytes);
  if (allowed != cudaSuccess) return allowed;
  const long long blocks = static_cast<long long>(B) * H * ((L + C::kRows - 1) / C::kRows);
  if (blocks > 0x7fffffffLL) return cudaErrorInvalidValue;
  attention_rpos_fwd_mma_kernel<T, D>
      <<<static_cast<int>(blocks), kThreads, C::kSmemBytes, stream>>>(
          static_cast<const T*>(q), static_cast<const T*>(k), static_cast<const T*>(v),
          static_cast<const T*>(toep), offsets, static_cast<T*>(o), lse, H, L, W);
  return cudaGetLastError();
}

// The kernel at head dim D: 4, 8 (f32 only: bf16 takes 8 padded to 16), 16,
// 32 or 64; any other D is refused.
template <typename T>
cudaError_t launch(const void* q, const void* k, const void* v, const void* toep,
                   const float* offsets, void* o, float* lse, int B, int H, int L, int D, int W,
                   cudaStream_t stream) {
  switch (D) {
    case 4: return launch_d<T, 4>(q, k, v, toep, offsets, o, lse, B, H, L, W, stream);
    case 8:
      if constexpr (sizeof(T) == 4) {
        return launch_d<T, 8>(q, k, v, toep, offsets, o, lse, B, H, L, W, stream);
      }
      return cudaErrorInvalidValue;
    case 16: return launch_d<T, 16>(q, k, v, toep, offsets, o, lse, B, H, L, W, stream);
    case 32: return launch_d<T, 32>(q, k, v, toep, offsets, o, lse, B, H, L, W, stream);
    case 64: return launch_d<T, 64>(q, k, v, toep, offsets, o, lse, B, H, L, W, stream);
    default: return cudaErrorInvalidValue;
  }
}

}  // namespace rpos_fwd
}  // namespace
