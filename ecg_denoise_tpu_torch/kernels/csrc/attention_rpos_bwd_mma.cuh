// B4's window kernel: the backward of attention with a per-window R-peak
// bias, on Hopper's tensor cores (sm_90a), at head_dim 4 past 256 keys and
// at 8, 16, 32 and 64 (bf16: 4 past 256 keys, 16, 32 and 64), any L.
//
// Replaces the TPU kernel ecg_denoise_tpu/kernels/attention_pallas.py
// _bwd_rpos_kernel (:859, launched through _rpos_bwd_call :1037) at those
// shapes; attention_rpos_bwd.cu keeps its D = 4 kernel at L <= 256 and B2's
// wide passes (attention_bwd_mma.cuh, kWin) past D = 64. The function is
// that file's: for every (b, h), with the forward's row log-sum-exp lse and
// the incoming gradient g of the output o,
//   p[l,m]  = exp(q[l] . k[m] + bias_b[h,l,m] - lse[l])
//   c[l]    = sum_d g[l,d] * o[l,d]
//   ds[l,m] = p[l,m] * (g[l] . v[m] - c[l])
//   dq[l] = sum_m ds[l,m] k[m],  dk[m] = sum_l ds[l,m] q[l],  dv[m] = sum_l p[l,m] g[l]
// with bias_b[h,l,m] = toep[0,h,l,m] * in_b[l] * in_b[m] (the window
// compared in float32, attention_window.cuh); the dq pass also leaves each
// head's ds inside its element's window in the f32 (B, H, W', W') scratch
// that attention_rpos_dtoep_sum_kernel sums into dtoep, b in order.
//
// What bounds it. Per (b, h) 10 L^2 D flops of products (q.k^T, g.v^T and
// ds.k in the dq pass; k.q^T, v.g^T, p^T.g and ds^T.q in the dk/dv pass,
// which forms S and dP again rather than sum dq by atomics) and 2 L^2 exps,
// one a (row, key) in each pass. At D = 4 the exps bound it: at (L, H) =
// (1000, 2) and B = 256 they take 0.25 ms a call on the special-function
// units (16 a clock an SM), above the products at 3xTF32; at D = 32 the
// products do. So the design cuts the instructions a (row, key) pair costs
// beside its exp, as B3's window kernel does (attention_rpos_fwd_mma.cuh).
//
// The first version was B2's D >= 8 template switched into a window mode.
// It padded D = 4 to 8 (16 in bf16), so that half (three quarters) of its
// products were of zeros; it tested the window on every n-tile of every
// key tile, where the W x W window meets 3 % of the (row strip, key tile)
// pairs at (1000, 125); each warp split every staged K and V (Q and g)
// value into TF32 halves for itself, by two cvt.rna; and it spilled in 7
// of its 16 instantiations (the f32 D = 64 dk/dv pass 104 bytes).
//
// Design (mma.sync, two passes; no atomics, so a call gives bit-identical
// results every time):
// * dq pass: a block is 4 or 8 warps (kWarps) and owns 16 consecutive
//   query rows of one (b, h) a warp, whose q and g A fragments the warp
//   loads once (f32: split into TF32 halves) and whose c = g.o it sums (and
//   writes to the f32 (B, H, L) scratch for the dk/dv pass). K and V
//   stream through shared memory in tiles of kTile keys, a ring of cp.async
//   stages with the next tiles' copies in flight (keys past L
//   zero-filled). Per n-tile of 8 keys:
//   S = q.k^T and dP = g.v^T by mma, the bias where the window meets, p =
//   exp(S + bias - lse), ds = p (dP - c), the windowed ds to the scratch,
//   and dq += ds.K, ds's C fragment fed to the A fragment of the product by
//   B3's permutation (A column t is key 2t, column t + 4 key 2t + 1).
// * dk/dv pass, its transpose: a warp holds 16 keys' k and v A fragments
//   and streams q, g and the rows' lse and c in tiles of kTile query rows:
//   S^T = k.q^T, dP^T = v.g^T, p^T, ds^T, dv += p^T.g and dk += ds^T.q.
//   Query rows past L arrive as zeros (q, g, lse and c), so their p^T is 1
//   and their products with g = 0 and ds^T = 0 add exactly nothing.
// * f32: after a tile lands, the block splits each value once into TF32 hi
//   and lo (B5's split: hi by its bits, lo = x - hi whole) into shared
//   planes that every warp reads with one 8- or 16-byte load a fragment,
//   bank conflict-free: the rows' plane for the B operand of q.k^T-shaped
//   products, [row][k-step][t][hi(t), hi(t + 4), lo(t), lo(t + 4)] (D = 4:
//   [row][dim][hi, lo]), and the pairs' plane for the B operand of the
//   products with ds or p, [row pair p][dim][hi(2p), hi(2p + 1), lo(2p),
//   lo(2p + 1)] (P's key order). The dq pass splits K's rows and pairs and
//   V's rows, the dk/dv pass q's and g's rows and pairs.
// * D = 4 unpadded: f32's S-shaped products on mma.m16n8k4 TF32, bf16's on
//   m16n8k8 with the A fragments' dims 4-7 zero and the staged rows padded
//   with zeros to 8; the products with ds or p take an 8-wide n-tile whose
//   dims 4-7 are zeros in the planes (f32) or the staged rows (bf16, read
//   by ldmatrix.trans). bf16 rounds ds and p to bf16 for those products, as
//   JAX's kernel does, and every S-shaped product is exact (bf16 operands).
// * The window is tested once a (warp, tile): Window::meets on the warp's
//   16 rows and the tile's rows, warp-uniform. A tile that does not meet it
//   runs no bias and no scratch code at all; one that does adds toep[h, l,
//   m] where row and key are both inside (a predicated load from global
//   memory, where the batch finds toep in L2) and writes ds there.
// * Each exp is one FFMA and ex2.approx on lse pre-scaled by log2(e).
// * f32 sums each k-step's S-shaped products and each tile's products with
//   ds or p (past D = 16 each 8 rows') in fresh fragments and adds them on
//   the CUDA cores: the tensor core's f32 sums do not round to nearest
//   (attention_fwd_mma.cuh). Past D = 8 a chunk of n-tiles is formed at a
//   time, and at D = 64 the A halves a warp holds wait in shared memory
//   (the dq pass's q and g, the dk/dv pass's k and v), one 16-byte load a
//   k-step, and its tiles are 16 rows, so that no instantiation spills
//   (chip_smoke.py phase 31 fails a run where one does).

#pragma once

#include <cuda_bf16.h>
#include <cuda_runtime.h>

#include <cstdint>

#include "attention_bwd_mma.cuh"
#include "attention_rpos_fwd_mma.cuh"
#include "attention_window.cuh"

namespace {
namespace rpos_bwd {

using mma_fwd::bf16x2;
using mma_fwd::ldmatrix_x4_trans;
using mma_fwd::mma_bf16;
using mma_fwd::mma_tf32;
using mma_fwd::store2;
using mma_fwd::to_float;
using rpos_fwd::cp_async;
using rpos_fwd::ex2;
using rpos_fwd::kLog2e;
using rpos_fwd::mma_bf16_k8;
using rpos_fwd::mma_tf32_k4;
using rpos_fwd::split4;
using rpos_fwd::split_p;
using rpos_fwd::split_tf32;
using rpos_fwd::store4;

// The tiling and shared memory of one pass (kDq: the dq pass, else the
// dk/dv pass) at one instantiation.
template <typename T, int D, bool kDq>
struct BwdTile {
  static constexpr bool kF32 = sizeof(T) == 4;
  // Warps a block: 8 at f32 D = 4, 32 and 64, where they share the split
  // of each tile and measured faster than 4 on an H100 (trial builds,
  // PERF.md); 4 elsewhere, where 8 were level or slower.
  static constexpr int kWarps = kF32 && (D == 4 || D == 32 || D == 64) ? 8 : 4;
  static constexpr int kThreads = 32 * kWarps;
  static constexpr int kRows = 16 * kWarps;  // a block's own rows: query rows (dq) or keys (dk/dv)
  static constexpr int kDn = D < 8 ? 8 : D;  // the outputs' n-dims (D = 4: 4 of zeros)
  // Rows a streamed tile (keys, or query rows): 64, and at f32 D = 64 16,
  // whose warps' A halves take 16 KB of shared memory each.
  static constexpr int kTile = !kF32 || D <= 32 ? 64 : 16;
  static constexpr int kNT = kTile / 8;  // n-tiles of S a tile
  // n-tiles of S formed at once: all (bf16 needs pairs of them) but at f32
  // D = 16 and 32, whose A fragments fill the registers; at f32 D = 64 a
  // tile's two, each k-step's A halves loaded from shared memory once.
  static constexpr int kNJ = !kF32 || D <= 8 || D == 64 ? kNT : D == 16 ? 4 : 1;
  // f32 sums the products with ds or p of each 8 rows of a tile in a fresh
  // fragment and adds it at once past D = 16 (a tile's fragments would
  // fill the registers), else each tile's.
  static constexpr bool kAddEach = kF32 && D >= 32;
  static constexpr int kStages = kF32 && D == 64 ? 1 : 2;
  // __launch_bounds__'s blocks an SM: f32 D = 32 one, under which ptxas
  // gives the k-steps' loads and products the registers to overlap (faster
  // there than its default on an H100, PERF.md); elsewhere none asked (0),
  // its default, which was as fast or faster.
  static constexpr int kMinBlocks = kF32 && D == 32 ? 1 : 0;
  // f32 D = 64: the A operands' halves (the dq pass's q and g, the dk/dv
  // pass's k and v) wait in shared memory, read a k-step at a time by a
  // loop that is not unrolled: held in registers, or read in an unrolled
  // loop, they made ptxas spill.
  static constexpr int kASmem = kF32 && D == 64 ? 2 : 0;
  // A staged row's stride in elements: f32 dense (only the split reads
  // it); bf16 D + 8 (fragment loads and ldmatrix conflict-free), D = 4
  // padded to 8 with zeros.
  static constexpr int kRawS = kF32 ? D : D == 4 ? 8 : D + 8;
  static constexpr int kScal = kDq ? 0 : 2 * kTile;  // the dk/dv pass's lse and c a tile
  static constexpr int kRawBytes = 2 * kTile * kRawS * static_cast<int>(sizeof(T)) + kScal * 4;
  // f32 planes: a row's stride 16 mod 32 floats past D = 4, a pair's 8 mod
  // 32 (the 16-byte loads of 8 lanes fall in 32 banks).
  static constexpr int kRowS = D == 4 ? 8 : (2 * D) % 32 == 16 ? 2 * D : 2 * D + 16;
  static constexpr int kPairS = 4 * kDn + 8;
  static constexpr int kPlaneFloats =
      kF32 ? 2 * kTile * kRowS + (kDq ? 1 : 2) * (kTile / 2) * kPairS + kScal : 0;
  static constexpr int kAWords = kASmem * (D / 8) * 2 * 32 * 4;  // a warp's
  static constexpr int kSmemBytes = kStages * kRawBytes + (kPlaneFloats + kWarps * kAWords) * 4;
};

__device__ __forceinline__ void cp_async4(float* dst, const float* src, bool in) {
  const unsigned s = static_cast<unsigned>(__cvta_generic_to_shared(dst));
  asm volatile("cp.async.ca.shared.global [%0], [%1], 4, %2;\n" ::"r"(s), "l"(src),
               "r"(in ? 4 : 0));
}

// Stage tile t of two operands x, y of the block's head (its first row
// `base`) into the ring's buffer `buf`: x's rows, then y's, kRawS apart,
// rows past L zero-filled; the dk/dv pass's lse and c of the tile's rows
// after them (zeros past L). One commit group.
template <typename T, int D, bool kDq>
__device__ __forceinline__ void stage(unsigned char* buf, const T* __restrict__ x,
                                      const T* __restrict__ y, const float* __restrict__ lse,
                                      const float* __restrict__ c, int base, int L, int t) {
  using C = BwdTile<T, D, kDq>;
  constexpr int kBytes = D * sizeof(T) < 16 ? D * sizeof(T) : 16;
  constexpr int kPer = kBytes / sizeof(T);  // values a copy
  constexpr int kChunks = D / kPer;         // copies a row
  T* xs = reinterpret_cast<T*>(buf);
  T* ys = xs + C::kTile * C::kRawS;
  for (int i = threadIdx.x; i < C::kTile * kChunks; i += C::kThreads) {
    const int row = i / kChunks, ch = i - row * kChunks;
    const int r = t * C::kTile + row;
    const bool in = r < L;
    const int at = in ? (base + r) * D + ch * kPer : 0;  // q.numel() < 2^31 (the wrapper)
    cp_async<kBytes>(xs + row * C::kRawS + ch * kPer, x + at, in);
    cp_async<kBytes>(ys + row * C::kRawS + ch * kPer, y + at, in);
  }
  if constexpr (!kDq) {
    float* sc = reinterpret_cast<float*>(ys + C::kTile * C::kRawS);
    for (int i = threadIdx.x; i < 2 * C::kTile; i += C::kThreads) {
      const int r = t * C::kTile + (i < C::kTile ? i : i - C::kTile);
      const bool in = r < L;
      cp_async4(sc + i, (i < C::kTile ? lse : c) + (in ? base + r : 0), in);
    }
  }
  asm volatile("cp.async.commit_group;\n" ::);
}

// f32: one item of a landed tile's rows into the rows' plane: D = 4 a row
// ([dim][hi, lo]), past it 8 dims of a row ([k-step][t][hi(t), hi(t + 4),
// lo(t), lo(t + 4)]).
template <int D, int kRowS>
__device__ __forceinline__ void split_row(const float* raw, float* plane, int i) {
  uint32_t h[4], l[4];
  if constexpr (D == 4) {
    split4(*reinterpret_cast<const float4*>(raw + i * 4), h, l);
    store4(plane + i * kRowS, h[0], l[0], h[1], l[1]);
    store4(plane + i * kRowS + 4, h[2], l[2], h[3], l[3]);
  } else {
    const int row = i / (D / 8), kk = i - row * (D / 8);
    const float* x = raw + row * D + 8 * kk;
    uint32_t h2[4], l2[4];
    split4(*reinterpret_cast<const float4*>(x), h, l);
    split4(*reinterpret_cast<const float4*>(x + 4), h2, l2);
#pragma unroll
    for (int t = 0; t < 4; ++t) store4(plane + row * kRowS + 16 * kk + 4 * t, h[t], h2[t], l[t], l2[t]);
  }
}

// f32: one item of a landed tile's rows into the pairs' plane: rows 2p and
// 2p + 1 at dims 4c .. 4c + 3 ([dim][hi(2p), hi(2p + 1), lo(2p), lo(2p + 1)]).
template <int D, int kPairS>
__device__ __forceinline__ void split_pair(const float* raw, float* plane, int i) {
  const int p = i / (D / 4), c = i - p * (D / 4);
  uint32_t h[4], l[4], h2[4], l2[4];
  split4(*reinterpret_cast<const float4*>(raw + 2 * p * D + 4 * c), h, l);
  split4(*reinterpret_cast<const float4*>(raw + (2 * p + 1) * D + 4 * c), h2, l2);
#pragma unroll
  for (int u = 0; u < 4; ++u) store4(plane + p * kPairS + (4 * c + u) * 4, h[u], h2[u], l[u], l2[u]);
}

// f32: split a landed tile of x and y into the planes, each value once:
// x's and y's rows, x's pairs and (dk/dv pass) y's pairs, then the dk/dv
// pass's -lse * log2(e) and c of the tile's rows.
template <int D, bool kDq>
__device__ __forceinline__ void split_tile(const unsigned char* buf, float* planes) {
  using C = BwdTile<float, D, kDq>;
  constexpr int kRowItems = D == 4 ? C::kTile : C::kTile * D / 8;
  constexpr int kPairItems = C::kTile / 2 * (D / 4);
  constexpr int kItems = 2 * kRowItems + (kDq ? 1 : 2) * kPairItems;
  const float* xs = reinterpret_cast<const float*>(buf);
  const float* ys = xs + C::kTile * D;
  float* xr = planes;
  float* yr = xr + C::kTile * C::kRowS;
  float* xp = yr + C::kTile * C::kRowS;
  float* yp = xp + C::kTile / 2 * C::kPairS;
  for (int i = threadIdx.x; i < kItems; i += C::kThreads) {
    if (i < kRowItems) {
      split_row<D, C::kRowS>(xs, xr, i);
    } else if (i < 2 * kRowItems) {
      split_row<D, C::kRowS>(ys, yr, i - kRowItems);
    } else if (i < 2 * kRowItems + kPairItems) {
      split_pair<D, C::kPairS>(xs, xp, i - 2 * kRowItems);
    } else {
      split_pair<D, C::kPairS>(ys, yp, i - 2 * kRowItems - kPairItems);
    }
  }
  if constexpr (!kDq) {
    const float* raw = ys + C::kTile * D;
    float* sc = yp + C::kTile / 2 * C::kPairS;
    for (int i = threadIdx.x; i < 2 * C::kTile; i += C::kThreads) {
      sc[i] = i < C::kTile ? -raw[i] * kLog2e : raw[i];
    }
  }
}

// D = 4: what is read in place of the missing dims 4-7, written once: f32
// zeros at those dims of the pairs' planes (`n_pairs` of them, from
// `pairs`), bf16 zeros at dims 4-7 of every staged row.
template <typename T, int D, bool kDq>
__device__ __forceinline__ void zero_pads(unsigned char* ring, float* pairs, int n_pairs) {
  using C = BwdTile<T, D, kDq>;
  if constexpr (sizeof(T) == 4) {
    for (int i = threadIdx.x; i < n_pairs * (C::kTile / 2) * 16; i += C::kThreads) {
      const int p = i >> 4;  // a row of some pairs' plane: they lie back to back
      pairs[p * C::kPairS + 16 + (i & 15)] = 0.f;
    }
  } else {
    for (int i = threadIdx.x; i < C::kStages * 2 * C::kTile; i += C::kThreads) {
      const int s = i / (2 * C::kTile), row = i - s * 2 * C::kTile;
      T* r = reinterpret_cast<T*>(ring + s * C::kRawBytes) + row * 8;
      reinterpret_cast<uint2*>(r)[1] = make_uint2(0u, 0u);
    }
  }
}

// The A fragments of rows r0 and r0 + 8 of x (their first elements at0,
// at1; zeros where not ok) at k-step kk. f32: TF32 halves, D = 4 a0 (r0,
// t), a1 (r0 + 8, t) (m16n8k4), past it m16n8k8's four. bf16: pairs, D = 4
// m16n8k8's a0, a1 with dims 4-7 zero, past it m16n8k16's four.
template <typename T, int D>
__device__ __forceinline__ void load_a(const T* __restrict__ x, int at0, int at1, bool ok0,
                                       bool ok1, int kk, int tq, uint32_t (&hi)[4],
                                       uint32_t (&lo)[4]) {
  if constexpr (sizeof(T) == 4) {
    const float* x0 = reinterpret_cast<const float*>(x) + at0 + 8 * kk + tq;
    const float* x1 = reinterpret_cast<const float*>(x) + at1 + 8 * kk + tq;
    const float v[4] = {ok0 ? x0[0] : 0.f, ok1 ? x1[0] : 0.f,
                        D > 4 && ok0 ? x0[D > 4 ? 4 : 0] : 0.f,
                        D > 4 && ok1 ? x1[D > 4 ? 4 : 0] : 0.f};
#pragma unroll
    for (int i = 0; i < 4; ++i) split_tf32(v[i], hi[i], lo[i]);
  } else {
    const uint32_t* x0 = reinterpret_cast<const uint32_t*>(x + at0 + 16 * kk) + tq;
    const uint32_t* x1 = reinterpret_cast<const uint32_t*>(x + at1 + 16 * kk) + tq;
    if constexpr (D == 4) {
      hi[0] = ok0 && tq < 2 ? x0[0] : 0u;
      hi[1] = ok1 && tq < 2 ? x1[0] : 0u;
      hi[2] = hi[3] = 0u;
    } else {
      hi[0] = ok0 ? x0[0] : 0u;
      hi[1] = ok1 ? x1[0] : 0u;
      hi[2] = ok0 ? x0[4] : 0u;
      hi[3] = ok1 ? x1[4] : 0u;
    }
    lo[0] = lo[1] = lo[2] = lo[3] = 0u;
  }
}

// kASmem: a warp's A halves in shared memory, [operand][k-step][hi,
// lo][lane][4], one 16-byte load a lane each; the warp writes and reads
// only its own.
template <int D>
__device__ __forceinline__ void put_a(uint32_t* w, int op, int kk, int lane,
                                      const uint32_t (&hi)[4], const uint32_t (&lo)[4]) {
  uint32_t* p = w + ((op * (D / 8) + kk) * 2 * 32 + lane) * 4;
  *reinterpret_cast<uint4*>(p) = make_uint4(hi[0], hi[1], hi[2], hi[3]);
  *reinterpret_cast<uint4*>(p + 32 * 4) = make_uint4(lo[0], lo[1], lo[2], lo[3]);
}

template <int D>
__device__ __forceinline__ void get_a(const uint32_t* w, int op, int kk, int lane,
                                      uint32_t (&hi)[4], uint32_t (&lo)[4]) {
  const uint32_t* p = w + ((op * (D / 8) + kk) * 2 * 32 + lane) * 4;
  const uint4 x = *reinterpret_cast<const uint4*>(p);
  const uint4 y = *reinterpret_cast<const uint4*>(p + 32 * 4);
  hi[0] = x.x, hi[1] = x.y, hi[2] = x.z, hi[3] = x.w;
  lo[0] = y.x, lo[1] = y.y, lo[2] = y.z, lo[3] = y.w;
}

// c[i] = a . (the tile's rows 8(jc + i) .. + 7)^T for kNJ n-tiles at k-step
// kk, on f32's rows plane (3xTF32, this k-step's products summed apart and
// added) or bf16's staged rows.
template <typename T, int D, int kNJ>
__device__ __forceinline__ void s_step(float (&c)[kNJ][4], const uint32_t (&ah)[4],
                                       const uint32_t (&al)[4], const float* rows,
                                       const T* raw, int jc, int kk, int gq, int tq) {
  using C = BwdTile<T, D, true>;  // kRowS and kRawS are the same in both passes
#pragma unroll
  for (int i = 0; i < kNJ; ++i) {
    const int j = jc + i;
    if constexpr (sizeof(T) == 4 && D == 4) {
      const float2 b = *reinterpret_cast<const float2*>(rows + (8 * j + gq) * C::kRowS + 2 * tq);
      const uint32_t bh = __float_as_uint(b.x), bl = __float_as_uint(b.y);
      mma_tf32_k4(c[i], al[0], al[1], bh);
      mma_tf32_k4(c[i], ah[0], ah[1], bl);
      mma_tf32_k4(c[i], ah[0], ah[1], bh);
    } else if constexpr (sizeof(T) == 4) {
      const uint4 b =
          *reinterpret_cast<const uint4*>(rows + (8 * j + gq) * C::kRowS + 16 * kk + 4 * tq);
      float t[4] = {0.f, 0.f, 0.f, 0.f};
      mma_tf32(t, al, b.x, b.y);
      mma_tf32(t, ah, b.z, b.w);
      mma_tf32(t, ah, b.x, b.y);
#pragma unroll
      for (int e = 0; e < 4; ++e) c[i][e] += t[e];
    } else if constexpr (D == 4) {
      const uint32_t b = reinterpret_cast<const uint32_t*>(raw + (8 * j + gq) * C::kRawS)[tq];
      mma_bf16_k8(c[i], ah[0], ah[1], b);
    } else {
      const uint32_t* b = reinterpret_cast<const uint32_t*>(raw + (8 * j + gq) * C::kRawS + 16 * kk) + tq;
      mma_bf16(c[i], ah, b[0], b[4]);
    }
  }
}

// f32: acc += P . Z over one 8-row k-step j: P the C fragment `p` of an
// S-shaped product (split by truncation; A column t is row 2t of the
// k-step, column t + 4 row 2t + 1), Z the tile's pairs plane. kAddEach:
// each n-tile's products in a fresh fragment, added to acc at once.
template <int kNV, int kPairS, bool kAddEach>
__device__ __forceinline__ void pv_step(float (&acc)[kNV][4], const float (&p)[4],
                                        const float* pairs, int j, int gq, int tq) {
  uint32_t ph[4], pl[4];
  split_p(p[0], ph[0], pl[0]);
  split_p(p[2], ph[1], pl[1]);
  split_p(p[1], ph[2], pl[2]);
  split_p(p[3], ph[3], pl[3]);
#pragma unroll
  for (int n = 0; n < kNV; ++n) {
    const uint4 b = *reinterpret_cast<const uint4*>(pairs + (4 * j + tq) * kPairS + (8 * n + gq) * 4);
    if constexpr (kAddEach) {
      float t[4] = {0.f, 0.f, 0.f, 0.f};
      mma_tf32(t, pl, b.x, b.y);
      mma_tf32(t, ph, b.z, b.w);
      mma_tf32(t, ph, b.x, b.y);
#pragma unroll
      for (int e = 0; e < 4; ++e) acc[n][e] += t[e];
    } else {
      mma_tf32(acc[n], pl, b.x, b.y);
      mma_tf32(acc[n], ph, b.z, b.w);
      mma_tf32(acc[n], ph, b.x, b.y);
    }
  }
}

// bf16: acc += P . Z over k-step kq (16 rows of the tile), P the C
// fragments p0, p1 of its two n-tiles rounded to bf16, Z the tile's staged
// rows by ldmatrix.trans: at D = 4 one call a 32 rows (kq even; zq keeps
// it for the odd kq), past it one a 16 rows and 16 dims.
template <int D, int kNV, int kRawS>
__device__ __forceinline__ void pv_bf16(float (&acc)[kNV][4], const float (&p0)[4],
                                        const float (&p1)[4], const __nv_bfloat16* z, int kq,
                                        int lane, uint32_t (&zq)[4]) {
  const uint32_t pa[4] = {bf16x2(p0[0], p0[1]), bf16x2(p0[2], p0[3]), bf16x2(p1[0], p1[1]),
                          bf16x2(p1[2], p1[3])};
  if constexpr (D == 4) {
    if (kq % 2 == 0) ldmatrix_x4_trans(zq, z + (16 * kq + lane) * kRawS);
    mma_bf16(acc[0], pa, zq[2 * (kq % 2)], zq[2 * (kq % 2) + 1]);
  } else {
    const __nv_bfloat16* row = z + (16 * kq + (lane & 15)) * kRawS + (lane >> 4) * 8;
#pragma unroll
    for (int n = 0; n < D / 16; ++n) {
      uint32_t b[4];
      ldmatrix_x4_trans(b, row + 16 * n);
      mma_bf16(acc[2 * n], pa, b[0], b[1]);
      mma_bf16(acc[2 * n + 1], pa, b[2], b[3]);
    }
  }
}

// Rows r0 and r0 + 8 of a (b, h) head's (L, D) result from C fragments,
// each value rounded once to T (D = 4: dims 4-7 not stored).
template <typename T, int D, int kNV>
__device__ __forceinline__ void store_rows(T* __restrict__ out, int row0, bool ok0, bool ok1,
                                           const float (&acc)[kNV][4], int tq) {
#pragma unroll
  for (int n = 0; n < kNV; ++n) {
    const int d = 8 * n + 2 * tq;
    if (d < D) {
      if (ok0) store2(out + row0 * D + d, acc[n][0], acc[n][1]);
      if (ok1) store2(out + (row0 + 8) * D + d, acc[n][2], acc[n][3]);
    }
  }
}

template <typename T, int D>
__global__ void __launch_bounds__((BwdTile<T, D, true>::kThreads),
                                  (BwdTile<T, D, true>::kMinBlocks))
attention_rpos_bwd_dq_mma_kernel(const T* __restrict__ q, const T* __restrict__ k,
                                 const T* __restrict__ v, const T* __restrict__ toep,
                                 const float* __restrict__ offsets, const T* __restrict__ g,
                                 const T* __restrict__ o, const float* __restrict__ lse,
                                 float* __restrict__ c, T* __restrict__ dq,
                                 float* __restrict__ ds, int H, int L, int W) {
  using C = BwdTile<T, D, true>;
  constexpr bool kF32 = C::kF32;
  constexpr int kKeys = C::kTile, kNT = C::kNT, kNJ = C::kNJ;
  constexpr int kKS = D == 4 ? 1 : kF32 ? D / 8 : D / 16;  // S's k-steps
  constexpr int kNV = C::kDn / 8;                          // dq's n-tiles
  constexpr bool kASm = C::kASmem > 0;
  extern __shared__ __align__(16) unsigned char smem[];
  float* planes = reinterpret_cast<float*>(smem + C::kStages * C::kRawBytes);
  const float* kr = planes;                 // f32: K's rows
  const float* vr = kr + kKeys * C::kRowS;  // V's rows
  const float* kp = vr + kKeys * C::kRowS;  // K's pairs
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31, gq = lane >> 2, tq = lane & 3;
  uint32_t* aw = reinterpret_cast<uint32_t*>(planes + C::kPlaneFloats) + warp * C::kAWords;

  const int row_tiles = (L + C::kRows - 1) / C::kRows;
  const int bh = blockIdx.x / row_tiles;
  const int h = bh % H;
  const int wrow0 = (blockIdx.x - bh * row_tiles) * C::kRows + warp * 16;
  const int r0 = wrow0 + gq, r1 = r0 + 8;
  const bool ok0 = r0 < L, ok1 = r1 < L;  // rows past L: q = g = 0, nothing stored
  const int base = bh * L;                // the head's first row
  const Window win = window_of(offsets[bh / H], W, L);  // attention_window.cuh
  const int n_tiles = (L + kKeys - 1) / kKeys;
  const int Wp = W < L ? W : L;
  if constexpr (D == 4) zero_pads<T, D, true>(smem, planes + 2 * kKeys * C::kRowS, 1);

  // c = g.o of both rows (dims tq, tq + 4, ... a lane, summed across the
  // quad), for the dk/dv pass too; -lse * log2(e).
  const int at0 = (base + (ok0 ? r0 : 0)) * D, at1 = (base + (ok1 ? r1 : 0)) * D;
  float c0 = 0.f, c1 = 0.f;
#pragma unroll
  for (int d = tq; d < D; d += 4) {
    if (ok0) c0 = fmaf(to_float(g[at0 + d]), to_float(o[at0 + d]), c0);
    if (ok1) c1 = fmaf(to_float(g[at1 + d]), to_float(o[at1 + d]), c1);
  }
#pragma unroll
  for (int x = 1; x <= 2; x <<= 1) {
    c0 += __shfl_xor_sync(0xffffffffu, c0, x);
    c1 += __shfl_xor_sync(0xffffffffu, c1, x);
  }
  if (tq == 0) {
    if (ok0) c[base + r0] = c0;
    if (ok1) c[base + r1] = c1;
  }
  const float nl0 = ok0 ? -lse[base + r0] * kLog2e : 0.f;
  const float nl1 = ok1 ? -lse[base + r1] * kLog2e : 0.f;

  // q's and g's A fragments (in shared memory at kASm).
  uint32_t qh[kASm ? 1 : kKS][4], ql[kASm ? 1 : kKS][4];
  uint32_t gh[kASm ? 1 : kKS][4], gl[kASm ? 1 : kKS][4];
#pragma unroll
  for (int kk = 0; kk < kKS; ++kk) {
    if constexpr (kASm) {
      uint32_t x[4], y[4];
      load_a<T, D>(q, at0, at1, ok0, ok1, kk, tq, x, y);
      put_a<D>(aw, 0, kk, lane, x, y);
      load_a<T, D>(g, at0, at1, ok0, ok1, kk, tq, x, y);
      put_a<D>(aw, 1, kk, lane, x, y);
    } else {
      load_a<T, D>(q, at0, at1, ok0, ok1, kk, tq, qh[kk], ql[kk]);
      load_a<T, D>(g, at0, at1, ok0, ok1, kk, tq, gh[kk], gl[kk]);
    }
  }

  float acc[kNV][4];
#pragma unroll
  for (int n = 0; n < kNV; ++n) acc[n][0] = acc[n][1] = acc[n][2] = acc[n][3] = 0.f;

  // The ring: f32 fills every stage ahead (a stage is free once split);
  // bf16 keeps one stage for the tile in use.
  constexpr int kAhead = kF32 ? C::kStages : C::kStages - 1;
#pragma unroll
  for (int s = 0; s < kAhead; ++s) {
    if (s < n_tiles) {
      stage<T, D, true>(smem + s * C::kRawBytes, k, v, nullptr, nullptr, base, L, s);
    } else {
      asm volatile("cp.async.commit_group;\n" ::);
    }
  }

  for (int kt = 0; kt < n_tiles; ++kt) {
    asm volatile("cp.async.wait_group %0;\n" ::"n"(kAhead - 1));
    // Tile kt is in for every thread, and every warp is done with tile kt - 1.
    __syncthreads();
    unsigned char* buf = smem + (kt % C::kStages) * C::kRawBytes;
    if constexpr (kF32) {
      split_tile<D, true>(buf, planes);
      __syncthreads();  // the planes are in; the stage is free
      if (kt + C::kStages < n_tiles) {
        stage<T, D, true>(buf, k, v, nullptr, nullptr, base, L, kt + C::kStages);
      } else {
        asm volatile("cp.async.commit_group;\n" ::);
      }
    } else {
      if (kt + kAhead < n_tiles) {
        stage<T, D, true>(smem + ((kt + kAhead) % C::kStages) * C::kRawBytes, k, v, nullptr,
                          nullptr, base, L, kt + kAhead);
      } else {
        asm volatile("cp.async.commit_group;\n" ::);
      }
    }
    const T* ks = reinterpret_cast<const T*>(buf);  // bf16: the tile as it landed
    const T* vs = ks + kKeys * C::kRawS;
    const int key0 = kt * kKeys;
    const bool meets = win.meets(wrow0, 16, key0, kKeys);  // warp-uniform
    constexpr int kPV = kF32 && !C::kAddEach ? kNV : 1;
    float pv[kPV][4];  // f32: this tile's ds.K, summed apart
#pragma unroll
    for (int n = 0; n < kPV; ++n) pv[n][0] = pv[n][1] = pv[n][2] = pv[n][3] = 0.f;
    [[maybe_unused]] uint32_t kq4[4];  // bf16 D = 4: K's fragments of 32 keys

#pragma unroll
    for (int jc = 0; jc < kNT; jc += kNJ) {
      float s[kNJ][4], dp[kNJ][4];
#pragma unroll
      for (int i = 0; i < kNJ; ++i) {
        s[i][0] = s[i][1] = s[i][2] = s[i][3] = 0.f;
        dp[i][0] = dp[i][1] = dp[i][2] = dp[i][3] = 0.f;
      }
      // S = q.k^T, dP = g.v^T.
      if constexpr (kASm) {
#pragma unroll 1
        for (int kk = 0; kk < kKS; ++kk) {
          uint32_t x[4], y[4];
          get_a<D>(aw, 0, kk, lane, x, y);
          s_step<T, D, kNJ>(s, x, y, kr, ks, jc, kk, gq, tq);
          get_a<D>(aw, 1, kk, lane, x, y);
          s_step<T, D, kNJ>(dp, x, y, vr, vs, jc, kk, gq, tq);
        }
      } else {
#pragma unroll
        for (int kk = 0; kk < kKS; ++kk) {
          s_step<T, D, kNJ>(s, qh[kk], ql[kk], kr, ks, jc, kk, gq, tq);
          s_step<T, D, kNJ>(dp, gh[kk], gl[kk], vr, vs, jc, kk, gq, tq);
        }
      }
      // The bias, where the window meets the warp's rows and the tile's keys.
      if (meets) {
        const bool in0 = win.has(r0), in1 = win.has(r1);
        const T* b0 = toep + static_cast<size_t>(h * L + r0) * L;  // read where in0
        const T* b1 = b0 + 8 * static_cast<size_t>(L);              // where in1
#pragma unroll
        for (int i = 0; i < kNJ; ++i) {
          const int m = key0 + 8 * (jc + i) + 2 * tq;  // the key of c0 and c2; m + 1 of c1, c3
          if (win.has(m)) {
            if (in0) s[i][0] += to_float(b0[m]);
            if (in1) s[i][2] += to_float(b1[m]);
          }
          if (win.has(m + 1)) {
            if (in0) s[i][1] += to_float(b0[m + 1]);
            if (in1) s[i][3] += to_float(b1[m + 1]);
          }
        }
      }
      if (key0 + kKeys > L) {  // the last tile: keys past L get p = 0
#pragma unroll
        for (int i = 0; i < kNJ; ++i) {
          const int m = key0 + 8 * (jc + i) + 2 * tq;
          if (m >= L) s[i][0] = s[i][2] = __int_as_float(0xff800000);
          if (m + 1 >= L) s[i][1] = s[i][3] = __int_as_float(0xff800000);
        }
      }
      // ds = p (dP - c), p = exp(S - lse) by one FFMA and ex2.
#pragma unroll
      for (int i = 0; i < kNJ; ++i) {
        s[i][0] = ex2(fmaf(s[i][0], kLog2e, nl0)) * (dp[i][0] - c0);
        s[i][1] = ex2(fmaf(s[i][1], kLog2e, nl0)) * (dp[i][1] - c0);
        s[i][2] = ex2(fmaf(s[i][2], kLog2e, nl1)) * (dp[i][2] - c1);
        s[i][3] = ex2(fmaf(s[i][3], kLog2e, nl1)) * (dp[i][3] - c1);
      }
      if (meets) {  // the windowed ds, for dtoep
#pragma unroll
        for (int i = 0; i < kNJ; ++i) {
          mma_bwd::store_window_ds(ds, win, bh, Wp, r0, ok0, ok1, key0 + 8 * (jc + i) + 2 * tq,
                                   s[i]);
        }
      }
      // dq += ds.K.
      if constexpr (kF32 && C::kAddEach) {
#pragma unroll
        for (int i = 0; i < kNJ; ++i) pv_step<kNV, C::kPairS, true>(acc, s[i], kp, jc + i, gq, tq);
      } else if constexpr (kF32) {
#pragma unroll
        for (int i = 0; i < kNJ; ++i) pv_step<kNV, C::kPairS, false>(pv, s[i], kp, jc + i, gq, tq);
      } else {
#pragma unroll
        for (int i = 0; i < kNJ; i += 2) {
          pv_bf16<D, kNV, C::kRawS>(acc, s[i], s[i + 1], ks, (jc + i) / 2, lane, kq4);
        }
      }
    }
    if constexpr (kF32 && !C::kAddEach) {
#pragma unroll
      for (int n = 0; n < kNV; ++n) {
#pragma unroll
        for (int e = 0; e < 4; ++e) acc[n][e] += pv[n][e];
      }
    }
  }
  store_rows<T, D, kNV>(dq, base + r0, ok0, ok1, acc, tq);
}

template <typename T, int D>
__global__ void __launch_bounds__((BwdTile<T, D, false>::kThreads),
                                  (BwdTile<T, D, false>::kMinBlocks))
attention_rpos_bwd_dkdv_mma_kernel(const T* __restrict__ q, const T* __restrict__ k,
                                   const T* __restrict__ v, const T* __restrict__ toep,
                                   const float* __restrict__ offsets, const T* __restrict__ g,
                                   const float* __restrict__ lse, const float* __restrict__ c,
                                   T* __restrict__ dk, T* __restrict__ dv, int H, int L, int W) {
  using C = BwdTile<T, D, false>;
  constexpr bool kF32 = C::kF32;
  constexpr int kQ = C::kTile, kNT = C::kNT, kNJ = C::kNJ;
  constexpr int kKS = D == 4 ? 1 : kF32 ? D / 8 : D / 16;  // S^T's k-steps
  constexpr int kNV = C::kDn / 8;                          // dk's and dv's n-tiles
  constexpr bool kKVSmem = C::kASmem > 0;
  extern __shared__ __align__(16) unsigned char smem[];
  float* planes = reinterpret_cast<float*>(smem + C::kStages * C::kRawBytes);
  const float* qr = planes;                          // f32: q's rows
  const float* gr = qr + kQ * C::kRowS;              // g's rows
  const float* qp = gr + kQ * C::kRowS;              // q's pairs
  const float* gp = qp + kQ / 2 * C::kPairS;         // g's pairs
  const float* scal = gp + kQ / 2 * C::kPairS;       // -lse * log2(e), then c
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31, gq = lane >> 2, tq = lane & 3;
  uint32_t* aw = reinterpret_cast<uint32_t*>(planes + C::kPlaneFloats) + warp * C::kAWords;

  const int row_tiles = (L + C::kRows - 1) / C::kRows;
  const int bh = blockIdx.x / row_tiles;
  const int h = bh % H;
  const int wkey0 = (blockIdx.x - bh * row_tiles) * C::kRows + warp * 16;
  const int m0 = wkey0 + gq, m1 = m0 + 8;  // this lane's keys
  const bool ok0 = m0 < L, ok1 = m1 < L;   // keys past L: k = v = 0, nothing stored
  const int base = bh * L;
  const Window win = window_of(offsets[bh / H], W, L);  // attention_window.cuh
  const int n_tiles = (L + kQ - 1) / kQ;
  if constexpr (D == 4) zero_pads<T, D, false>(smem, planes + 2 * kQ * C::kRowS, 2);

  // k's and v's A fragments (in shared memory at kKVSmem).
  const int at0 = (base + (ok0 ? m0 : 0)) * D, at1 = (base + (ok1 ? m1 : 0)) * D;
  uint32_t kh[kKVSmem ? 1 : kKS][4], kl[kKVSmem ? 1 : kKS][4];
  uint32_t vh[kKVSmem ? 1 : kKS][4], vl[kKVSmem ? 1 : kKS][4];
#pragma unroll
  for (int kk = 0; kk < kKS; ++kk) {
    if constexpr (kKVSmem) {
      uint32_t x[4], y[4];
      load_a<T, D>(k, at0, at1, ok0, ok1, kk, tq, x, y);
      put_a<D>(aw, 0, kk, lane, x, y);
      load_a<T, D>(v, at0, at1, ok0, ok1, kk, tq, x, y);
      put_a<D>(aw, 1, kk, lane, x, y);
    } else {
      load_a<T, D>(k, at0, at1, ok0, ok1, kk, tq, kh[kk], kl[kk]);
      load_a<T, D>(v, at0, at1, ok0, ok1, kk, tq, vh[kk], vl[kk]);
    }
  }

  float dka[kNV][4], dva[kNV][4];
#pragma unroll
  for (int n = 0; n < kNV; ++n) {
    dka[n][0] = dka[n][1] = dka[n][2] = dka[n][3] = 0.f;
    dva[n][0] = dva[n][1] = dva[n][2] = dva[n][3] = 0.f;
  }

  constexpr int kAhead = kF32 ? C::kStages : C::kStages - 1;
#pragma unroll
  for (int s = 0; s < kAhead; ++s) {
    if (s < n_tiles) {
      stage<T, D, false>(smem + s * C::kRawBytes, q, g, lse, c, base, L, s);
    } else {
      asm volatile("cp.async.commit_group;\n" ::);
    }
  }

  for (int lt = 0; lt < n_tiles; ++lt) {
    asm volatile("cp.async.wait_group %0;\n" ::"n"(kAhead - 1));
    __syncthreads();
    unsigned char* buf = smem + (lt % C::kStages) * C::kRawBytes;
    if constexpr (kF32) {
      split_tile<D, false>(buf, planes);
      __syncthreads();
      if (lt + C::kStages < n_tiles) {
        stage<T, D, false>(buf, q, g, lse, c, base, L, lt + C::kStages);
      } else {
        asm volatile("cp.async.commit_group;\n" ::);
      }
    } else {
      if (lt + kAhead < n_tiles) {
        stage<T, D, false>(smem + ((lt + kAhead) % C::kStages) * C::kRawBytes, q, g, lse, c,
                           base, L, lt + kAhead);
      } else {
        asm volatile("cp.async.commit_group;\n" ::);
      }
    }
    const T* qs = reinterpret_cast<const T*>(buf);  // bf16: the tile as it landed
    const T* gs = qs + kQ * C::kRawS;
    const float* raw_sc = reinterpret_cast<const float*>(gs + kQ * C::kRawS);  // lse, then c
    const int l0 = lt * kQ;
    const bool meets = win.meets(wkey0, 16, l0, kQ);  // warp-uniform
    constexpr int kPV = kF32 && !C::kAddEach ? kNV : 1;
    float pdk[kPV][4], pdv[kPV][4];  // f32: this tile's products, summed apart
#pragma unroll
    for (int n = 0; n < kPV; ++n) {
      pdk[n][0] = pdk[n][1] = pdk[n][2] = pdk[n][3] = 0.f;
      pdv[n][0] = pdv[n][1] = pdv[n][2] = pdv[n][3] = 0.f;
    }
    [[maybe_unused]] uint32_t gq4[4], qq4[4];  // bf16 D = 4: g's and q's fragments of 32 rows

#pragma unroll
    for (int jc = 0; jc < kNT; jc += kNJ) {
      float st[kNJ][4], dt[kNJ][4];  // S^T, dP^T: rows the warp's keys, columns the tile's rows
#pragma unroll
      for (int i = 0; i < kNJ; ++i) {
        st[i][0] = st[i][1] = st[i][2] = st[i][3] = 0.f;
        dt[i][0] = dt[i][1] = dt[i][2] = dt[i][3] = 0.f;
      }
      if constexpr (kKVSmem) {
#pragma unroll 1
        for (int kk = 0; kk < kKS; ++kk) {
          uint32_t x[4], y[4];
          get_a<D>(aw, 0, kk, lane, x, y);
          s_step<T, D, kNJ>(st, x, y, qr, qs, jc, kk, gq, tq);
          get_a<D>(aw, 1, kk, lane, x, y);
          s_step<T, D, kNJ>(dt, x, y, gr, gs, jc, kk, gq, tq);
        }
      } else {
#pragma unroll
        for (int kk = 0; kk < kKS; ++kk) {
          s_step<T, D, kNJ>(st, kh[kk], kl[kk], qr, qs, jc, kk, gq, tq);
          s_step<T, D, kNJ>(dt, vh[kk], vl[kk], gr, gs, jc, kk, gq, tq);
        }
      }
      // The bias toep[h, l, key], where the window meets the warp's keys and
      // the tile's rows.
      if (meets) {
        const bool in0 = win.has(m0), in1 = win.has(m1);
#pragma unroll
        for (int i = 0; i < kNJ; ++i) {
          const int l = l0 + 8 * (jc + i) + 2 * tq;  // the row of c0 and c2; l + 1 of c1, c3
          const T* t0 = toep + static_cast<size_t>(h * L + l) * L;  // read where l is inside
          if (win.has(l)) {
            if (in0) st[i][0] += to_float(t0[m0]);
            if (in1) st[i][2] += to_float(t0[m1]);
          }
          if (win.has(l + 1)) {
            if (in0) st[i][1] += to_float(t0[L + m0]);
            if (in1) st[i][3] += to_float(t0[L + m1]);
          }
        }
      }
      // p^T = exp(S^T - lse[l]) by one FFMA and ex2, ds^T = p^T (dP^T - c[l]).
#pragma unroll
      for (int i = 0; i < kNJ; ++i) {
        const int li = 8 * (jc + i) + 2 * tq;
        float2 nl, cc;
        if constexpr (kF32) {
          nl = *reinterpret_cast<const float2*>(scal + li);
          cc = *reinterpret_cast<const float2*>(scal + kQ + li);
        } else {
          const float2 x = *reinterpret_cast<const float2*>(raw_sc + li);
          nl = make_float2(-x.x * kLog2e, -x.y * kLog2e);
          cc = *reinterpret_cast<const float2*>(raw_sc + kQ + li);
        }
        st[i][0] = ex2(fmaf(st[i][0], kLog2e, nl.x));
        st[i][1] = ex2(fmaf(st[i][1], kLog2e, nl.y));
        st[i][2] = ex2(fmaf(st[i][2], kLog2e, nl.x));
        st[i][3] = ex2(fmaf(st[i][3], kLog2e, nl.y));
        dt[i][0] = st[i][0] * (dt[i][0] - cc.x);
        dt[i][1] = st[i][1] * (dt[i][1] - cc.y);
        dt[i][2] = st[i][2] * (dt[i][2] - cc.x);
        dt[i][3] = st[i][3] * (dt[i][3] - cc.y);
      }
      // dv += p^T.g, dk += ds^T.q.
      if constexpr (kF32 && C::kAddEach) {
#pragma unroll
        for (int i = 0; i < kNJ; ++i) {
          pv_step<kNV, C::kPairS, true>(dva, st[i], gp, jc + i, gq, tq);
          pv_step<kNV, C::kPairS, true>(dka, dt[i], qp, jc + i, gq, tq);
        }
      } else if constexpr (kF32) {
#pragma unroll
        for (int i = 0; i < kNJ; ++i) {
          pv_step<kNV, C::kPairS, false>(pdv, st[i], gp, jc + i, gq, tq);
          pv_step<kNV, C::kPairS, false>(pdk, dt[i], qp, jc + i, gq, tq);
        }
      } else {
#pragma unroll
        for (int i = 0; i < kNJ; i += 2) {
          pv_bf16<D, kNV, C::kRawS>(dva, st[i], st[i + 1], gs, (jc + i) / 2, lane, gq4);
          pv_bf16<D, kNV, C::kRawS>(dka, dt[i], dt[i + 1], qs, (jc + i) / 2, lane, qq4);
        }
      }
    }
    if constexpr (kF32 && !C::kAddEach) {
#pragma unroll
      for (int n = 0; n < kNV; ++n) {
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          dka[n][e] += pdk[n][e];
          dva[n][e] += pdv[n][e];
        }
      }
    }
  }
  store_rows<T, D, kNV>(dk, base + m0, ok0, ok1, dka, tq);
  store_rows<T, D, kNV>(dv, base + m0, ok0, ok1, dva, tq);
}

template <typename T, int D>
cudaError_t launch_d(const void* q, const void* k, const void* v, const void* toep,
                     const float* offsets, const void* g, const void* o, const float* lse,
                     float* c, void* dq, void* dk, void* dv, float* ds, int B, int H, int L,
                     int W, cudaStream_t stream) {
  using Q = BwdTile<T, D, true>;
  using K = BwdTile<T, D, false>;
  // Above 48 KB a block's dynamic shared memory must be allowed once per
  // instantiation.
  static const cudaError_t allowed_dq =
      cudaFuncSetAttribute(attention_rpos_bwd_dq_mma_kernel<T, D>,
                           cudaFuncAttributeMaxDynamicSharedMemorySize, Q::kSmemBytes);
  static const cudaError_t allowed_dkdv =
      cudaFuncSetAttribute(attention_rpos_bwd_dkdv_mma_kernel<T, D>,
                           cudaFuncAttributeMaxDynamicSharedMemorySize, K::kSmemBytes);
  if (allowed_dq != cudaSuccess) return allowed_dq;
  if (allowed_dkdv != cudaSuccess) return allowed_dkdv;
  const long long heads = static_cast<long long>(B) * H;
  const long long blocks_dq = heads * ((L + Q::kRows - 1) / Q::kRows);
  const long long blocks_dkdv = heads * ((L + K::kRows - 1) / K::kRows);
  if (blocks_dq > 0x7fffffffLL || blocks_dkdv > 0x7fffffffLL) return cudaErrorInvalidValue;
  const T* qt = static_cast<const T*>(q);
  const T* kt = static_cast<const T*>(k);
  const T* vt = static_cast<const T*>(v);
  const T* tt = static_cast<const T*>(toep);
  const T* gt = static_cast<const T*>(g);
  attention_rpos_bwd_dq_mma_kernel<T, D>
      <<<static_cast<int>(blocks_dq), Q::kThreads, Q::kSmemBytes, stream>>>(
          qt, kt, vt, tt, offsets, gt, static_cast<const T*>(o), lse, c, static_cast<T*>(dq), ds,
          H, L, W);
  const cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess) return err;
  attention_rpos_bwd_dkdv_mma_kernel<T, D>
      <<<static_cast<int>(blocks_dkdv), K::kThreads, K::kSmemBytes, stream>>>(
          qt, kt, vt, tt, offsets, gt, lse, c, static_cast<T*>(dk), static_cast<T*>(dv), H, L, W);
  return cudaGetLastError();
}

// The kernel's two passes at head dim D: 4, 8 (f32 only: bf16 takes 8
// padded to 16), 16, 32 or 64; any other D is refused. `ds` is the f32
// (B, H, W', W') scratch the dq pass fills, `c` the f32 (B, H, L) one.
template <typename T>
cudaError_t launch(const void* q, const void* k, const void* v, const void* toep,
                   const float* offsets, const void* g, const void* o, const float* lse,
                   float* c, void* dq, void* dk, void* dv, float* ds, int B, int H, int L, int D,
                   int W, cudaStream_t stream) {
  switch (D) {
    case 4:
      return launch_d<T, 4>(q, k, v, toep, offsets, g, o, lse, c, dq, dk, dv, ds, B, H, L, W,
                            stream);
    case 8:
      if constexpr (sizeof(T) == 4) {
        return launch_d<T, 8>(q, k, v, toep, offsets, g, o, lse, c, dq, dk, dv, ds, B, H, L, W,
                              stream);
      }
      return cudaErrorInvalidValue;
    case 16:
      return launch_d<T, 16>(q, k, v, toep, offsets, g, o, lse, c, dq, dk, dv, ds, B, H, L, W,
                             stream);
    case 32:
      return launch_d<T, 32>(q, k, v, toep, offsets, g, o, lse, c, dq, dk, dv, ds, B, H, L, W,
                             stream);
    case 64:
      return launch_d<T, 64>(q, k, v, toep, offsets, g, o, lse, c, dq, dk, dv, ds, B, H, L, W,
                             stream);
    default:
      return cudaErrorInvalidValue;
  }
}

}  // namespace rpos_bwd
}  // namespace
