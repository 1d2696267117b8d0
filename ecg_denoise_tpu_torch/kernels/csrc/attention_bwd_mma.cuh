// The tensor-core templates of the fused attention backward, for B2
// (attention_bwd.cu, no window) and B4 (attention_rpos_bwd.cu, kWin): the
// three passes on one template on D for head_dim 8, 16, 32 and 64, and the
// wide passes for every multiple of 64 past 64. Each source instantiates
// only its own mode, so B2's kernels compile in attention_bwd.cu and B4's
// in attention_rpos_bwd.cu, in parallel, and B2's are the same code with
// or without B4's beside them.
//
// The window mode (kWin, B4: replacing the TPU kernel
// ecg_denoise_tpu/kernels/attention_pallas.py _bwd_rpos_kernel (:859) at
// every head_dim and length but D = 4 at L <= 256). The bias is toep (1,
// H, L, L) times in_b[l] * in_b[m] (attention_window.cuh), formed where
// the dq and dk/dv passes recompute p, as attention_fwd_mma.cuh forms it;
// and the dbias pass becomes the dtoep pass,
//   dtoep[h,l,m] = sum_b ds[b,h,l,m] * in_b[l] * in_b[m],
// summed in f32 in b order by one lane each, with no atomics. A block of
// that pass owns a 64 x 64 (l, m) tile and walks only the elements whose
// window holds one of its rows and one of its keys (`next_element`): the
// others add exactly 0 there, so the pass's work follows the windows, not
// B. Its accumulation skips every (b, l, m) outside the window the same
// way. dtoep is written in f32; the caller casts it once to toep's dtype.

#pragma once

#include <cuda_bf16.h>
#include <cuda_runtime.h>

#include <cstdint>

#include "attention_window.cuh"

namespace {
namespace mma_bwd {

__device__ __forceinline__ float to_float(float x) { return x; }
__device__ __forceinline__ float to_float(__nv_bfloat16 x) { return __bfloat162float(x); }

// 16 bytes of bf16 as 8 f32 values, low first.
__device__ __forceinline__ void unpack(uint4 c, float (&out)[8]) {
  const uint32_t w[4] = {c.x, c.y, c.z, c.w};
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    out[2 * i] = __uint_as_float(w[i] << 16);
    out[2 * i + 1] = __uint_as_float(w[i] & 0xffff0000u);
  }
}

// Above 48 KB a block's dynamic shared memory must be allowed once per
// kernel instantiation.
template <typename K>
cudaError_t allow_smem(K kernel, int bytes) {
  return cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, bytes);
}

// ---------------------------------------------------------------------------
// head_dim 8, 16, 32 and 64: one template on D, on Hopper's tensor cores.
// Transformer1d's heads are 32 wide; the wrapper (kernels/attention.py)
// zero-pads any other D <= 64 to the next instantiated one, and a D = 4
// call past 256 keys to 8. The D = 4 kernels of attention_bwd.cu and
// attention_rpos_bwd.cu are left as they are, bit for bit.
//
// What bounds it. Per (b, h) the work is 10*L*L*D flops (the five
// products q.k^T, g.v^T, ds.k, ds^T.q and p^T.g) against 8*L*D operand
// elements. The first design ran them in f32 on the CUDA cores
// (67 TFLOP/s); here they run on the tensor cores at 3xTF32 (x = hi + lo,
// each rounded to TF32 by cvt.rna; a.b = a_lo.b_hi + a_hi.b_lo + a_hi.b_hi),
// three TF32 passes at 495 TFLOP/s, which hold the 1e-4 gradient bar (PR
// 5's probe: 2.6e-6 of max|exact| for a 256-deep dot). bf16 operands are
// widened to f32 as they land and are exact in TF32 (8 bits of mantissa
// in TF32's 10), so their lo parts are 0 and skipped: q.k^T and g.v^T take
// one pass, the products with p or ds two. No value is rounded to bf16
// before a product (p and ds stay f32); only dq, dk and dv are rounded,
// once, to the operand dtype. At (L, H, B) = (1000, 4, 32) that is 3 x 41
// GFLOP, 0.25 ms at 495 TFLOP/s, over its bytes: the operations bound it.
//
// Design (mma.sync, as B1 above; no atomics, so a call gives
// bit-identical results every time):
// * dq pass. A block is 4 warps, a warp 16 query rows of one (b, h); at
//   L <= 32 (16) a block packs 2 (4) heads, as B1 does. A warp loads its
//   rows' q and g fragments once (split hi / lo), takes c = g.o of each row
//   (a quarter of the dims a lane, summed across the quad; written to a
//   f32 (B, H, L) scratch for the later passes), then streams K and V in
//   tiles of 64 keys through a two-stage ring (cp.async for f32, rows
//   padded to D + 4 floats: the fragment loads fall in 32 banks). Per
//   32-key chunk: S = q.k^T and dP = g.v^T by mma, p = exp(S + bias - lse),
//   ds = p (dP - c), and dq += ds.k, the C fragments of ds fed to the A
//   fragments of the product by the permutation B1 uses for p.v (A column
//   t is key 2t, column t + 4 key 2t + 1; K's rows read in that order).
// * dk/dv pass, its transpose: a warp holds 16 keys' k and v fragments and
//   streams q, g and the rows' lse and c in tiles of 64 query rows:
//   S^T = k.q^T, dP^T = v.g^T, p^T and ds^T, dv += p^T.g, dk += ds^T.q.
// * dbias pass, only when dbias is asked for. A block owns one head and a
//   64 x 64 tile of (l, m), a warp 16 rows, and walks the batch in order,
//   b = 0 .. B - 1, K and V of its keys in the ring, q and g of its rows
//   as fragments: per element S, dP, p and ds as in the dq pass, summed
//   into the tile's f32 accumulators in b order, so each dbias element is
//   one lane's ordered sum.
// The bias (no model of the repo passes one at these head dims; B4's toep
// inside the window) is read from global memory, where the batch finds it
// in L2.

constexpr int kMmaWarps = 4;
constexpr int kMmaThreads = 32 * kMmaWarps;
constexpr int kTile = 64;  // rows of one staged tile, all heads of the block
constexpr int kChunkTiles = 4;  // 8-wide n-tiles of S and dP a lane holds at once

// The tiling of one call at length L, the same on host and device (B1's).
struct MmaTiling {
  int warps;      // warps a head: 1 (L <= 16), 2 (L <= 32), else 4
  int heads;      // (b, h) heads of a block: 4 / warps
  int rows;       // rows of a head a block owns, and of a staged tile: 16 * warps
  int tiles;      // row tiles of a head (1 where the block packs heads)
  __host__ __device__ explicit MmaTiling(int L) {
    warps = L <= 16 ? 1 : L <= 32 ? 2 : kMmaWarps;
    heads = kMmaWarps / warps;
    rows = 16 * warps;
    tiles = (L + rows - 1) / rows;
  }
};

template <int D>
__host__ __device__ constexpr int mma_stride() { return D + 4; }  // floats a staged row

// A ring of two stages of two (kTile x D + 4) f32 tiles; the dk/dv pass adds
// the tiles' lse and c.
template <int D>
__host__ __device__ constexpr int mma_smem_bytes(bool with_scalars) {
  return (2 * 2 * kTile * mma_stride<D>() + (with_scalars ? 2 * 2 * kTile : 0)) * 4;
}

__device__ __forceinline__ uint32_t tf32_rna(float x) {
  uint32_t r;
  asm("cvt.rna.tf32.f32 %0, %1;" : "=r"(r) : "f"(x));
  return r & 0xffffe000u;  // the TF32 value, its 13 dropped bits cleared
}

__device__ __forceinline__ void split_tf32(float x, uint32_t& hi, uint32_t& lo) {
  hi = tf32_rna(x);
  lo = tf32_rna(x - __uint_as_float(hi));
}

// Fragments of mma.m16n8k8 .tf32 (PTX ISA), g = lane / 4, t = lane % 4:
//   A: a0 (g, t), a1 (g+8, t), a2 (g, t+4), a3 (g+8, t+4); B: b0 (t, g), b1 (t+4, g)
//   C: c0 (g, 2t), c1 (g, 2t+1), c2 (g+8, 2t), c3 (g+8, 2t+1)
__device__ __forceinline__ void mma_tf32(float (&c)[4], const uint32_t (&a)[4], uint32_t b0,
                                         uint32_t b1) {
  asm volatile(
      "mma.sync.aligned.m16n8k8.row.col.f32.tf32.tf32.f32 "
      "{%0, %1, %2, %3}, {%4, %5, %6, %7}, {%8, %9}, {%0, %1, %2, %3};\n"
      : "+f"(c[0]), "+f"(c[1]), "+f"(c[2]), "+f"(c[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}

// A warp's 16 rows of one operand as A fragments, one per 8-dim k-step:
// hi and lo (lo unused where the operand is exact in TF32).
template <int D>
struct Frag {
  uint32_t hi[D / 8][4], lo[D / 8][4];
};

// Rows r0 and r0 + 8 of x (at element offset `row0`, zeros where not ok).
template <typename T, int D>
__device__ __forceinline__ void load_frag(Frag<D>& f, const T* __restrict__ x, size_t row0,
                                          bool ok0, bool ok1, int tq) {
  constexpr bool kExact = sizeof(T) == 2;
#pragma unroll
  for (int kk = 0; kk < D / 8; ++kk) {
    const T* p0 = x + row0 * D + 8 * kk + tq;
    const T* p1 = p0 + 8 * D;
    const float v[4] = {ok0 ? to_float(p0[0]) : 0.f, ok1 ? to_float(p1[0]) : 0.f,
                        ok0 ? to_float(p0[4]) : 0.f, ok1 ? to_float(p1[4]) : 0.f};
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      if constexpr (kExact) {
        f.hi[kk][i] = __float_as_uint(v[i]);
      } else {
        split_tf32(v[i], f.hi[kk][i], f.lo[kk][i]);
      }
    }
  }
}

// c += t, t one k-step's products summed by the tensor core in a fresh
// fragment: its f32 sum does not round to nearest, and fed the running sum
// over the k-steps of a long L its errors add up (B1 at L = 1000 erred 2e-5
// of its output that way; PERF.md). The running sums round on the
// CUDA cores.
__device__ __forceinline__ void add4(float (&c)[4], const float (&t)[4]) {
#pragma unroll
  for (int i = 0; i < 4; ++i) c[i] += t[i];
}

// c += a . (the staged row's D values)^T for one 8-wide n-tile: `row`
// points at the tile's row 8j + g, column t (B's b0 at dim 8kk + t, b1 at
// + 4). kExact: both operands exact in TF32, one pass.
template <int D, bool kExact>
__device__ __forceinline__ void strip_dot(float (&c)[4], const Frag<D>& a, const float* row) {
#pragma unroll
  for (int kk = 0; kk < D / 8; ++kk) {
    const float b0 = row[8 * kk], b1 = row[8 * kk + 4];
    float t[4] = {0.f, 0.f, 0.f, 0.f};
    if constexpr (kExact) {
      mma_tf32(t, a.hi[kk], __float_as_uint(b0), __float_as_uint(b1));
    } else {
      uint32_t h0, l0, h1, l1;
      split_tf32(b0, h0, l0);
      split_tf32(b1, h1, l1);
      mma_tf32(t, a.lo[kk], h0, h1);
      mma_tf32(t, a.hi[kk], l0, l1);
      mma_tf32(t, a.hi[kk], h0, h1);
    }
    add4(c, t);
  }
}

// acc += P . Z over one 8-key k-step: P is the C fragment `p` of an
// S-shaped product (f32, split here), Z the staged tile whose rows are the
// k-step's keys; `row` points at row 8j + 2t, column g. A column t takes
// key 2t and column t + 4 key 2t + 1, the pairs a lane holds, and Z's rows
// are read in the same order. kExactB: Z exact in TF32 (bf16 operands).
template <int D, bool kExactB>
__device__ __forceinline__ void strip_acc(float (&acc)[D / 8][4], const float (&p)[4],
                                          const float* row) {
  uint32_t ph[4], pl[4];
  split_tf32(p[0], ph[0], pl[0]);
  split_tf32(p[2], ph[1], pl[1]);
  split_tf32(p[1], ph[2], pl[2]);
  split_tf32(p[3], ph[3], pl[3]);
#pragma unroll
  for (int n = 0; n < D / 8; ++n) {
    const float b0 = row[8 * n], b1 = row[mma_stride<D>() + 8 * n];
    float t[4] = {0.f, 0.f, 0.f, 0.f};
    if constexpr (kExactB) {
      mma_tf32(t, pl, __float_as_uint(b0), __float_as_uint(b1));
      mma_tf32(t, ph, __float_as_uint(b0), __float_as_uint(b1));
    } else {
      uint32_t h0, l0, h1, l1;
      split_tf32(b0, h0, l0);
      split_tf32(b1, h1, l1);
      mma_tf32(t, pl, h0, h1);
      mma_tf32(t, ph, l0, l1);
      mma_tf32(t, ph, h0, h1);
    }
    add4(acc[n], t);
  }
}

__device__ __forceinline__ void cp_async16(void* dst, const void* src, bool in) {
  const unsigned s = static_cast<unsigned>(__cvta_generic_to_shared(dst));
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::"r"(s), "l"(src),
               "r"(in ? 16 : 0));
}

// Stage one tile of two operands x, y into the f32 tiles xs, ys (stride D
// + 4): `slots` heads of `rows` rows each, head head0 + s at rows
// [first, first + rows) of its (b, h); rows past L and heads past n_heads
// are zeros. f32 rows by cp.async (16-byte copies), bf16 rows converted as
// they land. The scalars (lse, c: dk/dv pass) go to ls, cs where given,
// lse +inf past L so that the row's p is 0.
template <typename T, int D>
__device__ __forceinline__ void stage_pair(float* xs, float* ys, const T* __restrict__ x,
                                           const T* __restrict__ y, int slots, int rows,
                                           long long head0, long long n_heads, int L, int first,
                                           const float* __restrict__ lse = nullptr,
                                           const float* __restrict__ c = nullptr,
                                           float* ls = nullptr, float* cs = nullptr) {
  constexpr int kS = mma_stride<D>();
  constexpr int kPer = 16 / sizeof(T);  // values a 16-byte load
  constexpr int kChunks = D / kPer;
  for (int i = threadIdx.x; i < slots * rows * kChunks; i += kMmaThreads) {
    const int row = i / kChunks, ch = i - row * kChunks;
    const int slot = row / rows, r = first + row - slot * rows;
    const long long bh = head0 + slot;
    const bool in = bh < n_heads && r < L;
    const size_t at = in ? (static_cast<size_t>(bh) * L + r) * D + ch * kPer : 0;
    float* dx = xs + row * kS + ch * kPer;
    float* dy = ys + row * kS + ch * kPer;
    if constexpr (sizeof(T) == 4) {
      cp_async16(dx, x + at, in);
      cp_async16(dy, y + at, in);
    } else {
      float vx[8], vy[8];
      unpack(in ? *reinterpret_cast<const uint4*>(x + at) : make_uint4(0, 0, 0, 0), vx);
      unpack(in ? *reinterpret_cast<const uint4*>(y + at) : make_uint4(0, 0, 0, 0), vy);
      reinterpret_cast<float4*>(dx)[0] = make_float4(vx[0], vx[1], vx[2], vx[3]);
      reinterpret_cast<float4*>(dx)[1] = make_float4(vx[4], vx[5], vx[6], vx[7]);
      reinterpret_cast<float4*>(dy)[0] = make_float4(vy[0], vy[1], vy[2], vy[3]);
      reinterpret_cast<float4*>(dy)[1] = make_float4(vy[4], vy[5], vy[6], vy[7]);
    }
  }
  if (ls != nullptr) {
    for (int row = threadIdx.x; row < slots * rows; row += kMmaThreads) {
      const int slot = row / rows, r = first + row - slot * rows;
      const long long bh = head0 + slot;
      const bool in = bh < n_heads && r < L;
      const size_t at = static_cast<size_t>(in ? bh : 0) * L + (in ? r : 0);
      ls[row] = in ? lse[at] : __int_as_float(0x7f800000);  // +inf: p = 0
      cs[row] = in ? c[at] : 0.f;
    }
  }
  asm volatile("cp.async.commit_group;\n" ::);
}

__device__ __forceinline__ void store2(float* p, float a, float b) {
  *reinterpret_cast<float2*>(p) = make_float2(a, b);
}

__device__ __forceinline__ void store2(__nv_bfloat16* p, float a, float b) {
  *reinterpret_cast<__nv_bfloat162*>(p) = __floats2bfloat162_rn(a, b);
}

// Rows r0, r0 + 8 of a (b, h) head's (L, D) result from C fragments, each
// value rounded once to T.
template <typename T, int D>
__device__ __forceinline__ void store_rows(T* __restrict__ out, size_t r0, bool ok0, bool ok1,
                                           const float (&acc)[D / 8][4], int tq) {
#pragma unroll
  for (int n = 0; n < D / 8; ++n) {
    if (ok0) store2(out + r0 * D + 8 * n + 2 * tq, acc[n][0], acc[n][1]);
    if (ok1) store2(out + (r0 + 8) * D + 8 * n + 2 * tq, acc[n][2], acc[n][3]);
  }
}

// Where a warp of the dq or dk/dv pass sits: its head, its rows r0 and
// r0 + 8 (lane g), and the head's element offset.
struct MmaRows {
  long long head0, bh;
  int slot, h, r0;
  bool ok0, ok1;
  size_t base;
  __device__ MmaRows(const MmaTiling& t, int H, long long n_heads, int L, int warp, int g) {
    head0 = static_cast<long long>(blockIdx.x / t.tiles) * t.heads;
    slot = warp / t.warps;
    bh = head0 + slot;
    const bool head_ok = bh < n_heads;
    h = static_cast<int>(bh % H);
    r0 = (blockIdx.x % t.tiles) * t.rows + (warp - slot * t.warps) * 16 + g;
    ok0 = head_ok && r0 < L;
    ok1 = head_ok && r0 + 8 < L;
    base = static_cast<size_t>(head_ok ? bh : 0) * L;
  }
};

// kWin (B4): `bias` is toep, and `offsets` and W give each batch element's
// window; B2 passes neither.
template <typename T, int D, bool kBias, bool kWin>
__global__ void __launch_bounds__(kMmaThreads)
attention_bwd_dq_mma_kernel(const T* __restrict__ q, const T* __restrict__ k,
                            const T* __restrict__ v, const T* __restrict__ bias,
                            const T* __restrict__ g, const T* __restrict__ o,
                            const float* __restrict__ lse, float* __restrict__ c,
                            T* __restrict__ dq, int B, int H, int L,
                            const float* __restrict__ offsets, int W) {
  constexpr bool kExact = sizeof(T) == 2;
  constexpr int kS = mma_stride<D>();
  extern __shared__ __align__(16) float ring[];  // [stage][K, V][kTile][kS]
  const MmaTiling t(L);
  const long long n_heads = static_cast<long long>(B) * H;
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31, gq = lane >> 2, tq = lane & 3;
  const MmaRows w(t, H, n_heads, L, warp, gq);
  const size_t row0 = w.base + w.r0;

  Frag<D> qf, gf;
  load_frag<T, D>(qf, q, row0, w.ok0, w.ok1, tq);
  load_frag<T, D>(gf, g, row0, w.ok0, w.ok1, tq);
  // c = g.o of both rows: dims tq, tq + 4, ... a lane, summed across the quad.
  float c0 = 0.f, c1 = 0.f;
#pragma unroll
  for (int d = tq; d < D; d += 4) {
    if (w.ok0) c0 = fmaf(to_float(g[row0 * D + d]), to_float(o[row0 * D + d]), c0);
    if (w.ok1) c1 = fmaf(to_float(g[(row0 + 8) * D + d]), to_float(o[(row0 + 8) * D + d]), c1);
  }
#pragma unroll
  for (int x = 1; x <= 2; x <<= 1) {
    c0 += __shfl_xor_sync(0xffffffffu, c0, x);
    c1 += __shfl_xor_sync(0xffffffffu, c1, x);
  }
  if (tq == 0) {
    if (w.ok0) c[row0] = c0;
    if (w.ok1) c[row0 + 8] = c1;
  }
  const float lse0 = w.ok0 ? lse[row0] : 0.f, lse1 = w.ok1 ? lse[row0 + 8] : 0.f;
  const T* brow0 = kBias ? bias + (static_cast<size_t>(w.h) * L + (w.ok0 ? w.r0 : 0)) * L : nullptr;
  const T* brow1 = kBias ? bias + (static_cast<size_t>(w.h) * L + (w.ok1 ? w.r0 + 8 : 0)) * L
                         : nullptr;
  if constexpr (kWin) {  // the window of the head's batch element
    if (lane == 0) {
      warp_windows<kMmaWarps>()[warp] =
          window_of(w.bh < n_heads ? offsets[static_cast<int>(w.bh) / H] : 0.f, W, L);
    }
  }

  float acc[D / 8][4];
#pragma unroll
  for (int n = 0; n < D / 8; ++n) acc[n][0] = acc[n][1] = acc[n][2] = acc[n][3] = 0.f;
  const int nj = t.rows / 8;  // n-tiles of a staged tile
  constexpr int kStage = 2 * kTile * kS;
  stage_pair<T, D>(ring, ring + kTile * kS, k, v, t.heads, t.rows, w.head0, n_heads, L, 0);
  for (int kt = 0; kt < t.tiles; ++kt) {
    asm volatile("cp.async.wait_group 0;\n" ::);
    __syncthreads();  // tile kt is in; every thread is done with tile kt - 1's buffer
    if (kt + 1 < t.tiles) {
      float* nb = ring + ((kt + 1) & 1) * kStage;
      stage_pair<T, D>(nb, nb + kTile * kS, k, v, t.heads, t.rows, w.head0, n_heads, L,
                       (kt + 1) * t.rows);
    }
    const float* ks = ring + (kt & 1) * kStage + w.slot * t.rows * kS;
    const float* vs = ks + kTile * kS;
    const int key0 = kt * t.rows;
    for (int jc = 0; jc < nj; jc += kChunkTiles) {
      float s[kChunkTiles][4], dp[kChunkTiles][4];
#pragma unroll
      for (int i = 0; i < kChunkTiles; ++i) {
        const int j = jc + i;
        if (j >= nj) break;
        s[i][0] = s[i][1] = s[i][2] = s[i][3] = 0.f;
        dp[i][0] = dp[i][1] = dp[i][2] = dp[i][3] = 0.f;
        strip_dot<D, kExact>(s[i], qf, ks + (8 * j + gq) * kS + tq);
        strip_dot<D, kExact>(dp[i], gf, vs + (8 * j + gq) * kS + tq);
        const int m = key0 + 8 * j + 2 * tq;  // key of c0, c2; m + 1 of c1, c3
        if constexpr (kBias) {
          // The rows that take a bias, and the keys: B2's in L; B4's
          // inside the window of the head's batch element.
          const Window win = bias_window<kWin, kMmaWarps, sizeof(T) == 4>(warp, L);
          const bool in0 = kWin ? w.ok0 && win.has(w.r0) : w.ok0;
          const bool in1 = kWin ? w.ok1 && win.has(w.r0 + 8) : w.ok1;
          if (in_bias<kWin>(win, m, L)) {
            s[i][0] += in0 ? to_float(brow0[m]) : 0.f;
            s[i][2] += in1 ? to_float(brow1[m]) : 0.f;
          }
          if (in_bias<kWin>(win, m + 1, L)) {
            s[i][1] += in0 ? to_float(brow0[m + 1]) : 0.f;
            s[i][3] += in1 ? to_float(brow1[m + 1]) : 0.f;
          }
        }
        // ds = p (dP - c), p = exp(s - lse); 0 at keys past L.
        s[i][0] = m < L ? __expf(s[i][0] - lse0) * (dp[i][0] - c0) : 0.f;
        s[i][1] = m + 1 < L ? __expf(s[i][1] - lse0) * (dp[i][1] - c0) : 0.f;
        s[i][2] = m < L ? __expf(s[i][2] - lse1) * (dp[i][2] - c1) : 0.f;
        s[i][3] = m + 1 < L ? __expf(s[i][3] - lse1) * (dp[i][3] - c1) : 0.f;
      }
#pragma unroll
      for (int i = 0; i < kChunkTiles; ++i) {
        const int j = jc + i;
        if (j >= nj) break;
        strip_acc<D, kExact>(acc, s[i], ks + (8 * j + 2 * tq) * kS + gq);  // dq += ds.k
      }
    }
  }
  store_rows<T, D>(dq, row0, w.ok0, w.ok1, acc, tq);
}

template <typename T, int D, bool kBias, bool kWin>
__global__ void __launch_bounds__(kMmaThreads)
attention_bwd_dkdv_mma_kernel(const T* __restrict__ q, const T* __restrict__ k,
                              const T* __restrict__ v, const T* __restrict__ bias,
                              const T* __restrict__ g, const float* __restrict__ lse,
                              const float* __restrict__ c, T* __restrict__ dk,
                              T* __restrict__ dv, int B, int H, int L,
                              const float* __restrict__ offsets, int W) {
  constexpr bool kExact = sizeof(T) == 2;
  constexpr int kS = mma_stride<D>();
  extern __shared__ __align__(16) float ring[];  // [stage][Q, G][kTile][kS], then [stage][lse, c][kTile]
  const MmaTiling t(L);
  const long long n_heads = static_cast<long long>(B) * H;
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31, gq = lane >> 2, tq = lane & 3;
  const MmaRows w(t, H, n_heads, L, warp, gq);  // here the rows are keys
  const size_t row0 = w.base + w.r0;

  Frag<D> kf, vf;
  load_frag<T, D>(kf, k, row0, w.ok0, w.ok1, tq);
  load_frag<T, D>(vf, v, row0, w.ok0, w.ok1, tq);
  // bias[h, l, key]: this warp's keys r0 and r0 + 8 are columns.
  const T* bcol0 = kBias ? bias + static_cast<size_t>(w.h) * L * L + (w.ok0 ? w.r0 : 0) : nullptr;
  const T* bcol1 = kBias ? bias + static_cast<size_t>(w.h) * L * L + (w.ok1 ? w.r0 + 8 : 0)
                         : nullptr;
  if constexpr (kWin) {  // the window of the head's batch element
    if (lane == 0) {
      warp_windows<kMmaWarps>()[warp] =
          window_of(w.bh < n_heads ? offsets[static_cast<int>(w.bh) / H] : 0.f, W, L);
    }
  }
  float dk_acc[D / 8][4], dv_acc[D / 8][4];
#pragma unroll
  for (int n = 0; n < D / 8; ++n) {
    dk_acc[n][0] = dk_acc[n][1] = dk_acc[n][2] = dk_acc[n][3] = 0.f;
    dv_acc[n][0] = dv_acc[n][1] = dv_acc[n][2] = dv_acc[n][3] = 0.f;
  }
  const int nj = t.rows / 8;
  constexpr int kStage = 2 * kTile * kS;
  float* scal = ring + 2 * kStage;  // [stage][lse, c][kTile]
  stage_pair<T, D>(ring, ring + kTile * kS, q, g, t.heads, t.rows, w.head0, n_heads, L, 0,
                   lse, c, scal, scal + kTile);
  for (int lt = 0; lt < t.tiles; ++lt) {
    asm volatile("cp.async.wait_group 0;\n" ::);
    __syncthreads();
    if (lt + 1 < t.tiles) {
      const int nx = (lt + 1) & 1;
      float* nb = ring + nx * kStage;
      stage_pair<T, D>(nb, nb + kTile * kS, q, g, t.heads, t.rows, w.head0, n_heads, L,
                       (lt + 1) * t.rows, lse, c, scal + nx * 2 * kTile,
                       scal + nx * 2 * kTile + kTile);
    }
    const float* qs = ring + (lt & 1) * kStage + w.slot * t.rows * kS;
    const float* gs = qs + kTile * kS;
    const float* ls = scal + (lt & 1) * 2 * kTile + w.slot * t.rows;
    const float* cs = ls + kTile;
    const int l0 = lt * t.rows;
    for (int jc = 0; jc < nj; jc += kChunkTiles) {
      float p[kChunkTiles][4], ds[kChunkTiles][4];
#pragma unroll
      for (int i = 0; i < kChunkTiles; ++i) {
        const int j = jc + i;
        if (j >= nj) break;
        p[i][0] = p[i][1] = p[i][2] = p[i][3] = 0.f;
        ds[i][0] = ds[i][1] = ds[i][2] = ds[i][3] = 0.f;
        strip_dot<D, kExact>(p[i], kf, qs + (8 * j + gq) * kS + tq);   // S^T = k.q^T
        strip_dot<D, kExact>(ds[i], vf, gs + (8 * j + gq) * kS + tq);  // dP^T = v.g^T
        const int li = 8 * j + 2 * tq;  // query of c0, c2 in the tile; li + 1 of c1, c3
        const int l = l0 + li;
        if constexpr (kBias) {
          // The keys that take a bias, and the query rows: B2's in L; B4's
          // inside the window of the head's batch element.
          const Window win = bias_window<kWin, kMmaWarps, sizeof(T) == 4>(warp, L);
          const bool in0 = kWin ? w.ok0 && win.has(w.r0) : w.ok0;
          const bool in1 = kWin ? w.ok1 && win.has(w.r0 + 8) : w.ok1;
          if (in_bias<kWin>(win, l, L)) {
            p[i][0] += in0 ? to_float(bcol0[static_cast<size_t>(l) * L]) : 0.f;
            p[i][2] += in1 ? to_float(bcol1[static_cast<size_t>(l) * L]) : 0.f;
          }
          if (in_bias<kWin>(win, l + 1, L)) {
            p[i][1] += in0 ? to_float(bcol0[static_cast<size_t>(l + 1) * L]) : 0.f;
            p[i][3] += in1 ? to_float(bcol1[static_cast<size_t>(l + 1) * L]) : 0.f;
          }
        }
        // p^T = exp(s^T - lse[l]) (lse +inf past L: 0), ds^T = p^T (dP^T - c[l]).
        const float la = ls[li], lb = ls[li + 1], ca = cs[li], cb = cs[li + 1];
        p[i][0] = __expf(p[i][0] - la);
        p[i][1] = __expf(p[i][1] - lb);
        p[i][2] = __expf(p[i][2] - la);
        p[i][3] = __expf(p[i][3] - lb);
        ds[i][0] = p[i][0] * (ds[i][0] - ca);
        ds[i][1] = p[i][1] * (ds[i][1] - cb);
        ds[i][2] = p[i][2] * (ds[i][2] - ca);
        ds[i][3] = p[i][3] * (ds[i][3] - cb);
      }
#pragma unroll
      for (int i = 0; i < kChunkTiles; ++i) {
        const int j = jc + i;
        if (j >= nj) break;
        strip_acc<D, kExact>(dv_acc, p[i], gs + (8 * j + 2 * tq) * kS + gq);   // dv += p^T.g
        strip_acc<D, kExact>(dk_acc, ds[i], qs + (8 * j + 2 * tq) * kS + gq);  // dk += ds^T.q
      }
    }
  }
  store_rows<T, D>(dk, row0, w.ok0, w.ok1, dk_acc, tq);
  store_rows<T, D>(dv, row0, w.ok0, w.ok1, dv_acc, tq);
}

// The first element from b on (B where there is none) whose window holds
// a row of the (l, m) tile at (l0, m0) and a key of it (kWin: the dtoep
// pass visits only those); without a window, b itself.
template <bool kWin>
__device__ __forceinline__ int next_element(int b, int B, const float* __restrict__ offsets, int W,
                                            int L, int l0, int m0) {
  if constexpr (kWin) {
    while (b < B && !window_of(offsets[b], W, L).meets(l0, m0, kTile)) ++b;
  }
  return b;
}

// kWin (B4): the dtoep pass, dbias = sum_b ds * in_b[l] * in_b[m].
template <typename T, int D, bool kWin>
__global__ void __launch_bounds__(kMmaThreads)
attention_bwd_dbias_mma_kernel(const T* __restrict__ q, const T* __restrict__ k,
                               const T* __restrict__ v, const T* __restrict__ bias,
                               const T* __restrict__ g, const float* __restrict__ lse,
                               const float* __restrict__ c, float* __restrict__ dbias, int B,
                               int H, int L, const float* __restrict__ offsets, int W) {
  constexpr bool kExact = sizeof(T) == 2;
  constexpr int kS = mma_stride<D>();
  constexpr int kNT = kTile / 8;
  extern __shared__ __align__(16) float ring[];  // [stage][K, V][kTile][kS]
  const int tiles = (L + kTile - 1) / kTile;
  const int h = blockIdx.x / (tiles * tiles);
  const int l0 = (blockIdx.x / tiles) % tiles * kTile;
  const int m0 = blockIdx.x % tiles * kTile;
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31, gq = lane >> 2, tq = lane & 3;
  const int r0 = l0 + warp * 16 + gq;  // this lane's rows r0 and r0 + 8
  const bool ok0 = r0 < L, ok1 = r0 + 8 < L;
  const T* brow0 = bias + (static_cast<size_t>(h) * L + (ok0 ? r0 : 0)) * L;
  const T* brow1 = bias + (static_cast<size_t>(h) * L + (ok1 ? r0 + 8 : 0)) * L;
  const long long n_heads = static_cast<long long>(B) * H;

  float acc[kNT][4];
#pragma unroll
  for (int j = 0; j < kNT; ++j) acc[j][0] = acc[j][1] = acc[j][2] = acc[j][3] = 0.f;
  constexpr int kStage = 2 * kTile * kS;
  // Element b is the i-th the block visits (buffer i & 1 of the ring).
  int b = next_element<kWin>(0, B, offsets, W, L, l0, m0);
  if (b < B) {
    stage_pair<T, D>(ring, ring + kTile * kS, k, v, 1, kTile, static_cast<long long>(b) * H + h,
                     n_heads, L, m0);
  }
  for (int i = 0; b < B; ++i) {
    const int next = next_element<kWin>(b + 1, B, offsets, W, L, l0, m0);
    asm volatile("cp.async.wait_group 0;\n" ::);
    __syncthreads();
    if (next < B) {
      float* nb = ring + ((i + 1) & 1) * kStage;
      stage_pair<T, D>(nb, nb + kTile * kS, k, v, 1, kTile,
                       static_cast<long long>(next) * H + h, n_heads, L, m0);
    }
    const float* ks = ring + (i & 1) * kStage;
    const float* vs = ks + kTile * kS;
    const size_t row0 = (static_cast<size_t>(b) * H + h) * L + r0;
    Frag<D> qf, gf;
    load_frag<T, D>(qf, q, row0, ok0, ok1, tq);
    load_frag<T, D>(gf, g, row0, ok0, ok1, tq);
    const float lse0 = ok0 ? lse[row0] : 0.f, lse1 = ok1 ? lse[row0 + 8] : 0.f;
    const float c0 = ok0 ? c[row0] : 0.f, c1 = ok1 ? c[row0 + 8] : 0.f;
    // The (l, m) this element adds to: B2's in L; B4's inside its window,
    // where its bias is toep itself.
    const Window win = kWin ? window_of(offsets[b], W, L) : Window{0, L};
    const bool r_in0 = kWin ? ok0 && win.has(r0) : ok0;
    const bool r_in1 = kWin ? ok1 && win.has(r0 + 8) : ok1;
#pragma unroll
    for (int j = 0; j < kNT; ++j) {
      float s[4] = {0.f, 0.f, 0.f, 0.f}, dp[4] = {0.f, 0.f, 0.f, 0.f};
      strip_dot<D, kExact>(s, qf, ks + (8 * j + gq) * kS + tq);
      strip_dot<D, kExact>(dp, gf, vs + (8 * j + gq) * kS + tq);
      const int m = m0 + 8 * j + 2 * tq;
      const bool in0 = in_bias<kWin>(win, m, L), in1 = in_bias<kWin>(win, m + 1, L);
      // ds = exp(s + bias - lse) (dP - c), summed over b in order.
      if (in0) {
        acc[j][0] += r_in0 ? __expf(s[0] + to_float(brow0[m]) - lse0) * (dp[0] - c0) : 0.f;
        acc[j][2] += r_in1 ? __expf(s[2] + to_float(brow1[m]) - lse1) * (dp[2] - c1) : 0.f;
      }
      if (in1) {
        acc[j][1] += r_in0 ? __expf(s[1] + to_float(brow0[m + 1]) - lse0) * (dp[1] - c0) : 0.f;
        acc[j][3] += r_in1 ? __expf(s[3] + to_float(brow1[m + 1]) - lse1) * (dp[3] - c1) : 0.f;
      }
    }
    b = next;
  }
#pragma unroll
  for (int j = 0; j < kNT; ++j) {
    const int m = m0 + 8 * j + 2 * tq;
    float* d0 = dbias + (static_cast<size_t>(h) * L + r0) * L + m;
    if (ok0 && m < L) d0[0] = acc[j][0];
    if (ok0 && m + 1 < L) d0[1] = acc[j][1];
    if (ok1 && m < L) d0[8 * static_cast<size_t>(L)] = acc[j][2];
    if (ok1 && m + 1 < L) d0[8 * static_cast<size_t>(L) + 1] = acc[j][3];
  }
}

template <typename T, int D, bool kBias, bool kWin>
cudaError_t launch_mma_passes(const T* q, const T* k, const T* v, const T* bias, const T* g,
                              const T* o, const float* lse, float* c, T* dq, T* dk, T* dv,
                              int B, int H, int L, const float* offsets, int W,
                              cudaStream_t stream) {
  static const cudaError_t allowed_dq =
      allow_smem(attention_bwd_dq_mma_kernel<T, D, kBias, kWin>, mma_smem_bytes<D>(false));
  static const cudaError_t allowed_dkdv =
      allow_smem(attention_bwd_dkdv_mma_kernel<T, D, kBias, kWin>, mma_smem_bytes<D>(true));
  if (allowed_dq != cudaSuccess) return allowed_dq;
  if (allowed_dkdv != cudaSuccess) return allowed_dkdv;
  const MmaTiling t(L);
  const long long groups = (static_cast<long long>(B) * H + t.heads - 1) / t.heads;
  const long long blocks = groups * t.tiles;
  if (blocks > 0x7fffffffLL) return cudaErrorInvalidValue;
  attention_bwd_dq_mma_kernel<T, D, kBias, kWin>
      <<<static_cast<int>(blocks), kMmaThreads, mma_smem_bytes<D>(false), stream>>>(
          q, k, v, bias, g, o, lse, c, dq, B, H, L, offsets, W);
  const cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess) return err;
  attention_bwd_dkdv_mma_kernel<T, D, kBias, kWin>
      <<<static_cast<int>(blocks), kMmaThreads, mma_smem_bytes<D>(true), stream>>>(
          q, k, v, bias, g, lse, c, dk, dv, B, H, L, offsets, W);
  return cudaGetLastError();
}

template <typename T, int D, bool kWin>
cudaError_t launch_mma_d(const void* q, const void* k, const void* v, const void* bias,
                         const void* g, const void* o, const float* lse, float* c, void* dq,
                         void* dk, void* dv, float* dbias, int B, int H, int L,
                         const float* offsets, int W, cudaStream_t stream) {
  const T* qt = static_cast<const T*>(q);
  const T* kt = static_cast<const T*>(k);
  const T* vt = static_cast<const T*>(v);
  const T* bt = static_cast<const T*>(bias);
  const T* gt = static_cast<const T*>(g);
  const T* ot = static_cast<const T*>(o);
  T* dqt = static_cast<T*>(dq);
  T* dkt = static_cast<T*>(dk);
  T* dvt = static_cast<T*>(dv);
  cudaError_t err;
  if constexpr (kWin) {
    err = launch_mma_passes<T, D, true, true>(qt, kt, vt, bt, gt, ot, lse, c, dqt, dkt, dvt, B,
                                              H, L, offsets, W, stream);
  } else {
    err = bias != nullptr
              ? launch_mma_passes<T, D, true, false>(qt, kt, vt, bt, gt, ot, lse, c, dqt, dkt,
                                                     dvt, B, H, L, nullptr, 0, stream)
              : launch_mma_passes<T, D, false, false>(qt, kt, vt, bt, gt, ot, lse, c, dqt, dkt,
                                                      dvt, B, H, L, nullptr, 0, stream);
  }
  if (err != cudaSuccess || dbias == nullptr) return err;
  static const cudaError_t allowed =
      allow_smem(attention_bwd_dbias_mma_kernel<T, D, kWin>, mma_smem_bytes<D>(false));
  if (allowed != cudaSuccess) return allowed;
  const long long tiles = (L + kTile - 1) / kTile;
  const long long blocks = H * tiles * tiles;  // then tiles * tiles fits an int too
  if (blocks > 0x7fffffffLL) return cudaErrorInvalidValue;
  attention_bwd_dbias_mma_kernel<T, D, kWin>
      <<<static_cast<int>(blocks), kMmaThreads, mma_smem_bytes<D>(false), stream>>>(
          qt, kt, vt, bt, gt, lse, c, dbias, B, H, L, offsets, W);
  return cudaGetLastError();
}

// The template at head dim D = 8, 16, 32 or 64; any other D is refused.
// kWin: B4, `bias` the toep, `dbias` dtoep and `offsets` and W the windows
// (all required); else B2, offsets unused.
template <typename T, bool kWin>
cudaError_t launch_mma(const void* q, const void* k, const void* v, const void* bias,
                       const void* g, const void* o, const float* lse, float* c, void* dq,
                       void* dk, void* dv, float* dbias, int B, int H, int L, int D,
                       const float* offsets, int W, cudaStream_t stream) {
  switch (D) {
    case 8:
      return launch_mma_d<T, 8, kWin>(q, k, v, bias, g, o, lse, c, dq, dk, dv, dbias, B, H, L,
                                      offsets, W, stream);
    case 16:
      return launch_mma_d<T, 16, kWin>(q, k, v, bias, g, o, lse, c, dq, dk, dv, dbias, B, H, L,
                                       offsets, W, stream);
    case 32:
      return launch_mma_d<T, 32, kWin>(q, k, v, bias, g, o, lse, c, dq, dk, dv, dbias, B, H, L,
                                       offsets, W, stream);
    case 64:
      return launch_mma_d<T, 64, kWin>(q, k, v, bias, g, o, lse, c, dq, dk, dv, dbias, B, H, L,
                                       offsets, W, stream);
    default:
      return cudaErrorInvalidValue;
  }
}

// ---------------------------------------------------------------------------
// head_dim past 64: the three passes for every D that is a multiple of 64
// (the wrapper zero-pads any other D > 64 up to the next one), for
// Transformer1d with 128- and 256-wide heads. The mma template above is
// left as it is.
//
// What bounds it: the template's work, 10*L*L*D flops a (b, h). What the
// template keeps per thread grows with D (the dq pass holds q's and g's
// fragments, 2*D registers at f32; the dk/dv pass two accumulators of D /
// 2), and its ring of two tiles of 64 x (D + 4) floats a stage passes the
// per-block limit at D = 256. So nothing here grows with D, as in B1's
// wide kernel (attention_fwd.cu):
// * D is cut into 64-wide chunks, and a block of the dq and dk/dv passes
//   owns one 64-wide part of its outputs (blockIdx.y): it contracts S =
//   q.k^T and dP = g.v^T over the whole D, chunk by chunk, and recomputes
//   them for its part (D / 64 times over at the widest).
// * The ring is two stages of two 64 x 68 f32 tiles (bf16 widened to f32
//   as it lands), 69,632 bytes for every D (the dk/dv pass adds its rows'
//   lse and c). Per tile of the other side a block walks 2 * chunks + 1
//   stages: chunk c of (q, K), then of (g, V), then the part's operand of
//   the last product (dq: K; dk/dv: q and g with the rows' lse and c).
// * dq pass: a warp's 16 query rows read their A fragments from the
//   staged q (g) rows, one 8-dim k-step at a time; S and dP over the tile's
//   64 keys are summed over the chunks in C fragments (each k-step's
//   products in a fresh fragment); then p = exp(S + bias - lse), ds = p
//   (dP - c) and dq += ds.k over the part, by the template's permutation.
//   c = g.o is summed over the whole D by every part, alike; part 0
//   writes it for the later passes.
// * dk/dv pass, its transpose: a warp's 16 keys, S^T = k.q^T and dP^T =
//   v.g^T over the chunks, then dv += p^T.g and dk += ds^T.q over the part.
// * dbias pass: a block owns one head and a 64 x 64 (l, m) tile, as the
//   template's, and walks the batch in order; per element 2 * chunks
//   stages of (q, K) and (g, V) chunks, S and dP summed over them, then ds
//   into the tile's f32 accumulators in b order. dbias is not split by D.
// No atomics: a call gives bit-identical results every time.

constexpr int kWideD = 64;  // dims of a chunk of D, and of a block's output part

// A ring of two stages of two (kTile x 68) f32 tiles; the dk/dv pass adds
// the tiles' lse and c.
__host__ __device__ constexpr int wide_smem_bytes(bool with_scalars) {
  return mma_smem_bytes<kWideD>(with_scalars);
}

// Start staging 64 dims (col0 ..) of `slots` heads of `rows` rows each of
// x into the f32 tile xs (stride 68), head head0 + s at rows [first,
// first + rows) of its (b, h); rows past L and heads past n_heads are
// zeros. f32 rows by cp.async, bf16 rows converted as they land.
template <typename T>
__device__ __forceinline__ void stage_wide(float* xs, const T* __restrict__ x, int slots,
                                           int rows, long long head0, long long n_heads, int L,
                                           int D, int first, int col0) {
  constexpr int kS = mma_stride<kWideD>();
  constexpr int kPer = 16 / sizeof(T);  // values a 16-byte load
  constexpr int kChunks = kWideD / kPer;
  for (int i = threadIdx.x; i < slots * rows * kChunks; i += kMmaThreads) {
    const int row = i / kChunks, ch = i - row * kChunks;
    const int slot = row / rows, r = first + row - slot * rows;
    const long long bh = head0 + slot;
    const bool in = bh < n_heads && r < L;
    const size_t at = in ? (static_cast<size_t>(bh) * L + r) * D + col0 + ch * kPer : 0;
    float* dx = xs + row * kS + ch * kPer;
    if constexpr (sizeof(T) == 4) {
      cp_async16(dx, x + at, in);
    } else {
      float vx[8];
      unpack(in ? *reinterpret_cast<const uint4*>(x + at) : make_uint4(0, 0, 0, 0), vx);
      reinterpret_cast<float4*>(dx)[0] = make_float4(vx[0], vx[1], vx[2], vx[3]);
      reinterpret_cast<float4*>(dx)[1] = make_float4(vx[4], vx[5], vx[6], vx[7]);
    }
  }
}

// c[j] += a . b_j^T over one staged 64-dim chunk, for the n-tiles j < nj:
// `a` points at this warp's 16 staged rows, `b` at the staged rows of
// the other side (row 8j + gq is n-tile j's column gq). One 8-dim k-step
// at a time, its A fragment split here, each k-step's products in a fresh
// fragment (`add4`). kExact: both operands exact in TF32, one pass.
template <bool kExact>
__device__ __forceinline__ void chunk_dot(float (&c)[kTile / 8][4], const float* a,
                                          const float* b, int nj, int gq, int tq) {
  constexpr int kS = mma_stride<kWideD>();
#pragma unroll
  for (int kk = 0; kk < kWideD / 8; ++kk) {
    const float* ap = a + gq * kS + 8 * kk + tq;
    const float x[4] = {ap[0], ap[8 * kS], ap[4], ap[8 * kS + 4]};
    uint32_t ah[4], al[4];
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      if constexpr (kExact) {
        ah[i] = __float_as_uint(x[i]);
      } else {
        split_tf32(x[i], ah[i], al[i]);
      }
    }
#pragma unroll
    for (int j = 0; j < kTile / 8; ++j) {
      if (j >= nj) break;
      const float* bp = b + (8 * j + gq) * kS + 8 * kk + tq;
      float t[4] = {0.f, 0.f, 0.f, 0.f};
      if constexpr (kExact) {
        mma_tf32(t, ah, __float_as_uint(bp[0]), __float_as_uint(bp[4]));
      } else {
        uint32_t h0, l0, h1, l1;
        split_tf32(bp[0], h0, l0);
        split_tf32(bp[4], h1, l1);
        mma_tf32(t, al, h0, h1);
        mma_tf32(t, ah, l0, l1);
        mma_tf32(t, ah, h0, h1);
      }
      add4(c[j], t);
    }
  }
}

__device__ __forceinline__ void zero_tiles(float (&c)[kTile / 8][4]) {
#pragma unroll
  for (int j = 0; j < kTile / 8; ++j) c[j][0] = c[j][1] = c[j][2] = c[j][3] = 0.f;
}

// Rows r0 and r0 + 8 (at element offset row0 of a D-wide array) of the
// 64-dim part `part` from C fragments, each value rounded once to T.
template <typename T>
__device__ __forceinline__ void store_part(T* __restrict__ out, size_t row0, int D, int part,
                                           bool ok0, bool ok1,
                                           const float (&acc)[kWideD / 8][4], int tq) {
  T* p0 = out + row0 * D + part * kWideD + 2 * tq;
  T* p1 = p0 + 8 * static_cast<size_t>(D);
#pragma unroll
  for (int n = 0; n < kWideD / 8; ++n) {
    if (ok0) store2(p0 + 8 * n, acc[n][0], acc[n][1]);
    if (ok1) store2(p1 + 8 * n, acc[n][2], acc[n][3]);
  }
}

template <typename T, bool kBias, bool kWin>
__global__ void __launch_bounds__(kMmaThreads)
attention_bwd_dq_wide_kernel(const T* __restrict__ q, const T* __restrict__ k,
                             const T* __restrict__ v, const T* __restrict__ bias,
                             const T* __restrict__ g, const T* __restrict__ o,
                             const float* __restrict__ lse, float* __restrict__ c,
                             T* __restrict__ dq, int B, int H, int L, int D,
                             const float* __restrict__ offsets, int W) {
  constexpr bool kExact = sizeof(T) == 2;
  constexpr int kS = mma_stride<kWideD>();
  constexpr int kPlane = kTile * kS;
  extern __shared__ __align__(16) float ring[];  // [stage][2 tiles][kTile][kS]
  const MmaTiling t(L);
  const long long n_heads = static_cast<long long>(B) * H;
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31, gq = lane >> 2, tq = lane & 3;
  const MmaRows w(t, H, n_heads, L, warp, gq);
  const size_t row0 = w.base + w.r0;
  const int first = (blockIdx.x % t.tiles) * t.rows;  // the block's query rows
  const int part = blockIdx.y, chunks = D / kWideD;

  // c = g.o of both rows over the whole D: dims tq, tq + 4, ... a lane,
  // summed across the quad; every part alike, part 0 writes it.
  float c0 = 0.f, c1 = 0.f;
  for (int d = tq; d < D; d += 4) {
    if (w.ok0) c0 = fmaf(to_float(g[row0 * D + d]), to_float(o[row0 * D + d]), c0);
    if (w.ok1) c1 = fmaf(to_float(g[(row0 + 8) * D + d]), to_float(o[(row0 + 8) * D + d]), c1);
  }
#pragma unroll
  for (int x = 1; x <= 2; x <<= 1) {
    c0 += __shfl_xor_sync(0xffffffffu, c0, x);
    c1 += __shfl_xor_sync(0xffffffffu, c1, x);
  }
  if (tq == 0 && part == 0) {
    if (w.ok0) c[row0] = c0;
    if (w.ok1) c[row0 + 8] = c1;
  }
  const float lse0 = w.ok0 ? lse[row0] : 0.f, lse1 = w.ok1 ? lse[row0 + 8] : 0.f;
  const T* brow0 = kBias ? bias + (static_cast<size_t>(w.h) * L + (w.ok0 ? w.r0 : 0)) * L : nullptr;
  const T* brow1 = kBias ? bias + (static_cast<size_t>(w.h) * L + (w.ok1 ? w.r0 + 8 : 0)) * L
                         : nullptr;
  if constexpr (kWin) {  // the window of the head's batch element
    if (lane == 0) {
      warp_windows<kMmaWarps>()[warp] =
          window_of(w.bh < n_heads ? offsets[static_cast<int>(w.bh) / H] : 0.f, W, L);
    }
  }

  float acc[kWideD / 8][4];
#pragma unroll
  for (int n = 0; n < kWideD / 8; ++n) acc[n][0] = acc[n][1] = acc[n][2] = acc[n][3] = 0.f;
  const int nj = t.rows / 8;
  // Key tile st / per, step cs = st % per: chunk cs of (q, K) (cs <
  // chunks), chunk cs - chunks of (g, V) (cs < 2 chunks), then the part of K.
  const int per = 2 * chunks + 1, n_stages = t.tiles * per;
  auto stage = [&](int st) {
    float* buf = ring + (st & 1) * 2 * kPlane;
    const int kt = st / per, cs = st - kt * per;
    if (cs < 2 * chunks) {
      const bool second = cs >= chunks;
      const int col = (second ? cs - chunks : cs) * kWideD;
      stage_wide<T>(buf, second ? g : q, t.heads, t.rows, w.head0, n_heads, L, D, first, col);
      stage_wide<T>(buf + kPlane, second ? v : k, t.heads, t.rows, w.head0, n_heads, L, D,
                    kt * t.rows, col);
    } else {
      stage_wide<T>(buf, k, t.heads, t.rows, w.head0, n_heads, L, D, kt * t.rows,
                    part * kWideD);
    }
    asm volatile("cp.async.commit_group;\n" ::);
  };

  float s[kTile / 8][4], dp[kTile / 8][4];
  stage(0);
  for (int st = 0; st < n_stages; ++st) {
    asm volatile("cp.async.wait_group 0;\n" ::);
    __syncthreads();  // stage st is in; every thread is done with stage st - 1's buffer
    if (st + 1 < n_stages) stage(st + 1);
    const float* buf = ring + (st & 1) * 2 * kPlane;
    const int kt = st / per, cs = st - kt * per;
    if (cs < 2 * chunks) {
      if (cs == 0) {
        zero_tiles(s);
        zero_tiles(dp);
      }
      const float* as = buf + 16 * warp * kS;                 // this warp's rows of q (g)
      const float* bs = buf + kPlane + w.slot * t.rows * kS;  // its head's keys of K (V)
      if (cs < chunks) {
        chunk_dot<kExact>(s, as, bs, nj, gq, tq);
      } else {
        chunk_dot<kExact>(dp, as, bs, nj, gq, tq);
      }
      if (cs + 1 < 2 * chunks) continue;
      // ds = p (dP - c), p = exp(s + bias - lse); 0 at keys past L.
      const int key0 = kt * t.rows;
#pragma unroll
      for (int j = 0; j < kTile / 8; ++j) {
        if (j >= nj) break;
        const int m = key0 + 8 * j + 2 * tq;  // key of c0, c2; m + 1 of c1, c3
        if constexpr (kBias) {
          // The rows that take a bias, and the keys (the template's).
          const Window win = bias_window<kWin, kMmaWarps, sizeof(T) == 4>(warp, L);
          const bool in0 = kWin ? w.ok0 && win.has(w.r0) : w.ok0;
          const bool in1 = kWin ? w.ok1 && win.has(w.r0 + 8) : w.ok1;
          if (in_bias<kWin>(win, m, L)) {
            s[j][0] += in0 ? to_float(brow0[m]) : 0.f;
            s[j][2] += in1 ? to_float(brow1[m]) : 0.f;
          }
          if (in_bias<kWin>(win, m + 1, L)) {
            s[j][1] += in0 ? to_float(brow0[m + 1]) : 0.f;
            s[j][3] += in1 ? to_float(brow1[m + 1]) : 0.f;
          }
        }
        s[j][0] = m < L ? __expf(s[j][0] - lse0) * (dp[j][0] - c0) : 0.f;
        s[j][1] = m + 1 < L ? __expf(s[j][1] - lse0) * (dp[j][1] - c0) : 0.f;
        s[j][2] = m < L ? __expf(s[j][2] - lse1) * (dp[j][2] - c1) : 0.f;
        s[j][3] = m + 1 < L ? __expf(s[j][3] - lse1) * (dp[j][3] - c1) : 0.f;
      }
      continue;
    }
    const float* ks = buf + w.slot * t.rows * kS;  // the part of the head's keys
#pragma unroll
    for (int j = 0; j < kTile / 8; ++j) {
      if (j >= nj) break;
      strip_acc<kWideD, kExact>(acc, s[j], ks + (8 * j + 2 * tq) * kS + gq);  // dq += ds.k
    }
  }
  store_part<T>(dq, row0, D, part, w.ok0, w.ok1, acc, tq);
}

template <typename T, bool kBias, bool kWin>
__global__ void __launch_bounds__(kMmaThreads)
attention_bwd_dkdv_wide_kernel(const T* __restrict__ q, const T* __restrict__ k,
                               const T* __restrict__ v, const T* __restrict__ bias,
                               const T* __restrict__ g, const float* __restrict__ lse,
                               const float* __restrict__ c, T* __restrict__ dk,
                               T* __restrict__ dv, int B, int H, int L, int D,
                               const float* __restrict__ offsets, int W) {
  constexpr bool kExact = sizeof(T) == 2;
  constexpr int kS = mma_stride<kWideD>();
  constexpr int kPlane = kTile * kS;
  // [stage][2 tiles][kTile][kS], then [stage][lse, c][kTile]
  extern __shared__ __align__(16) float ring[];
  const MmaTiling t(L);
  const long long n_heads = static_cast<long long>(B) * H;
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31, gq = lane >> 2, tq = lane & 3;
  const MmaRows w(t, H, n_heads, L, warp, gq);  // here the rows are keys
  const size_t row0 = w.base + w.r0;
  const int first = (blockIdx.x % t.tiles) * t.rows;  // the block's keys
  const int part = blockIdx.y, chunks = D / kWideD;
  // bias[h, l, key]: this warp's keys r0 and r0 + 8 are columns.
  const T* bcol0 = kBias ? bias + static_cast<size_t>(w.h) * L * L + (w.ok0 ? w.r0 : 0) : nullptr;
  const T* bcol1 = kBias ? bias + static_cast<size_t>(w.h) * L * L + (w.ok1 ? w.r0 + 8 : 0)
                         : nullptr;
  if constexpr (kWin) {  // the window of the head's batch element
    if (lane == 0) {
      warp_windows<kMmaWarps>()[warp] =
          window_of(w.bh < n_heads ? offsets[static_cast<int>(w.bh) / H] : 0.f, W, L);
    }
  }
  float dk_acc[kWideD / 8][4], dv_acc[kWideD / 8][4];
#pragma unroll
  for (int n = 0; n < kWideD / 8; ++n) {
    dk_acc[n][0] = dk_acc[n][1] = dk_acc[n][2] = dk_acc[n][3] = 0.f;
    dv_acc[n][0] = dv_acc[n][1] = dv_acc[n][2] = dv_acc[n][3] = 0.f;
  }
  const int nj = t.rows / 8;
  float* scal = ring + 2 * 2 * kPlane;  // [stage][lse, c][kTile]
  // Query tile st / per, step c = st % per: chunk c of (K, q), chunk c -
  // chunks of (V, g), then the part of q and g with the rows' lse and c.
  const int per = 2 * chunks + 1, n_stages = t.tiles * per;
  auto stage = [&](int st) {
    float* buf = ring + (st & 1) * 2 * kPlane;
    const int lt = st / per, cs = st - lt * per;
    if (cs < 2 * chunks) {
      const bool second = cs >= chunks;
      const int col = (second ? cs - chunks : cs) * kWideD;
      stage_wide<T>(buf, second ? v : k, t.heads, t.rows, w.head0, n_heads, L, D, first, col);
      stage_wide<T>(buf + kPlane, second ? g : q, t.heads, t.rows, w.head0, n_heads, L, D,
                    lt * t.rows, col);
    } else {
      stage_wide<T>(buf, q, t.heads, t.rows, w.head0, n_heads, L, D, lt * t.rows,
                    part * kWideD);
      stage_wide<T>(buf + kPlane, g, t.heads, t.rows, w.head0, n_heads, L, D, lt * t.rows,
                    part * kWideD);
      float* ls = scal + (st & 1) * 2 * kTile;
      for (int row = threadIdx.x; row < t.heads * t.rows; row += kMmaThreads) {
        const int slot = row / t.rows, r = lt * t.rows + row - slot * t.rows;
        const long long bh = w.head0 + slot;
        const bool in = bh < n_heads && r < L;
        const size_t at = static_cast<size_t>(in ? bh : 0) * L + (in ? r : 0);
        ls[row] = in ? lse[at] : __int_as_float(0x7f800000);  // +inf: p = 0
        ls[kTile + row] = in ? c[at] : 0.f;
      }
    }
    asm volatile("cp.async.commit_group;\n" ::);
  };

  float p[kTile / 8][4], ds[kTile / 8][4];
  stage(0);
  for (int st = 0; st < n_stages; ++st) {
    asm volatile("cp.async.wait_group 0;\n" ::);
    __syncthreads();
    if (st + 1 < n_stages) stage(st + 1);
    const float* buf = ring + (st & 1) * 2 * kPlane;
    const int lt = st / per, cs = st - lt * per;
    if (cs < 2 * chunks) {
      if (cs == 0) {
        zero_tiles(p);
        zero_tiles(ds);
      }
      const float* as = buf + 16 * warp * kS;                 // this warp's keys of K (V)
      const float* bs = buf + kPlane + w.slot * t.rows * kS;  // its head's rows of q (g)
      if (cs < chunks) {
        chunk_dot<kExact>(p, as, bs, nj, gq, tq);   // S^T = k.q^T
      } else {
        chunk_dot<kExact>(ds, as, bs, nj, gq, tq);  // dP^T = v.g^T
      }
      continue;
    }
    const float* qs = buf + w.slot * t.rows * kS;
    const float* gs = qs + kPlane;
    const float* ls = scal + (st & 1) * 2 * kTile + w.slot * t.rows;
    const float* css = ls + kTile;
    const int l0 = lt * t.rows;
#pragma unroll
    for (int j = 0; j < kTile / 8; ++j) {
      if (j >= nj) break;
      const int li = 8 * j + 2 * tq;  // query of c0, c2 in the tile; li + 1 of c1, c3
      const int l = l0 + li;
      if constexpr (kBias) {
        // The keys that take a bias, and the query rows (the template's).
        const Window win = bias_window<kWin, kMmaWarps, sizeof(T) == 4>(warp, L);
        const bool in0 = kWin ? w.ok0 && win.has(w.r0) : w.ok0;
        const bool in1 = kWin ? w.ok1 && win.has(w.r0 + 8) : w.ok1;
        if (in_bias<kWin>(win, l, L)) {
          p[j][0] += in0 ? to_float(bcol0[static_cast<size_t>(l) * L]) : 0.f;
          p[j][2] += in1 ? to_float(bcol1[static_cast<size_t>(l) * L]) : 0.f;
        }
        if (in_bias<kWin>(win, l + 1, L)) {
          p[j][1] += in0 ? to_float(bcol0[static_cast<size_t>(l + 1) * L]) : 0.f;
          p[j][3] += in1 ? to_float(bcol1[static_cast<size_t>(l + 1) * L]) : 0.f;
        }
      }
      // p^T = exp(s^T - lse[l]) (lse +inf past L: 0), ds^T = p^T (dP^T - c[l]).
      const float la = ls[li], lb = ls[li + 1], ca = css[li], cb = css[li + 1];
      p[j][0] = __expf(p[j][0] - la);
      p[j][1] = __expf(p[j][1] - lb);
      p[j][2] = __expf(p[j][2] - la);
      p[j][3] = __expf(p[j][3] - lb);
      ds[j][0] = p[j][0] * (ds[j][0] - ca);
      ds[j][1] = p[j][1] * (ds[j][1] - cb);
      ds[j][2] = p[j][2] * (ds[j][2] - ca);
      ds[j][3] = p[j][3] * (ds[j][3] - cb);
      strip_acc<kWideD, kExact>(dv_acc, p[j], gs + (8 * j + 2 * tq) * kS + gq);   // dv += p^T.g
      strip_acc<kWideD, kExact>(dk_acc, ds[j], qs + (8 * j + 2 * tq) * kS + gq);  // dk += ds^T.q
    }
  }
  store_part<T>(dk, row0, D, part, w.ok0, w.ok1, dk_acc, tq);
  store_part<T>(dv, row0, D, part, w.ok0, w.ok1, dv_acc, tq);
}

// kWin (B4): the dtoep pass, as the template's.
template <typename T, bool kWin>
__global__ void __launch_bounds__(kMmaThreads)
attention_bwd_dbias_wide_kernel(const T* __restrict__ q, const T* __restrict__ k,
                                const T* __restrict__ v, const T* __restrict__ bias,
                                const T* __restrict__ g, const float* __restrict__ lse,
                                const float* __restrict__ c, float* __restrict__ dbias, int B,
                                int H, int L, int D, const float* __restrict__ offsets, int W) {
  constexpr bool kExact = sizeof(T) == 2;
  constexpr int kS = mma_stride<kWideD>();
  constexpr int kPlane = kTile * kS;
  constexpr int kNT = kTile / 8;
  extern __shared__ __align__(16) float ring[];  // [stage][2 tiles][kTile][kS]
  const int tiles = (L + kTile - 1) / kTile;
  const int h = blockIdx.x / (tiles * tiles);
  const int l0 = (blockIdx.x / tiles) % tiles * kTile;
  const int m0 = blockIdx.x % tiles * kTile;
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31, gq = lane >> 2, tq = lane & 3;
  const int r0 = l0 + warp * 16 + gq;  // this lane's rows r0 and r0 + 8
  const bool ok0 = r0 < L, ok1 = r0 + 8 < L;
  const T* brow0 = bias + (static_cast<size_t>(h) * L + (ok0 ? r0 : 0)) * L;
  const T* brow1 = bias + (static_cast<size_t>(h) * L + (ok1 ? r0 + 8 : 0)) * L;
  const long long n_heads = static_cast<long long>(B) * H;
  const int chunks = D / kWideD;

  float acc[kNT][4];
  zero_tiles(acc);
  // Stage st is step cs = st % per of an element the block visits
  // (`next_element`): chunk cs of (q, K), then chunk cs - chunks of (g, V).
  const int per = 2 * chunks;
  auto stage = [&](long long st, int b) {
    float* buf = ring + (st & 1) * 2 * kPlane;
    const int cs = static_cast<int>(st % per);
    const bool second = cs >= chunks;
    const int col = (second ? cs - chunks : cs) * kWideD;
    const long long bh = static_cast<long long>(b) * H + h;
    stage_wide<T>(buf, second ? g : q, 1, kTile, bh, n_heads, L, D, l0, col);
    stage_wide<T>(buf + kPlane, second ? v : k, 1, kTile, bh, n_heads, L, D, m0, col);
    asm volatile("cp.async.commit_group;\n" ::);
  };

  float s[kNT][4], dp[kNT][4];
  int b = next_element<kWin>(0, B, offsets, W, L, l0, m0);
  int next = next_element<kWin>(b + 1, B, offsets, W, L, l0, m0);
  if (b < B) stage(0, b);
  for (long long st = 0; b < B; ++st) {
    asm volatile("cp.async.wait_group 0;\n" ::);
    __syncthreads();
    const int cs = static_cast<int>(st % per);
    if (cs + 1 < per) {
      stage(st + 1, b);
    } else if (next < B) {
      stage(st + 1, next);
    }
    const float* buf = ring + (st & 1) * 2 * kPlane;
    if (cs == 0) {
      zero_tiles(s);
      zero_tiles(dp);
    }
    const float* as = buf + 16 * warp * kS;
    if (cs < chunks) {
      chunk_dot<kExact>(s, as, buf + kPlane, kNT, gq, tq);
    } else {
      chunk_dot<kExact>(dp, as, buf + kPlane, kNT, gq, tq);
    }
    if (cs + 1 < per) continue;
    const size_t row0 = (static_cast<size_t>(b) * H + h) * L + r0;
    const float lse0 = ok0 ? lse[row0] : 0.f, lse1 = ok1 ? lse[row0 + 8] : 0.f;
    const float c0 = ok0 ? c[row0] : 0.f, c1 = ok1 ? c[row0 + 8] : 0.f;
    // The (l, m) this element adds to (the template's).
    const Window win = kWin ? window_of(offsets[b], W, L) : Window{0, L};
    const bool r_in0 = kWin ? ok0 && win.has(r0) : ok0;
    const bool r_in1 = kWin ? ok1 && win.has(r0 + 8) : ok1;
#pragma unroll
    for (int j = 0; j < kNT; ++j) {
      const int m = m0 + 8 * j + 2 * tq;
      // ds = exp(s + bias - lse) (dP - c), summed over b in order.
      if (in_bias<kWin>(win, m, L)) {
        acc[j][0] +=
            r_in0 ? __expf(s[j][0] + to_float(brow0[m]) - lse0) * (dp[j][0] - c0) : 0.f;
        acc[j][2] +=
            r_in1 ? __expf(s[j][2] + to_float(brow1[m]) - lse1) * (dp[j][2] - c1) : 0.f;
      }
      if (in_bias<kWin>(win, m + 1, L)) {
        acc[j][1] +=
            r_in0 ? __expf(s[j][1] + to_float(brow0[m + 1]) - lse0) * (dp[j][1] - c0) : 0.f;
        acc[j][3] +=
            r_in1 ? __expf(s[j][3] + to_float(brow1[m + 1]) - lse1) * (dp[j][3] - c1) : 0.f;
      }
    }
    b = next;
    next = next_element<kWin>(b + 1, B, offsets, W, L, l0, m0);
  }
#pragma unroll
  for (int j = 0; j < kNT; ++j) {
    const int m = m0 + 8 * j + 2 * tq;
    float* d0 = dbias + (static_cast<size_t>(h) * L + r0) * L + m;
    if (ok0 && m < L) d0[0] = acc[j][0];
    if (ok0 && m + 1 < L) d0[1] = acc[j][1];
    if (ok1 && m < L) d0[8 * static_cast<size_t>(L)] = acc[j][2];
    if (ok1 && m + 1 < L) d0[8 * static_cast<size_t>(L) + 1] = acc[j][3];
  }
}

template <typename T, bool kBias, bool kWin>
cudaError_t launch_wide_passes(const T* q, const T* k, const T* v, const T* bias, const T* g,
                               const T* o, const float* lse, float* c, T* dq, T* dk, T* dv,
                               int B, int H, int L, int D, const float* offsets, int W,
                               cudaStream_t stream) {
  static const cudaError_t allowed_dq =
      allow_smem(attention_bwd_dq_wide_kernel<T, kBias, kWin>, wide_smem_bytes(false));
  static const cudaError_t allowed_dkdv =
      allow_smem(attention_bwd_dkdv_wide_kernel<T, kBias, kWin>, wide_smem_bytes(true));
  if (allowed_dq != cudaSuccess) return allowed_dq;
  if (allowed_dkdv != cudaSuccess) return allowed_dkdv;
  const MmaTiling t(L);
  const long long groups = (static_cast<long long>(B) * H + t.heads - 1) / t.heads;
  const long long blocks = groups * t.tiles;
  if (blocks > 0x7fffffffLL || D / kWideD > 65535) return cudaErrorInvalidValue;
  const dim3 grid(static_cast<unsigned>(blocks), D / kWideD);
  attention_bwd_dq_wide_kernel<T, kBias, kWin>
      <<<grid, kMmaThreads, wide_smem_bytes(false), stream>>>(q, k, v, bias, g, o, lse, c, dq,
                                                               B, H, L, D, offsets, W);
  const cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess) return err;
  attention_bwd_dkdv_wide_kernel<T, kBias, kWin>
      <<<grid, kMmaThreads, wide_smem_bytes(true), stream>>>(q, k, v, bias, g, lse, c, dk, dv,
                                                              B, H, L, D, offsets, W);
  return cudaGetLastError();
}

// The wide passes at D, a multiple of 64 past 64; any other D is refused.
// kWin as for launch_mma.
template <typename T, bool kWin>
cudaError_t launch_wide(const void* q, const void* k, const void* v, const void* bias,
                        const void* g, const void* o, const float* lse, float* c, void* dq,
                        void* dk, void* dv, float* dbias, int B, int H, int L, int D,
                        const float* offsets, int W, cudaStream_t stream) {
  if (D <= kWideD || D % kWideD) return cudaErrorInvalidValue;
  const T* qt = static_cast<const T*>(q);
  const T* kt = static_cast<const T*>(k);
  const T* vt = static_cast<const T*>(v);
  const T* bt = static_cast<const T*>(bias);
  const T* gt = static_cast<const T*>(g);
  const T* ot = static_cast<const T*>(o);
  T* dqt = static_cast<T*>(dq);
  T* dkt = static_cast<T*>(dk);
  T* dvt = static_cast<T*>(dv);
  cudaError_t err;
  if constexpr (kWin) {
    err = launch_wide_passes<T, true, true>(qt, kt, vt, bt, gt, ot, lse, c, dqt, dkt, dvt, B, H,
                                            L, D, offsets, W, stream);
  } else {
    err = bias != nullptr
              ? launch_wide_passes<T, true, false>(qt, kt, vt, bt, gt, ot, lse, c, dqt, dkt, dvt,
                                                   B, H, L, D, nullptr, 0, stream)
              : launch_wide_passes<T, false, false>(qt, kt, vt, bt, gt, ot, lse, c, dqt, dkt,
                                                    dvt, B, H, L, D, nullptr, 0, stream);
  }
  if (err != cudaSuccess || dbias == nullptr) return err;
  static const cudaError_t allowed =
      allow_smem(attention_bwd_dbias_wide_kernel<T, kWin>, wide_smem_bytes(false));
  if (allowed != cudaSuccess) return allowed;
  const long long tiles = (L + kTile - 1) / kTile;
  const long long blocks = H * tiles * tiles;
  if (blocks > 0x7fffffffLL) return cudaErrorInvalidValue;
  attention_bwd_dbias_wide_kernel<T, kWin>
      <<<static_cast<int>(blocks), kMmaThreads, wide_smem_bytes(false), stream>>>(
          qt, kt, vt, bt, gt, lse, c, dbias, B, H, L, D, offsets, W);
  return cudaGetLastError();
}

}  // namespace mma_bwd
}  // namespace
