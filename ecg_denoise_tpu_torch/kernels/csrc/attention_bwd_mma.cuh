// The tensor-core kernels of the fused attention backward: B2's three
// passes on one template on D for head_dim 8, 16, 32 and 64
// (attention_bwd.cu), and the wide passes for every multiple of 64 past 64,
// for B2 (attention_bwd.cu, no window) and B4 (attention_rpos_bwd.cu,
// kWin). Each source instantiates only its own mode, so B2's kernels
// compile in attention_bwd.cu and B4's in attention_rpos_bwd.cu, in
// parallel, and B2's are the same code with or without B4's beside them.
// B4 at D <= 64 has its own kernel (attention_rpos_bwd_mma.cuh), which
// uses `store_window_ds` below.
//
// The wide passes' window mode (kWin, B4: replacing the TPU kernel
// ecg_denoise_tpu/kernels/attention_pallas.py _bwd_rpos_kernel (:859) past
// D = 64). The bias is toep (1, H, L, L) times in_b[l] * in_b[m]
// (attention_window.cuh), formed where the dq and dk/dv passes recompute p,
// as attention_fwd_mma.cuh forms it. The toep gradient
//   dtoep[h,l,m] = sum_b ds[b,h,l,m] * in_b[l] * in_b[m]
// is built from the ds the dq pass computes anyway: in the window mode
// that pass also writes each head's ds inside its element's window, (l -
// s_b, m - s_b) with s_b the window's first position, to an f32 (B, H, W',
// W') scratch (W' = min(W, L)), and a second small kernel
// (attention_rpos_bwd.cu) sums it over b in order. The first design
// recomputed S and dP a third time for dtoep, in a pass whose grid
// (H x 64 x 64 tiles) was 4 blocks at (L, H) = (128, 1); it took 6.08 of
// B4's 8.76 ms a call at D = 256 on an H100.

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
// call past 256 keys to 8. The D = 4 kernel of attention_bwd.cu is left as
// it is, bit for bit.
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
// The bias (no model of the repo passes one at these head dims) is read
// from global memory, where the batch finds it in L2.

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

// B4 (the wide dq pass's kWin, and attention_rpos_bwd_mma.cuh): the dq
// pass's ds of this lane's rows r0 (v[0] at key m,
// v[1] at m + 1) and r0 + 8 (v[2], v[3]) where the window holds both the
// row and the key, into head bh's (W', W') block of the scratch `ds`,
// window-relative. ok0, ok1: the rows are the head's (heads past the
// batch hold none).
__device__ __forceinline__ void store_window_ds(float* __restrict__ ds, Window win, long long bh,
                                                int Wp, int r0, bool ok0, bool ok1, int m,
                                                const float (&v)[4]) {
  const size_t head = static_cast<size_t>(bh) * Wp;
  const int k0 = m - win.lo;  // the keys' place in the window
  if (ok0 && win.has(r0)) {
    float* row = ds + (head + (r0 - win.lo)) * Wp;
    if (win.has(m)) row[k0] = v[0];
    if (win.has(m + 1)) row[k0 + 1] = v[1];
  }
  if (ok1 && win.has(r0 + 8)) {
    float* row = ds + (head + (r0 + 8 - win.lo)) * Wp;
    if (win.has(m)) row[k0] = v[2];
    if (win.has(m + 1)) row[k0 + 1] = v[3];
  }
}

template <typename T, int D, bool kBias>
__global__ void __launch_bounds__(kMmaThreads)
attention_bwd_dq_mma_kernel(const T* __restrict__ q, const T* __restrict__ k,
                            const T* __restrict__ v, const T* __restrict__ bias,
                            const T* __restrict__ g, const T* __restrict__ o,
                            const float* __restrict__ lse, float* __restrict__ c,
                            T* __restrict__ dq, int B, int H, int L) {
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
          if (m < L) {
            s[i][0] += w.ok0 ? to_float(brow0[m]) : 0.f;
            s[i][2] += w.ok1 ? to_float(brow1[m]) : 0.f;
          }
          if (m + 1 < L) {
            s[i][1] += w.ok0 ? to_float(brow0[m + 1]) : 0.f;
            s[i][3] += w.ok1 ? to_float(brow1[m + 1]) : 0.f;
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

template <typename T, int D, bool kBias>
__global__ void __launch_bounds__(kMmaThreads)
attention_bwd_dkdv_mma_kernel(const T* __restrict__ q, const T* __restrict__ k,
                              const T* __restrict__ v, const T* __restrict__ bias,
                              const T* __restrict__ g, const float* __restrict__ lse,
                              const float* __restrict__ c, T* __restrict__ dk,
                              T* __restrict__ dv, int B, int H, int L) {
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
          if (l < L) {
            p[i][0] += w.ok0 ? to_float(bcol0[static_cast<size_t>(l) * L]) : 0.f;
            p[i][2] += w.ok1 ? to_float(bcol1[static_cast<size_t>(l) * L]) : 0.f;
          }
          if (l + 1 < L) {
            p[i][1] += w.ok0 ? to_float(bcol0[static_cast<size_t>(l + 1) * L]) : 0.f;
            p[i][3] += w.ok1 ? to_float(bcol1[static_cast<size_t>(l + 1) * L]) : 0.f;
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

// B2's dbias pass, dbias = sum_b ds.
template <typename T, int D>
__global__ void __launch_bounds__(kMmaThreads)
attention_bwd_dbias_mma_kernel(const T* __restrict__ q, const T* __restrict__ k,
                               const T* __restrict__ v, const T* __restrict__ bias,
                               const T* __restrict__ g, const float* __restrict__ lse,
                               const float* __restrict__ c, float* __restrict__ dbias, int B,
                               int H, int L) {
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
  // Element b in buffer b & 1 of the ring.
  stage_pair<T, D>(ring, ring + kTile * kS, k, v, 1, kTile, h, n_heads, L, m0);
  for (int b = 0; b < B; ++b) {
    asm volatile("cp.async.wait_group 0;\n" ::);
    __syncthreads();
    if (b + 1 < B) {
      float* nb = ring + ((b + 1) & 1) * kStage;
      stage_pair<T, D>(nb, nb + kTile * kS, k, v, 1, kTile,
                       static_cast<long long>(b + 1) * H + h, n_heads, L, m0);
    }
    const float* ks = ring + (b & 1) * kStage;
    const float* vs = ks + kTile * kS;
    const size_t row0 = (static_cast<size_t>(b) * H + h) * L + r0;
    Frag<D> qf, gf;
    load_frag<T, D>(qf, q, row0, ok0, ok1, tq);
    load_frag<T, D>(gf, g, row0, ok0, ok1, tq);
    const float lse0 = ok0 ? lse[row0] : 0.f, lse1 = ok1 ? lse[row0 + 8] : 0.f;
    const float c0 = ok0 ? c[row0] : 0.f, c1 = ok1 ? c[row0 + 8] : 0.f;
#pragma unroll
    for (int j = 0; j < kNT; ++j) {
      float s[4] = {0.f, 0.f, 0.f, 0.f}, dp[4] = {0.f, 0.f, 0.f, 0.f};
      strip_dot<D, kExact>(s, qf, ks + (8 * j + gq) * kS + tq);
      strip_dot<D, kExact>(dp, gf, vs + (8 * j + gq) * kS + tq);
      const int m = m0 + 8 * j + 2 * tq;
      // ds = exp(s + bias - lse) (dP - c), summed over b in order.
      if (m < L) {
        acc[j][0] += ok0 ? __expf(s[0] + to_float(brow0[m]) - lse0) * (dp[0] - c0) : 0.f;
        acc[j][2] += ok1 ? __expf(s[2] + to_float(brow1[m]) - lse1) * (dp[2] - c1) : 0.f;
      }
      if (m + 1 < L) {
        acc[j][1] += ok0 ? __expf(s[1] + to_float(brow0[m + 1]) - lse0) * (dp[1] - c0) : 0.f;
        acc[j][3] += ok1 ? __expf(s[3] + to_float(brow1[m + 1]) - lse1) * (dp[3] - c1) : 0.f;
      }
    }
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

template <typename T, int D, bool kBias>
cudaError_t launch_mma_passes(const T* q, const T* k, const T* v, const T* bias, const T* g,
                              const T* o, const float* lse, float* c, T* dq, T* dk, T* dv, int B,
                              int H, int L, cudaStream_t stream) {
  static const cudaError_t allowed_dq =
      allow_smem(attention_bwd_dq_mma_kernel<T, D, kBias>, mma_smem_bytes<D>(false));
  static const cudaError_t allowed_dkdv =
      allow_smem(attention_bwd_dkdv_mma_kernel<T, D, kBias>, mma_smem_bytes<D>(true));
  if (allowed_dq != cudaSuccess) return allowed_dq;
  if (allowed_dkdv != cudaSuccess) return allowed_dkdv;
  const MmaTiling t(L);
  const long long groups = (static_cast<long long>(B) * H + t.heads - 1) / t.heads;
  const long long blocks = groups * t.tiles;
  if (blocks > 0x7fffffffLL) return cudaErrorInvalidValue;
  attention_bwd_dq_mma_kernel<T, D, kBias>
      <<<static_cast<int>(blocks), kMmaThreads, mma_smem_bytes<D>(false), stream>>>(
          q, k, v, bias, g, o, lse, c, dq, B, H, L);
  const cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess) return err;
  attention_bwd_dkdv_mma_kernel<T, D, kBias>
      <<<static_cast<int>(blocks), kMmaThreads, mma_smem_bytes<D>(true), stream>>>(
          q, k, v, bias, g, lse, c, dk, dv, B, H, L);
  return cudaGetLastError();
}

// B2's passes on the template, and its dbias pass where dbias is asked for.
template <typename T, int D>
cudaError_t launch_mma_d(const void* q, const void* k, const void* v, const void* bias,
                         const void* g, const void* o, const float* lse, float* c, void* dq,
                         void* dk, void* dv, float* dbias, int B, int H, int L,
                         cudaStream_t stream) {
  const T* qt = static_cast<const T*>(q);
  const T* kt = static_cast<const T*>(k);
  const T* vt = static_cast<const T*>(v);
  const T* bt = static_cast<const T*>(bias);
  const T* gt = static_cast<const T*>(g);
  const T* ot = static_cast<const T*>(o);
  T* dqt = static_cast<T*>(dq);
  T* dkt = static_cast<T*>(dk);
  T* dvt = static_cast<T*>(dv);
  const cudaError_t err =
      bt != nullptr
          ? launch_mma_passes<T, D, true>(qt, kt, vt, bt, gt, ot, lse, c, dqt, dkt, dvt, B, H, L,
                                          stream)
          : launch_mma_passes<T, D, false>(qt, kt, vt, bt, gt, ot, lse, c, dqt, dkt, dvt, B, H, L,
                                           stream);
  if (err != cudaSuccess || dbias == nullptr) return err;
  static const cudaError_t allowed =
      allow_smem(attention_bwd_dbias_mma_kernel<T, D>, mma_smem_bytes<D>(false));
  if (allowed != cudaSuccess) return allowed;
  const long long tiles = (L + kTile - 1) / kTile;
  const long long blocks = H * tiles * tiles;  // then tiles * tiles fits an int too
  if (blocks > 0x7fffffffLL) return cudaErrorInvalidValue;
  attention_bwd_dbias_mma_kernel<T, D>
      <<<static_cast<int>(blocks), kMmaThreads, mma_smem_bytes<D>(false), stream>>>(
          qt, kt, vt, bt, gt, lse, c, dbias, B, H, L);
  return cudaGetLastError();
}

// B2's template at head dim D = 8, 16, 32 or 64; any other D is refused.
// `dbias` null or the dbias output.
template <typename T>
cudaError_t launch_mma(const void* q, const void* k, const void* v, const void* bias,
                       const void* g, const void* o, const float* lse, float* c, void* dq,
                       void* dk, void* dv, float* dbias, int B, int H, int L, int D,
                       cudaStream_t stream) {
  switch (D) {
    case 8:
      return launch_mma_d<T, 8>(q, k, v, bias, g, o, lse, c, dq, dk, dv, dbias, B, H, L, stream);
    case 16:
      return launch_mma_d<T, 16>(q, k, v, bias, g, o, lse, c, dq, dk, dv, dbias, B, H, L, stream);
    case 32:
      return launch_mma_d<T, 32>(q, k, v, bias, g, o, lse, c, dq, dk, dv, dbias, B, H, L, stream);
    case 64:
      return launch_mma_d<T, 64>(q, k, v, bias, g, o, lse, c, dq, dk, dv, dbias, B, H, L, stream);
    default:
      return cudaErrorInvalidValue;
  }
}


// ---------------------------------------------------------------------------
// head_dim past 64: the three passes for every D that is a multiple of 64
// (the wrapper zero-pads any other D > 64 up to the next one), for
// Transformer1d with 128- and 256-wide heads and B4 past 64. The mma
// template above is left as it is.
//
// What bounds it on this card: the template's work, 10*L*L*D flops a (b,
// h) on mma.sync at 3xTF32, but what the template keeps per thread grows
// with D, and its ring passes the per-block limit at D = 256, so D is cut
// into 64-wide chunks, as in B1's wide kernel (attention_fwd_mma.cuh). The
// first design gave a block one 64-wide part of its outputs and had
// it contract S = q.k^T and dP = g.v^T over the whole D: at D = 256 the dq
// pass did about 9 L^2 D products where 3 are needed, the dk/dv pass 10
// where 4 are, and the dk/dv pass sat at 255 registers with 64-88 bytes of
// stack. Here, as in B1's, the blocks of one tile form a thread-block
// cluster along gridDim.y, each owning consecutive chunks and their output
// parts (WideSplit, DkdvSplit):
// * dq pass: per key tile a block contracts the partial dP over its (g, V)
//   chunks and S over its (q, K) chunks (stages of two 64 x 68 f32 planes,
//   bf16 widened as it lands), exchanges both with the cluster (one
//   64 x 64 f32 tile each, 32 KB) and sums every block's partials in rank
//   order through distributed shared memory; every block then holds the
//   same S and dP, forms p = exp(S + bias - lse) and ds = p (dP - c), and
//   adds dq_part += ds.K_part: the K chunk it staged for S where it owns
//   one chunk, else the part's K staged again. c = g.o is summed over the
//   whole D by every block alike; rank 0 writes it. In the window mode
//   rank 0 also writes the head's windowed ds to the dtoep scratch
//   (`store_window_ds`).
// * dk/dv pass, its transpose (a warp's 16 keys against the tile's query
//   rows), with one role a block: of a cluster of 2 * half blocks
//   (DkdvSplit), the first half contract the partial S^T = k.q^T over
//   their chunks and add dv_part += p^T.g, the second half contract dP^T =
//   v.g^T and add dk_part += ds^T.q. After the exchange (one 64 x 64 f32
//   partial a block) a dv block sums the first half's partials into S^T, a
//   dk block both halves' into S^T and dP^T; a stage of the tile's g (or
//   q) over the part, with the rows' lse and c, then gives p^T (and ds^T)
//   and the product. Each product is computed once, and a block holds one
//   part's accumulator and at most two strips (S^T, dP^T), not the four
//   strips and two accumulators on which the first design spilled at 255
//   registers.
// * Where a block owns several chunks (D > 512 in the dq pass, D > 256 in
//   the dk/dv pass) it walks the tiles once a part, the cluster re-forming
//   S and dP from its chunks each time: a block's state stays one part's,
//   so every D runs in the same shared memory (102,400 bytes the dq pass,
//   87,040 the dk/dv pass). A block holds one part's accumulator at bf16
//   too: with two, as B1's bf16 blocks hold, these passes spill.
// * dbias (B2 only): a block owns one head and a 64 x 64 (l, m) tile and
//   walks the batch in order; per element 2 * chunks stages of (q, K) and
//   (g, V) chunks, S and dP summed over them, then ds into the tile's f32
//   accumulators in b order. dbias is not split by D.
// No atomics, and the exchanges sum in rank order: a call gives
// bit-identical results every time.

constexpr int kWideD = 64;      // dims of a chunk of D, and of a block's output part
constexpr int kMaxCluster = 8;  // blocks of a portable cluster

// How the dq pass cuts D, the same on host and device: `chunks` 64-wide
// chunks, `per` consecutive chunks (and output parts) a block, clusters of
// `size` blocks (B1's cut at f32).
struct WideSplit {
  int chunks, per, size;
  __host__ __device__ explicit WideSplit(int D) {
    chunks = D / kWideD;
    per = (chunks + kMaxCluster - 1) / kMaxCluster;
    size = (chunks + per - 1) / per;
  }
};

// Thread-block clusters (sm_90), as in attention_fwd_mma.cuh: the block's
// rank, the cluster barrier (arrive releases, wait acquires) and a block's
// shared memory.
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

constexpr int kNT = kTile / 8;  // 8-wide n-tiles of a 64-key strip

// The fragments [lo, hi) of a 64-key strip that block `r` of `n` sums for
// the others in a reduce-scatter.
__device__ __forceinline__ int share_lo(int r, int n) { return r * kNT / n; }

// y[j] = 0 + the fragment j of `buf` (2 kNT * kMmaThreads float4, at strip
// `strip`) in the blocks `r0 + r`, r in [0, n), in rank order, for the
// fragments j of [lo, hi); the others are left as they are.
__device__ __forceinline__ void range_sum(float (&y)[kNT][4], const float4* buf, int strip, int r0,
                                          int n, int lo, int hi) {
#pragma unroll
  for (int j = 0; j < kNT; ++j) {
    if (j >= lo && j < hi) y[j][0] = y[j][1] = y[j][2] = y[j][3] = 0.f;
  }
  for (int r = 0; r < n; ++r) {
    const uint32_t at = cluster_map(buf + threadIdx.x, r0 + r);
#pragma unroll
    for (int j = 0; j < kNT; ++j) {
      if (j >= lo && j < hi) add_cluster(y[j], at + (strip * kNT + j) * kMmaThreads * 16);
    }
  }
}

// y[j] = the fragment j of block `r`'s `buf` at strip `strip`, for j in
// [lo, hi).
__device__ __forceinline__ void gather(float (&y)[kNT][4], const float4* buf, int strip, int r,
                                       int lo, int hi) {
  const uint32_t at = cluster_map(buf + threadIdx.x, r);
#pragma unroll
  for (int j = 0; j < kNT; ++j) {
    if (j >= lo && j < hi) {
      y[j][0] = y[j][1] = y[j][2] = y[j][3] = 0.f;
      add_cluster(y[j], at + (strip * kNT + j) * kMmaThreads * 16);
    }
  }
}

__device__ __forceinline__ void put(float4* buf, int strip, const float (&y)[kNT][4], int lo,
                                    int hi) {
#pragma unroll
  for (int j = 0; j < kNT; ++j) {
    if (j >= lo && j < hi) {
      buf[(strip * kNT + j) * kMmaThreads + threadIdx.x] =
          make_float4(y[j][0], y[j][1], y[j][2], y[j][3]);
    }
  }
}

// a and b = the sums of the cluster's `size` blocks' a and b, in rank order
// from 0 (0 + a_0 + a_1 + ...), so that every block gets the same bits.
// Each thread holds the same (row, key) fragments in every block; `buf` (2
// * kNT * kMmaThreads float4 of this block's shared memory: strips a, b)
// takes this block's, a fragment's threads contiguous. A reduce-scatter,
// then an all-gather: block r sums fragments [share_lo(r), share_lo(r + 1))
// of every block's a and b and leaves the sums in its `buf` in place of its
// own (no other block reads those there), from where every block gathers
// them: a block reads about 4 kNT fragments' worth of the cluster's shared
// memory, not 2 size kNT. Every thread calls it after a cluster_arrive
// that frees `buf`: it waits until every block is done with the last
// exchange, and arrives again once it has gathered.
__device__ __forceinline__ void cluster_sum(float (&a)[kNT][4], float (&b)[kNT][4], float4* buf,
                                            int rank, int size) {
  cluster_wait();
  put(buf, 0, a, 0, kNT);
  put(buf, 1, b, 0, kNT);
  cluster_arrive();
  cluster_wait();
  const int lo = share_lo(rank, size), hi = share_lo(rank + 1, size);
  range_sum(a, buf, 0, 0, size, lo, hi);
  range_sum(b, buf, 1, 0, size, lo, hi);
  put(buf, 0, a, lo, hi);
  put(buf, 1, b, lo, hi);
  cluster_arrive();
  cluster_wait();
  for (int r = 0; r < size; ++r) {
    if (r == rank) continue;
    gather(a, buf, 0, r, share_lo(r, size), share_lo(r + 1, size));
    gather(b, buf, 1, r, share_lo(r, size), share_lo(r + 1, size));
  }
  cluster_arrive();
}

// The ring of two stages of two (kTile x 68) f32 planes, then the exchange:
// the dq pass's S and dP (2 x 64 x 64 f32); the dk/dv pass's one partial,
// after the tiles' lse and c.
__host__ __device__ constexpr int wide_smem_bytes(bool dkdv) {
  return mma_smem_bytes<kWideD>(dkdv) + (dkdv ? 1 : 2) * kTile * kTile * 4;
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

// kWin: `ds` takes the windowed ds (rank 0); else null.
template <typename T, bool kBias, bool kWin>
__global__ void __launch_bounds__(kMmaThreads)
attention_bwd_dq_wide_kernel(const T* __restrict__ q, const T* __restrict__ k,
                             const T* __restrict__ v, const T* __restrict__ bias,
                             const T* __restrict__ g, const T* __restrict__ o,
                             const float* __restrict__ lse, float* __restrict__ c,
                             T* __restrict__ dq, float* __restrict__ ds, int B, int H, int L,
                             int D, const float* __restrict__ offsets, int W) {
  constexpr bool kExact = sizeof(T) == 2;
  constexpr int kS = mma_stride<kWideD>();
  constexpr int kPlane = kTile * kS;
  extern __shared__ __align__(16) float ring[];  // [stage][2 planes][kPlane], then the exchange
  float4* xchg = reinterpret_cast<float4*>(ring + 4 * kPlane);
  const WideSplit sp(D);
  const int rank = cluster_rank();
  const int ch0 = rank * sp.per;                // this block's chunks ch0 ..
  const int nc = min(sp.per, sp.chunks - ch0);  // .. ch0 + nc - 1
  const MmaTiling t(L);
  const long long n_heads = static_cast<long long>(B) * H;
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31, gq = lane >> 2, tq = lane & 3;
  const MmaRows w(t, H, n_heads, L, warp, gq);
  const size_t row0 = w.base + w.r0;
  const int first = (blockIdx.x % t.tiles) * t.rows;  // the block's query rows

  // c = g.o of both rows over the whole D: dims tq, tq + 4, ... a lane,
  // summed across the quad; every block alike, rank 0 writes it.
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
  if (tq == 0 && rank == 0) {
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
  // sp.per passes over the key tiles, pass p for part ch0 + p where p < nc
  // (the cluster's last block may own fewer chunks: its extra passes only
  // contract, for the others). Per key tile: nc stages of (g, V) chunks, nc
  // of (q, K) chunks, then, where the block owns several, the part's K.
  const bool reuse = nc == 1;  // the (q, K) stage's K is the part's
  const int per_tile = 2 * nc + (reuse ? 0 : 1);
  const int n_stages = sp.per * t.tiles * per_tile;
  auto stage = [&](int st) {
    float* buf = ring + (st & 1) * 2 * kPlane;
    const int tc = st / per_tile, ix = st - tc * per_tile;
    const int kt = tc % t.tiles, part = tc / t.tiles;
    if (ix < 2 * nc) {
      const bool qk = ix >= nc;
      const int col = (ch0 + (qk ? ix - nc : ix)) * kWideD;
      stage_wide<T>(buf, qk ? q : g, t.heads, t.rows, w.head0, n_heads, L, D, first, col);
      stage_wide<T>(buf + kPlane, qk ? k : v, t.heads, t.rows, w.head0, n_heads, L, D,
                    kt * t.rows, col);
    } else if (part < nc) {
      stage_wide<T>(buf + kPlane, k, t.heads, t.rows, w.head0, n_heads, L, D, kt * t.rows,
                    (ch0 + part) * kWideD);
    }
    asm volatile("cp.async.commit_group;\n" ::);
  };

  float s[kNT][4], dp[kNT][4];
  stage(0);
  cluster_arrive();  // this block's exchange buffer is free
  for (int st = 0; st < n_stages; ++st) {
    asm volatile("cp.async.wait_group 0;\n" ::);
    __syncthreads();  // stage st is in; every thread is done with stage st - 1's buffer
    if (st + 1 < n_stages) stage(st + 1);
    const float* buf = ring + (st & 1) * 2 * kPlane;
    const int tc = st / per_tile, ix = st - tc * per_tile;
    const int kt = tc % t.tiles, pass = tc / t.tiles;
    if (ix < 2 * nc) {
      if (ix == 0) {
        zero_tiles(s);
        zero_tiles(dp);
      }
      const float* as = buf + 16 * warp * kS;                 // this warp's rows of g (q)
      const float* bs = buf + kPlane + w.slot * t.rows * kS;  // its head's keys of V (K)
      if (ix < nc) {
        chunk_dot<kExact>(dp, as, bs, nj, gq, tq);
      } else {
        chunk_dot<kExact>(s, as, bs, nj, gq, tq);
      }
      if (ix + 1 < 2 * nc) continue;
      // S and dP over the whole D from the cluster; ds = p (dP - c), p =
      // exp(s + bias - lse); 0 at keys past L.
      cluster_sum(s, dp, xchg, rank, sp.size);
      const int key0 = kt * t.rows;
#pragma unroll
      for (int j = 0; j < kNT; ++j) {
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
        if constexpr (kWin) {
          if (rank == 0 && pass == 0) {
            store_window_ds(ds, bias_window<kWin, kMmaWarps, sizeof(T) == 4>(warp, L), w.bh,
                            W < L ? W : L, w.r0, w.ok0, w.ok1, m, s[j]);
          }
        }
      }
      if (!reuse) continue;
    }
    if (pass >= nc) continue;  // no part of its own this pass
    const float* ks = buf + kPlane + w.slot * t.rows * kS;  // the part of the head's keys
#pragma unroll
    for (int j = 0; j < kNT; ++j) {
      if (j >= nj) break;
      strip_acc<kWideD, kExact>(acc, s[j], ks + (8 * j + 2 * tq) * kS + gq);  // dq += ds.k
    }
    if (kt + 1 < t.tiles) continue;
    store_part<T>(dq, row0, D, ch0 + pass, w.ok0, w.ok1, acc, tq);
#pragma unroll
    for (int n = 0; n < kWideD / 8; ++n) acc[n][0] = acc[n][1] = acc[n][2] = acc[n][3] = 0.f;
  }
  cluster_wait();  // pairs the last exchange's arrive: no block leaves while its buffer is read
}

// The dk/dv pass gives every block one role: a dv block contracts S^T =
// k.q^T over its chunks and adds dv over their parts; a dk block contracts
// dP^T = v.g^T and adds dk. `half` blocks of each role, `per` consecutive
// chunks a block (ceil(chunks / 4)), clusters of 2 * half <= 8 blocks.
struct DkdvSplit {
  int chunks, per, half, size;
  __host__ __device__ explicit DkdvSplit(int D) {
    chunks = D / kWideD;
    per = (chunks + kMaxCluster / 2 - 1) / (kMaxCluster / 2);
    half = (chunks + per - 1) / per;
    size = 2 * half;
  }
};

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
  // [stage][2 planes][kPlane], then [stage][lse, c][kTile], then the exchange
  extern __shared__ __align__(16) float ring[];
  float* scal = ring + 4 * kPlane;
  float4* xchg = reinterpret_cast<float4*>(scal + 4 * kTile);
  const DkdvSplit sp(D);
  const int rank = cluster_rank();
  const bool dk_role = rank >= sp.half;
  const int ch0 = (dk_role ? rank - sp.half : rank) * sp.per;  // this block's chunks ch0 ..
  const int nc = min(sp.per, sp.chunks - ch0);                 // .. ch0 + nc - 1
  const MmaTiling t(L);
  const long long n_heads = static_cast<long long>(B) * H;
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31, gq = lane >> 2, tq = lane & 3;
  const MmaRows w(t, H, n_heads, L, warp, gq);  // here the rows are keys
  const size_t row0 = w.base + w.r0;
  const int first = (blockIdx.x % t.tiles) * t.rows;  // the block's keys
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
  float acc[kWideD / 8][4];  // dk's or dv's part
#pragma unroll
  for (int n = 0; n < kWideD / 8; ++n) acc[n][0] = acc[n][1] = acc[n][2] = acc[n][3] = 0.f;
  const int nj = t.rows / 8;
  // sp.per passes over the query tiles, as the dq pass's. Per query tile:
  // nc stages of this block's keys' chunk (k, or v) and the tile rows' (q,
  // or g), then the part of the product's other operand (g, or q) with the
  // rows' lse and c.
  const int per_tile = nc + 1;
  const int n_stages = sp.per * t.tiles * per_tile;
  auto stage = [&](int st) {
    float* buf = ring + (st & 1) * 2 * kPlane;
    const int tc = st / per_tile, ix = st - tc * per_tile;
    const int lt = tc % t.tiles, part = tc / t.tiles;
    if (ix < nc) {
      const int col = (ch0 + ix) * kWideD;
      stage_wide<T>(buf, dk_role ? v : k, t.heads, t.rows, w.head0, n_heads, L, D, first, col);
      stage_wide<T>(buf + kPlane, dk_role ? g : q, t.heads, t.rows, w.head0, n_heads, L, D,
                    lt * t.rows, col);
    } else if (part < nc) {
      stage_wide<T>(buf, dk_role ? q : g, t.heads, t.rows, w.head0, n_heads, L, D, lt * t.rows,
                    (ch0 + part) * kWideD);
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

  // x: this block's partial (S^T, or dP^T), then S^T (dv) or dP^T (dk)
  // over the whole D; p: a dk block's S^T over the whole D, then p^T.
  float x[kNT][4], p[kNT][4];
  stage(0);
  cluster_arrive();  // this block's exchange buffer is free (a cluster has two blocks or more)
  for (int st = 0; st < n_stages; ++st) {
    asm volatile("cp.async.wait_group 0;\n" ::);
    __syncthreads();
    if (st + 1 < n_stages) stage(st + 1);
    const float* buf = ring + (st & 1) * 2 * kPlane;
    const int tc = st / per_tile, ix = st - tc * per_tile;
    const int lt = tc % t.tiles, pass = tc / t.tiles;
    if (ix < nc) {
      if (ix == 0) zero_tiles(x);
      // S^T = k.q^T, or dP^T = v.g^T, over this chunk: this warp's keys
      // against its head's tile rows.
      chunk_dot<kExact>(x, buf + 16 * warp * kS, buf + kPlane + w.slot * t.rows * kS, nj, gq,
                        tq);
      if (ix + 1 < nc) continue;
      // The cluster's S^T (the dv blocks' partials) and, for a dk block,
      // dP^T (the dk blocks'), by a reduce-scatter within each role (block
      // i of a role sums that role's fragments [share_lo(i), share_lo(i +
      // 1)) and leaves them in place of its own), then an all-gather.
      cluster_wait();  // every block is done with the last exchange
      put(xchg, 0, x, 0, kNT);
      cluster_arrive();
      cluster_wait();
      const int idx = dk_role ? rank - sp.half : rank, g0 = dk_role ? sp.half : 0;
      const int lo = share_lo(idx, sp.half), hi = share_lo(idx + 1, sp.half);
      range_sum(x, xchg, 0, g0, sp.half, lo, hi);
      put(xchg, 0, x, lo, hi);
      cluster_arrive();
      cluster_wait();
      for (int r = 0; r < sp.half; ++r) {
        const int rlo = share_lo(r, sp.half), rhi = share_lo(r + 1, sp.half);
        if (dk_role) {
          gather(p, xchg, 0, r, rlo, rhi);  // S^T from the dv blocks
          if (r != idx) gather(x, xchg, 0, sp.half + r, rlo, rhi);  // dP^T
        } else if (r != idx) {
          gather(x, xchg, 0, r, rlo, rhi);
        }
      }
      cluster_arrive();
      continue;
    }
    if (pass >= nc) continue;  // no part of its own this pass
    const float* os = buf + w.slot * t.rows * kS;  // the part of g (dv) or q (dk)
    const float* ls = scal + (st & 1) * 2 * kTile + w.slot * t.rows;
    const float* css = ls + kTile;
    const int l0 = lt * t.rows;
    // p^T = exp(s^T + bias - lse[l]) in place (lse +inf past L: 0).
    auto to_p = [&](float (&sj)[4], int j) {
      const int li = 8 * j + 2 * tq;  // query of c0, c2 in the tile; li + 1 of c1, c3
      const int l = l0 + li;
      if constexpr (kBias) {
        // The keys that take a bias, and the query rows (the template's).
        const Window win = bias_window<kWin, kMmaWarps, sizeof(T) == 4>(warp, L);
        const bool in0 = kWin ? w.ok0 && win.has(w.r0) : w.ok0;
        const bool in1 = kWin ? w.ok1 && win.has(w.r0 + 8) : w.ok1;
        if (in_bias<kWin>(win, l, L)) {
          sj[0] += in0 ? to_float(bcol0[static_cast<size_t>(l) * L]) : 0.f;
          sj[2] += in1 ? to_float(bcol1[static_cast<size_t>(l) * L]) : 0.f;
        }
        if (in_bias<kWin>(win, l + 1, L)) {
          sj[1] += in0 ? to_float(bcol0[static_cast<size_t>(l + 1) * L]) : 0.f;
          sj[3] += in1 ? to_float(bcol1[static_cast<size_t>(l + 1) * L]) : 0.f;
        }
      }
      const float la = ls[li], lb = ls[li + 1];
      sj[0] = __expf(sj[0] - la);
      sj[1] = __expf(sj[1] - lb);
      sj[2] = __expf(sj[2] - la);
      sj[3] = __expf(sj[3] - lb);
    };
    if (dk_role) {
#pragma unroll
      for (int j = 0; j < kNT; ++j) {
        if (j >= nj) break;
        to_p(p[j], j);
        // ds^T = p^T (dP^T - c[l]); dk += ds^T.q
        const int li = 8 * j + 2 * tq;
        const float ca = css[li], cb = css[li + 1];
        x[j][0] = p[j][0] * (x[j][0] - ca);
        x[j][1] = p[j][1] * (x[j][1] - cb);
        x[j][2] = p[j][2] * (x[j][2] - ca);
        x[j][3] = p[j][3] * (x[j][3] - cb);
        strip_acc<kWideD, kExact>(acc, x[j], os + (8 * j + 2 * tq) * kS + gq);
      }
    } else {
#pragma unroll
      for (int j = 0; j < kNT; ++j) {
        if (j >= nj) break;
        to_p(x[j], j);
        strip_acc<kWideD, kExact>(acc, x[j], os + (8 * j + 2 * tq) * kS + gq);  // dv += p^T.g
      }
    }
    if (lt + 1 < t.tiles) continue;
    store_part<T>(dk_role ? dk : dv, row0, D, ch0 + pass, w.ok0, w.ok1, acc, tq);
#pragma unroll
    for (int n = 0; n < kWideD / 8; ++n) acc[n][0] = acc[n][1] = acc[n][2] = acc[n][3] = 0.f;
  }
  cluster_wait();  // pairs the last exchange's arrive: no block leaves while its buffer is read
}

// B2's dbias pass at D past 64, as the template's.
template <typename T>
__global__ void __launch_bounds__(kMmaThreads)
attention_bwd_dbias_wide_kernel(const T* __restrict__ q, const T* __restrict__ k,
                                const T* __restrict__ v, const T* __restrict__ bias,
                                const T* __restrict__ g, const float* __restrict__ lse,
                                const float* __restrict__ c, float* __restrict__ dbias, int B,
                                int H, int L, int D) {
  constexpr bool kExact = sizeof(T) == 2;
  constexpr int kS = mma_stride<kWideD>();
  constexpr int kPlane = kTile * kS;
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
  // Stage st: element st / per, step cs = st % per: chunk cs of (q, K),
  // then chunk cs - chunks of (g, V).
  const int per = 2 * chunks;
  const long long n_stages = static_cast<long long>(B) * per;
  auto stage = [&](long long st) {
    float* buf = ring + (st & 1) * 2 * kPlane;
    const int cs = static_cast<int>(st % per);
    const bool second = cs >= chunks;
    const int col = (second ? cs - chunks : cs) * kWideD;
    const long long bh = st / per * H + h;
    stage_wide<T>(buf, second ? g : q, 1, kTile, bh, n_heads, L, D, l0, col);
    stage_wide<T>(buf + kPlane, second ? v : k, 1, kTile, bh, n_heads, L, D, m0, col);
    asm volatile("cp.async.commit_group;\n" ::);
  };

  float s[kNT][4], dp[kNT][4];
  stage(0);
  for (long long st = 0; st < n_stages; ++st) {
    asm volatile("cp.async.wait_group 0;\n" ::);
    __syncthreads();
    if (st + 1 < n_stages) stage(st + 1);
    const int cs = static_cast<int>(st % per);
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
    const size_t row0 = (static_cast<size_t>(st / per) * H + h) * L + r0;
    const float lse0 = ok0 ? lse[row0] : 0.f, lse1 = ok1 ? lse[row0 + 8] : 0.f;
    const float c0 = ok0 ? c[row0] : 0.f, c1 = ok1 ? c[row0 + 8] : 0.f;
#pragma unroll
    for (int j = 0; j < kNT; ++j) {
      const int m = m0 + 8 * j + 2 * tq;
      // ds = exp(s + bias - lse) (dP - c), summed over b in order.
      if (m < L) {
        acc[j][0] += ok0 ? __expf(s[j][0] + to_float(brow0[m]) - lse0) * (dp[j][0] - c0) : 0.f;
        acc[j][2] += ok1 ? __expf(s[j][2] + to_float(brow1[m]) - lse1) * (dp[j][2] - c1) : 0.f;
      }
      if (m + 1 < L) {
        acc[j][1] +=
            ok0 ? __expf(s[j][1] + to_float(brow0[m + 1]) - lse0) * (dp[j][1] - c0) : 0.f;
        acc[j][3] +=
            ok1 ? __expf(s[j][3] + to_float(brow1[m + 1]) - lse1) * (dp[j][3] - c1) : 0.f;
      }
    }
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

template <typename T, bool kBias, bool kWin>
cudaError_t allow_wide() {
  static const cudaError_t allowed_dq =
      allow_smem(attention_bwd_dq_wide_kernel<T, kBias, kWin>, wide_smem_bytes(false));
  static const cudaError_t allowed_dkdv =
      allow_smem(attention_bwd_dkdv_wide_kernel<T, kBias, kWin>, wide_smem_bytes(true));
  return allowed_dq != cudaSuccess ? allowed_dq : allowed_dkdv;
}

template <typename T, bool kBias, bool kWin>
cudaError_t launch_wide_passes(const T* q, const T* k, const T* v, const T* bias, const T* g,
                               const T* o, const float* lse, float* c, T* dq, T* dk, T* dv,
                               float* ds, int B, int H, int L, int D, const float* offsets, int W,
                               cudaStream_t stream) {
  const cudaError_t allowed = allow_wide<T, kBias, kWin>();
  if (allowed != cudaSuccess) return allowed;
  const MmaTiling t(L);
  const WideSplit sp(D);
  const long long groups = (static_cast<long long>(B) * H + t.heads - 1) / t.heads;
  const long long blocks = groups * t.tiles;
  if (blocks > 0x7fffffffLL) return cudaErrorInvalidValue;
  cudaError_t err;
  {
    ClusterLaunch launch(static_cast<unsigned>(blocks), sp.size, wide_smem_bytes(false), stream);
    err = cudaLaunchKernelEx(&launch.cfg, attention_bwd_dq_wide_kernel<T, kBias, kWin>, q, k, v,
                             bias, g, o, lse, c, dq, ds, B, H, L, D, offsets, W);
  }
  if (err == cudaSuccess) err = cudaGetLastError();
  if (err != cudaSuccess) return err;
  {
    ClusterLaunch launch(static_cast<unsigned>(blocks), DkdvSplit(D).size, wide_smem_bytes(true),
                         stream);
    err = cudaLaunchKernelEx(&launch.cfg, attention_bwd_dkdv_wide_kernel<T, kBias, kWin>, q, k,
                             v, bias, g, lse, c, dk, dv, B, H, L, D, offsets, W);
  }
  return err != cudaSuccess ? err : cudaGetLastError();
}

// B2's wide passes, and its dbias pass where dbias is asked for.
template <typename T>
cudaError_t launch_wide_b2(const T* qt, const T* kt, const T* vt, const T* bt, const T* gt,
                           const T* ot, const float* lse, float* c, T* dqt, T* dkt, T* dvt,
                           float* dbias, int B, int H, int L, int D, cudaStream_t stream) {
  const cudaError_t err =
      bt != nullptr
          ? launch_wide_passes<T, true, false>(qt, kt, vt, bt, gt, ot, lse, c, dqt, dkt, dvt,
                                               nullptr, B, H, L, D, nullptr, 0, stream)
          : launch_wide_passes<T, false, false>(qt, kt, vt, bt, gt, ot, lse, c, dqt, dkt, dvt,
                                                nullptr, B, H, L, D, nullptr, 0, stream);
  if (err != cudaSuccess || dbias == nullptr) return err;
  static const cudaError_t allowed =
      allow_smem(attention_bwd_dbias_wide_kernel<T>, mma_smem_bytes<kWideD>(false));
  if (allowed != cudaSuccess) return allowed;
  const long long tiles = (L + kTile - 1) / kTile;
  const long long blocks = H * tiles * tiles;
  if (blocks > 0x7fffffffLL) return cudaErrorInvalidValue;
  attention_bwd_dbias_wide_kernel<T>
      <<<static_cast<int>(blocks), kMmaThreads, mma_smem_bytes<kWideD>(false), stream>>>(
          qt, kt, vt, bt, gt, lse, c, dbias, B, H, L, D);
  return cudaGetLastError();
}

// The wide passes at D, a multiple of 64 past 64; any other D is refused.
// kWin: B4, `bias` the toep, `dbias` the f32 (B, H, W', W') scratch the dq
// pass fills with the windowed ds, and `offsets` and W the windows (all
// required; attention_rpos_bwd.cu sums the scratch into dtoep); else B2,
// `dbias` null or the dbias output, offsets unused.
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
  if constexpr (kWin) {  // `dbias` is the ds scratch
    return launch_wide_passes<T, true, true>(qt, kt, vt, bt, gt, ot, lse, c, dqt, dkt, dvt,
                                             dbias, B, H, L, D, offsets, W, stream);
  } else {
    return launch_wide_b2<T>(qt, kt, vt, bt, gt, ot, lse, c, dqt, dkt, dvt, dbias, B, H, L, D,
                             stream);
  }
}

template <typename T, bool kBias, bool kWin>
cudaError_t wide_clusters_one(int D, int* out) {
  const cudaError_t allowed = allow_wide<T, kBias, kWin>();
  if (allowed != cudaSuccess) return allowed;
  out[0] = WideSplit(D).size;
  ClusterLaunch dq(1, out[0], wide_smem_bytes(false), nullptr);
  const cudaError_t err = cudaOccupancyMaxActiveClusters(
      out + 1, reinterpret_cast<const void*>(attention_bwd_dq_wide_kernel<T, kBias, kWin>),
      &dq.cfg);
  if (err != cudaSuccess) return err;
  out[2] = DkdvSplit(D).size;
  ClusterLaunch dkdv(1, out[2], wide_smem_bytes(true), nullptr);
  return cudaOccupancyMaxActiveClusters(
      out + 3, reinterpret_cast<const void*>(attention_bwd_dkdv_wide_kernel<T, kBias, kWin>),
      &dkdv.cfg);
}

// The wide passes' clusters at D: out[0] the dq pass's size in blocks, out[1]
// the clusters of it the card holds at once (cudaOccupancyMaxActiveClusters),
// out[2] and out[3] the dk/dv pass's.
template <typename T, bool kWin>
cudaError_t wide_clusters(int D, bool with_bias, int* out) {
  if (D <= kWideD || D % kWideD) return cudaErrorInvalidValue;
  if constexpr (kWin) {
    return wide_clusters_one<T, true, true>(D, out);
  } else {
    return with_bias ? wide_clusters_one<T, true, false>(D, out)
                     : wide_clusters_one<T, false, false>(D, out);
  }
}

}  // namespace mma_bwd
}  // namespace
