// Fused biased attention, backward — RA-LENet's attention gradient on
// Hopper (sm_90a).
//
// Replaces the TPU kernel ecg_denoise_tpu/kernels/attention_pallas.py
// _bwd_kernel (:333), launched through _bwd_call (:767) from _fused_bwd
// (:1287) -> _bwd (:708) -> _bwd_raw (:790).
//
// Computes, for every (b, h), with the forward's log-sum-exp residual lse
// (attention_fwd.cu) and the incoming gradient g of the output o:
//   p[l,m]  = exp(q[l] . k[m] + bias[h,l,m] - lse[l])
//   c[l]    = sum_d g[l,d] * o[l,d]          (the flash delta identity)
//   ds[l,m] = p[l,m] * (g[l] . v[m] - c[l])
//   dq[l]   = sum_m ds[l,m] * k[m]
//   dk[m]   = sum_l ds[l,m] * q[l]
//   dv[m]   = sum_l p[l,m] * g[l]
//   dbias[h,l,m] = sum_b ds[b,h,l,m]          (float32)
// q arrives pre-scaled. Operands are contiguous (B, H, L, D) with D = 4 and
// L <= 256 (D = 8, 16, 32, 64: the mma template of attention_bwd_mma.cuh,
// with the same contract but any L; D a multiple of 64 past 64: the wide
// passes there, any L); bias is a contiguous (1, H, L, L)
// array shared by the batch, or absent. float32 and bfloat16 operands; every product, exp and sum is
// float32, dq, dk and dv are rounded once to the operand dtype, and dbias
// is written in float32 (the caller casts it to the bias dtype). The TPU
// kernel rounds e and ds to bf16 before its products; this one does not.
//
// What bounds it: per (b, h) the work is 2*(5*L*L*D + 3*L*L) flops and
// L*L exps, with D = 4 below every tensor-core shape, so the products run
// on the CUDA cores in f32. By bytes the call moves q, k, v, g, o, dq, dk,
// dv, lse, c, the bias and dbias once: operations bound it at L >= 128 and
// bytes below. The first version of this kernel (three passes, a thread a
// row) was bound by neither. At (L, H, B) = (256, 2, 256) its dq pass read
// the bias one row per thread from global memory (a warp's 4-byte loads
// touched 32 rows) and again for every batch element; its dk/dv pass read
// the bias by column for every element; its dbias pass ran a thread per
// (h, l, m) over the batch, re-reading q, g, lse, c, k and v from global
// memory on every step (about 72 bytes per (b, l, m), 1.2 GB of L2 traffic
// a call at (256, 2, 256)).
//
// Design: three passes, each staging what it reuses in shared memory.
// * dq pass (B1's design, attention_fwd.cu). A block owns one head, a tile
//   of up to 32 query rows and a group of 16 batch elements (more at
//   L < 32, where a warp holds 32 / L groups of rows side by side). It
//   stages its (rows x L) bias tile once, as f32, with an odd row stride
//   (L | 1) so that the 32 lanes' reads at one key fall in 32 banks. K and
//   V stream through in chunks of 32 keys for all its elements,
//   double-buffered with cp.async. Each thread carries its row for 4
//   elements. The lse is given, so one sweep over the keys suffices. Each
//   thread also writes its rows' c to a float32 (B, H, L) scratch for the
//   two later passes. Global bias traffic: (B / 16) * H * L * L * elt.
// * dk/dv pass, its transpose. A block owns one head, a tile of up to 32
//   keys and a group of batch elements; it stages the bias column tile
//   (L x its keys, row stride 32: the lanes' keys are consecutive banks)
//   once per group, and q, g and the (lse, c) pairs stream through in
//   chunks of 32 query rows, double-buffered. Each thread carries its key
//   for 4 elements and sums over l in order.
// * dbias pass. A block owns one head and a tile of 32 query rows (a lane
//   a row) by 4 * P key columns (a warp P columns), and walks the batch
//   in order, b = 0 .. B - 1, in stages of 16 elements: each stage's q, g,
//   lse and c of its rows and k and v of its columns land in shared
//   memory by cp.async, in a ring of three stages, two in flight while one
//   is used. Each thread keeps P accumulators, one per (l, m), and reads k
//   and v of its columns as a warp-wide broadcast. P (1 to 8) is the most
//   columns a thread that still gives at least 256 blocks, about two an
//   SM. Each (b, l, m) costs about 18 instructions (two broadcast loads,
//   the two dot4s, the exp and the adds), and that count, not the number
//   of threads, sets the pass's time: fewer columns a thread, or several
//   lanes sharing one pair's chain through shuffles, measured slower
//   (PERF.md). The TPU walks the batch axis on a sequential grid with the
//   output block as accumulator; here each accumulator's loop over b
//   takes its place.
// * Arithmetic. Each output element is summed by one thread, in the first
//   version's order, with its operations (dot4, __expf(s - lse), the fma
//   order): dq, dk, dv and dbias are the first version's bit for bit. No
//   atomics, no TF32, no cross-block reduction: a call gives bit-identical
//   results every time. bf16 rows land raw and are converted to f32 once,
//   in shared memory, before use.

#include <cuda_bf16.h>
#include <cuda_runtime.h>

#include <cstdint>

#include "attention_bwd_mma.cuh"

namespace {

constexpr int kD = 4;
constexpr int kThreads = 128;
constexpr int kWarps = kThreads / 32;
constexpr int kMaxL = 256;
constexpr int kPer = 4;          // batch elements a thread carries (dq, dk/dv)
constexpr int kChunk = 32;       // keys (dq) or query rows (dk/dv) of one stage
constexpr int kBiasElems = 16;   // batch elements of one dbias stage
constexpr int kBiasDepth = 3;    // dbias stages in flight: the ring's buffers
constexpr int kBiasBlocks = 256; // the dbias grid it aims at: about two blocks an SM
constexpr int kMaxCols = 8;      // key columns a dbias thread carries, at most
static_assert(kChunk <= 32, "the staging loops give each lane one row of a chunk");

__device__ __forceinline__ float4 to_float4(float4 x) { return x; }

__device__ __forceinline__ float4 to_float4(uint2 raw) {  // 4 bf16, low first
  return make_float4(__uint_as_float(raw.x << 16), __uint_as_float(raw.x & 0xffff0000u),
                     __uint_as_float(raw.y << 16), __uint_as_float(raw.y & 0xffff0000u));
}

// One (b, h, l) row of 4 operand values, in the dtype's storage type.
template <typename T> struct Row;
template <> struct Row<float> { using type = float4; };
template <> struct Row<__nv_bfloat16> { using type = uint2; };

template <typename T>
__device__ __forceinline__ float4 load4(const T* p) {
  return to_float4(*reinterpret_cast<const typename Row<T>::type*>(p));
}

__device__ __forceinline__ float to_float(float x) { return x; }
__device__ __forceinline__ float to_float(__nv_bfloat16 x) { return __bfloat162float(x); }

// 16 bytes of bias as f32 values, without taking the chunk's address.
__device__ __forceinline__ void unpack(uint4 c, float (&out)[4]) {
  out[0] = __uint_as_float(c.x);
  out[1] = __uint_as_float(c.y);
  out[2] = __uint_as_float(c.z);
  out[3] = __uint_as_float(c.w);
}

__device__ __forceinline__ void unpack(uint4 c, float (&out)[8]) {
  const float4 lo = to_float4(make_uint2(c.x, c.y)), hi = to_float4(make_uint2(c.z, c.w));
  out[0] = lo.x; out[1] = lo.y; out[2] = lo.z; out[3] = lo.w;
  out[4] = hi.x; out[5] = hi.y; out[6] = hi.z; out[7] = hi.w;
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

// cp.async of one operand row (16 bytes f32, 8 bytes bf16) or one f32.
template <typename T>
__device__ __forceinline__ void cp_async_row(void* dst, const T* src) {
  const unsigned s = static_cast<unsigned>(__cvta_generic_to_shared(dst));
  if constexpr (sizeof(T) == 4) {
    asm volatile("cp.async.cg.shared.global [%0], [%1], 16;\n" ::"r"(s), "l"(src));
  } else {
    asm volatile("cp.async.ca.shared.global [%0], [%1], 8;\n" ::"r"(s), "l"(src));
  }
}

__device__ __forceinline__ void cp_async_f32(float* dst, const float* src) {
  const unsigned s = static_cast<unsigned>(__cvta_generic_to_shared(dst));
  asm volatile("cp.async.ca.shared.global [%0], [%1], 4;\n" ::"r"(s), "l"(src));
}

__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::);
}

// Wait until at most N of this thread's newest commit groups are pending.
template <int N>
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(N));
}

// The shared memory of a pipelined pass: a ring of kDepth stage buffers,
// each `rows` operand rows (4 values of T) then `scalars` f32 values; for
// bf16 one more buffer holding a stage's rows converted to f32.
template <typename T, int kDepth = 2>
struct Stages {
  static constexpr int kRowBytes = kD * sizeof(T);
  unsigned char* base;
  int rows, bytes;  // bytes: one stage buffer, 16-byte aligned
  __host__ __device__ Stages(unsigned char* base_, int rows_, int scalars_)
      : base(base_), rows(rows_), bytes((rows_ * kRowBytes + scalars_ * 4 + 15) / 16 * 16) {}
  __host__ __device__ int total() const {
    return kDepth * bytes + (sizeof(T) == 4 ? 0 : rows * 16);
  }
  __device__ unsigned char* raw(int s) const { return base + (s % kDepth) * bytes; }
  __device__ float* scal(int s) const {
    return reinterpret_cast<float*>(raw(s) + rows * kRowBytes);
  }
  // Stage s's rows as f32, once they are in (and, for bf16, converted).
  __device__ const float4* f32(int s) const {
    return reinterpret_cast<const float4*>(sizeof(T) == 4 ? raw(s) : base + kDepth * bytes);
  }
  __device__ void row(int s, int i, const T* src) const {
    cp_async_row(raw(s) + i * kRowBytes, src);
  }
  __device__ void scalar(int s, int i, const float* src) const {
    cp_async_f32(scal(s) + i, src);
  }
  // bf16: convert stage s's rows into the f32 buffer (rows never written
  // in this stage convert to values that are never used). The caller
  // synchronises before and after.
  __device__ void convert(int s) const {
    if constexpr (sizeof(T) != 4) {
      float4* dst = reinterpret_cast<float4*>(base + kDepth * bytes);
      const unsigned char* src = raw(s);
      for (int i = threadIdx.x; i < rows; i += kThreads) {
        dst[i] = load4(reinterpret_cast<const T*>(src + i * kRowBytes));
      }
    }
  }
};

// The tiling of the dq and dk/dv passes, the same on host and device: a
// block owns a tile of up to 32 rows of one head (query rows in the dq
// pass, keys in the dk/dv pass) and a group of batch elements, and
// streams the other side's rows in chunks.
struct Tiling {
  int rows;    // rows a warp covers: min(L, 32)
  int slots;   // groups of kPer elements side by side in one warp: 32 / rows
  int elems;   // batch elements of a block: kWarps * slots * kPer
  int chunk;   // rows of one staged chunk: min(L, 32)
  int chunks;  // chunks of a pass
  int tiles;   // row tiles of a head
  int stride;  // the dq pass's bias tile row stride in floats: L | 1, odd
  __host__ __device__ explicit Tiling(int L) {
    rows = L < 32 ? L : 32;
    slots = 32 / rows;
    elems = kWarps * slots * kPer;
    chunk = L < kChunk ? L : kChunk;
    chunks = (L + chunk - 1) / chunk;
    tiles = (L + 31) / 32;
    stride = L | 1;
  }
};

// Shared memory of each pass, in bytes.
template <typename T>
__host__ __device__ int dq_bytes(int L, bool with_bias) {
  const Tiling t(L);
  const Stages<T> st(nullptr, 2 * t.elems * t.chunk, 0);  // K then V rows
  return st.total() + (with_bias ? t.rows * t.stride * 4 : 0);
}

template <typename T>
__host__ __device__ int dkdv_bytes(int L, bool with_bias) {
  const Tiling t(L);
  const int n = t.elems * t.chunk;
  const Stages<T> st(nullptr, 2 * n, 2 * n);  // Q, G rows; (lse, c) pairs
  return st.total() + (with_bias ? L * t.rows * 4 : 0);
}

template <int P>
struct BiasTiling {  // the dbias pass: a stage's row offsets
  static constexpr int kCols = kWarps * P;  // key columns of a block
  static constexpr int kQ = 0, kG = kBiasElems * 32, kK = 2 * kBiasElems * 32;
  static constexpr int kV = kK + kBiasElems * kCols;
  static constexpr int kRows = kV + kBiasElems * kCols;
  static constexpr int kScalars = 2 * kBiasElems * 32;  // lse, then c
};

template <typename T, int P>
__host__ __device__ int dbias_bytes() {
  using BT = BiasTiling<P>;
  return Stages<T, kBiasDepth>(nullptr, BT::kRows, BT::kScalars).total();
}

// Bias tile loads: 16-byte vectors where L * elt and the bias pointer allow.
template <typename T>
bool bias_vectors(const T* bias, int L) {
  return bias != nullptr && (L * sizeof(T)) % 16 == 0 &&
         reinterpret_cast<uintptr_t>(bias) % 16 == 0;
}

template <typename T, bool kBias>
__global__ void __launch_bounds__(kThreads)
attention_bwd_dq_kernel(const T* __restrict__ q, const T* __restrict__ k,
                        const T* __restrict__ v, const T* __restrict__ bias,
                        const T* __restrict__ g, const T* __restrict__ o,
                        const float* __restrict__ lse, float* __restrict__ c,
                        T* __restrict__ dq, int B, int H, int L, bool bias_vec) {
  extern __shared__ __align__(16) unsigned char smem[];
  const Tiling t(L);
  const int tile = blockIdx.x % t.tiles;
  const int h = (blockIdx.x / t.tiles) % H;
  const int b0 = (blockIdx.x / (t.tiles * H)) * t.elems;
  const int row0 = tile * 32;
  const int n_rows = min(t.rows, L - row0);  // query rows of this tile
  const int n_elems = min(t.elems, B - b0);  // elements of this block
  const int buf_rows = t.elems * t.chunk;    // K (or V) rows of one chunk
  const Stages<T> st(smem, 2 * buf_rows, 0);  // a chunk's K rows [element][key], then V
  float* tile_bias = reinterpret_cast<float*>(smem + st.total());

  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  auto stage = [&](int s) {  // issue chunk s's K and V rows by cp.async
    const int m0 = s * t.chunk;
    if (lane < min(t.chunk, L - m0)) {  // a warp an element, a lane a key
      for (int e = warp; e < n_elems; e += kWarps) {
        const size_t row = (static_cast<size_t>(b0 + e) * H + h) * L + m0 + lane;
        const int at = e * t.chunk + lane;
        st.row(s, at, k + row * kD);
        st.row(s, buf_rows + at, v + row * kD);
      }
    }
    cp_async_commit();
  };

  stage(0);
  if (kBias) {  // the (n_rows x L) tile, once per block, as f32
    const T* src = bias + (static_cast<size_t>(h) * L + row0) * L;
    // One flat loop over the tile, unrolled so that each thread's loads are
    // in flight together.
    const int n = n_rows * L;
    if (bias_vec) {  // L * elt and the tile start are 16-aligned
      constexpr int kVec = 16 / sizeof(T);
#pragma unroll 4
      for (int i = threadIdx.x * kVec; i < n; i += kThreads * kVec) {
        float vals[kVec];
        unpack(*reinterpret_cast<const uint4*>(src + i), vals);
        const int r = i / L, m = i - r * L;  // L % kVec == 0: one row
#pragma unroll
        for (int j = 0; j < kVec; ++j) tile_bias[r * t.stride + m + j] = vals[j];
      }
    } else {
#pragma unroll 4
      for (int i = threadIdx.x; i < n; i += kThreads) {
        const int r = i / L, m = i - r * L;
        tile_bias[r * t.stride + m] = to_float(src[i]);
      }
    }
  }

  // This thread: query row r of the tile, and kPer elements e0 + j.
  const int r = lane % t.rows;
  const int e0 = (warp * t.slots + lane / t.rows) * kPer;
  const int l = row0 + r;
  const bool row_ok = lane < t.rows * t.slots && r < n_rows;
  const float* brow = tile_bias + r * t.stride;
  float4 qr[kPer], gr[kPer], acc[kPer];
  float cr[kPer], lr[kPer];
#pragma unroll
  for (int j = 0; j < kPer; ++j) {
    qr[j] = gr[j] = acc[j] = make_float4(0.f, 0.f, 0.f, 0.f);
    cr[j] = lr[j] = 0.f;
    if (row_ok && e0 + j < n_elems) {
      const size_t row = (static_cast<size_t>(b0 + e0 + j) * H + h) * L + l;
      qr[j] = load4(q + row * kD);
      gr[j] = load4(g + row * kD);
      cr[j] = dot4(gr[j], load4(o + row * kD));
      lr[j] = lse[row];
      c[row] = cr[j];
    }
  }

  for (int s = 0; s < t.chunks; ++s) {
    cp_async_wait<0>();
    // Chunk s is in for every thread, and every thread is done with the
    // buffers chunk s + 1 overwrites (read in chunk s - 1).
    __syncthreads();
    if (s + 1 < t.chunks) stage(s + 1);
    if constexpr (sizeof(T) != 4) {
      st.convert(s);
      __syncthreads();
    }
    if (!row_ok) continue;
    const float4* kb = st.f32(s);
    const float4* vb = kb + buf_rows;
    const int m0 = s * t.chunk;
    const int cn = min(t.chunk, L - m0);
#pragma unroll 2
    for (int m = 0; m < cn; ++m) {
      const float bm = kBias ? brow[m0 + m] : 0.f;
#pragma unroll
      for (int j = 0; j < kPer; ++j) {
        const int at = (e0 + j) * t.chunk + m;
        const float4 km = kb[at];
        float x = dot4(qr[j], km);
        if (kBias) x += bm;
        const float ds = __expf(x - lr[j]) * (dot4(gr[j], vb[at]) - cr[j]);
        fma4(ds, km, acc[j]);
      }
    }
  }

  if (!row_ok) return;
#pragma unroll
  for (int j = 0; j < kPer; ++j) {
    if (e0 + j >= n_elems) break;
    store4(dq + ((static_cast<size_t>(b0 + e0 + j) * H + h) * L + l) * kD, acc[j]);
  }
}

template <typename T, bool kBias>
__global__ void __launch_bounds__(kThreads)
attention_bwd_dkdv_kernel(const T* __restrict__ q, const T* __restrict__ k,
                          const T* __restrict__ v, const T* __restrict__ bias,
                          const T* __restrict__ g, const float* __restrict__ lse,
                          const float* __restrict__ c, T* __restrict__ dk,
                          T* __restrict__ dv, int B, int H, int L, bool bias_vec) {
  extern __shared__ __align__(16) unsigned char smem[];
  const Tiling t(L);
  const int tile = blockIdx.x % t.tiles;
  const int h = (blockIdx.x / t.tiles) % H;
  const int b0 = (blockIdx.x / (t.tiles * H)) * t.elems;
  const int col0 = tile * 32;                // first key of this tile
  const int n_cols = min(t.rows, L - col0);  // keys of this tile
  const int n_elems = min(t.elems, B - b0);
  const int buf_rows = t.elems * t.chunk;    // Q (or G) rows of one chunk
  // A chunk's Q rows [element][query row], then G; its (lse, c) pairs.
  const Stages<T> st(smem, 2 * buf_rows, 2 * buf_rows);
  // bias[h, l, col0 + i] at tile_bias[l * t.rows + i]
  float* tile_bias = reinterpret_cast<float*>(smem + st.total());

  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  auto stage = [&](int s) {  // issue chunk s's q, g, lse and c by cp.async
    const int l0 = s * t.chunk;
    if (lane < min(t.chunk, L - l0)) {  // a warp an element, a lane a query row
      for (int e = warp; e < n_elems; e += kWarps) {
        const size_t row = (static_cast<size_t>(b0 + e) * H + h) * L + l0 + lane;
        const int at = e * t.chunk + lane;
        st.row(s, at, q + row * kD);
        st.row(s, buf_rows + at, g + row * kD);
        st.scalar(s, 2 * at, lse + row);
        st.scalar(s, 2 * at + 1, c + row);
      }
    }
    cp_async_commit();
  };

  stage(0);
  if (kBias) {  // the (L x n_cols) column tile, once per block, as f32
    const T* src = bias + static_cast<size_t>(h) * L * L + col0;  // row l at src + l * L
    const int n = L * n_cols;
    if (bias_vec) {  // L * elt, the tile start and n_cols are 16-byte multiples
      constexpr int kVec = 16 / sizeof(T);
#pragma unroll 4
      for (int i = threadIdx.x * kVec; i < n; i += kThreads * kVec) {
        const int lq = i / n_cols, m = i - lq * n_cols;  // n_cols % kVec == 0: one row
        float vals[kVec];
        unpack(*reinterpret_cast<const uint4*>(src + static_cast<size_t>(lq) * L + m), vals);
#pragma unroll
        for (int j = 0; j < kVec; ++j) tile_bias[lq * t.rows + m + j] = vals[j];
      }
    } else {
#pragma unroll 4
      for (int i = threadIdx.x; i < n; i += kThreads) {
        const int lq = i / n_cols, m = i - lq * n_cols;
        tile_bias[lq * t.rows + m] = to_float(src[static_cast<size_t>(lq) * L + m]);
      }
    }
  }

  // This thread: key r of the tile, and kPer elements e0 + j.
  const int r = lane % t.rows;
  const int e0 = (warp * t.slots + lane / t.rows) * kPer;
  const int m = col0 + r;
  const bool col_ok = lane < t.rows * t.slots && r < n_cols;
  float4 kr[kPer], vr[kPer], dk_acc[kPer], dv_acc[kPer];
#pragma unroll
  for (int j = 0; j < kPer; ++j) {
    kr[j] = vr[j] = dk_acc[j] = dv_acc[j] = make_float4(0.f, 0.f, 0.f, 0.f);
    if (col_ok && e0 + j < n_elems) {
      const size_t row = (static_cast<size_t>(b0 + e0 + j) * H + h) * L + m;
      kr[j] = load4(k + row * kD);
      vr[j] = load4(v + row * kD);
    }
  }

  for (int s = 0; s < t.chunks; ++s) {
    cp_async_wait<0>();
    __syncthreads();  // as in the dq pass
    if (s + 1 < t.chunks) stage(s + 1);
    if constexpr (sizeof(T) != 4) {
      st.convert(s);
      __syncthreads();
    }
    if (!col_ok) continue;
    const float4* qb = st.f32(s);
    const float4* gb = qb + buf_rows;
    const float2* lc = reinterpret_cast<const float2*>(st.scal(s));
    const int l0 = s * t.chunk;
    const int cn = min(t.chunk, L - l0);
#pragma unroll 2
    for (int l = 0; l < cn; ++l) {
      const float bm = kBias ? tile_bias[(l0 + l) * t.rows + r] : 0.f;
#pragma unroll
      for (int j = 0; j < kPer; ++j) {
        const int at = (e0 + j) * t.chunk + l;
        const float4 ql = qb[at];
        const float4 gl = gb[at];
        float x = dot4(ql, kr[j]);
        if (kBias) x += bm;
        const float2 lcv = lc[at];  // lse, c
        const float p = __expf(x - lcv.x);
        fma4(p, gl, dv_acc[j]);
        fma4(p * (dot4(gl, vr[j]) - lcv.y), ql, dk_acc[j]);
      }
    }
  }

  if (!col_ok) return;
#pragma unroll
  for (int j = 0; j < kPer; ++j) {
    if (e0 + j >= n_elems) break;
    const size_t row = (static_cast<size_t>(b0 + e0 + j) * H + h) * L + m;
    store4(dk + row * kD, dk_acc[j]);
    store4(dv + row * kD, dv_acc[j]);
  }
}

template <typename T, int P>
__global__ void __launch_bounds__(kThreads)
attention_bwd_dbias_kernel(const T* __restrict__ q, const T* __restrict__ k,
                           const T* __restrict__ v, const T* __restrict__ bias,
                           const T* __restrict__ g, const float* __restrict__ lse,
                           const float* __restrict__ c, float* __restrict__ dbias,
                           int B, int H, int L) {
  extern __shared__ __align__(16) unsigned char smem[];
  using BT = BiasTiling<P>;
  const int col_tiles = (L + BT::kCols - 1) / BT::kCols;
  const int row_tiles = (L + 31) / 32;
  const int m0 = (blockIdx.x % col_tiles) * BT::kCols;
  const int l0 = ((blockIdx.x / col_tiles) % row_tiles) * 32;
  const int h = blockIdx.x / (col_tiles * row_tiles);
  const int n_rows = min(32, L - l0), n_cols = min(BT::kCols, L - m0);
  const int n_stages = (B + kBiasElems - 1) / kBiasElems;
  const Stages<T, kBiasDepth> st(smem, BT::kRows, BT::kScalars);

  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const size_t hl = static_cast<size_t>(H) * L;  // rows between batch elements
  const size_t head = static_cast<size_t>(h) * L;
  // Issue stage s's rows and columns by cp.async, one commit group (empty
  // past the last stage, so that the ring's group count stays uniform).
  auto stage = [&](int s) {
    const int bs = s * kBiasElems;
    const int ne = min(kBiasElems, B - bs);
    if (lane < n_rows) {  // a warp an element, a lane a row
      for (int e = warp; e < ne; e += kWarps) {
        const size_t row = (bs + e) * hl + head + l0 + lane;
        const int at = e * 32 + lane;
        st.row(s, BT::kQ + at, q + row * kD);
        st.row(s, BT::kG + at, g + row * kD);
        st.scalar(s, at, lse + row);
        st.scalar(s, kBiasElems * 32 + at, c + row);
      }
    }
    for (int i = threadIdx.x; i < ne * BT::kCols; i += kThreads) {  // [element][column]
      const int e = i / BT::kCols, cc = i - e * BT::kCols;
      if (cc < n_cols) {
        const size_t row = (bs + e) * hl + head + m0 + cc;
        st.row(s, BT::kK + i, k + row * kD);
        st.row(s, BT::kV + i, v + row * kD);
      }
    }
    cp_async_commit();
  };

  for (int s = 0; s < kBiasDepth - 1; ++s) stage(s);
  // This thread: query row l (its lane) and P key columns, the warp's.
  const int l = l0 + lane;
  const int c0 = warp * P;  // the first of its columns within the tile
  const bool row_ok = lane < n_rows;
  float bv[P], acc[P];
#pragma unroll
  for (int i = 0; i < P; ++i) {
    bv[i] = acc[i] = 0.f;
    if (row_ok && c0 + i < n_cols) bv[i] = to_float(bias[(head + l) * L + m0 + c0 + i]);
  }

  for (int s = 0; s < n_stages; ++s) {
    cp_async_wait<kBiasDepth - 2>();
    // Stage s is in for every thread, and every thread is done with the
    // buffer stage s + kBiasDepth - 1 overwrites (read in stage s - 1).
    __syncthreads();
    stage(s + kBiasDepth - 1);
    if constexpr (sizeof(T) != 4) {
      st.convert(s);
      __syncthreads();
    }
    if (!row_ok) continue;
    const float4* rows = st.f32(s);
    const float* sc = st.scal(s);
    const int ne = min(kBiasElems, B - s * kBiasElems);
    // b = s * kBiasElems + e, in order: each accumulator's chain over the
    // batch is the first version's.
#pragma unroll 4
    for (int e = 0; e < ne; ++e) {
      const float4 ql = rows[BT::kQ + e * 32 + lane];
      const float4 gl = rows[BT::kG + e * 32 + lane];
      const float lq = sc[e * 32 + lane];
      const float cq = sc[kBiasElems * 32 + e * 32 + lane];
#pragma unroll
      for (int i = 0; i < P; ++i) {
        const float4 km = rows[BT::kK + e * BT::kCols + c0 + i];  // a broadcast
        const float4 vm = rows[BT::kV + e * BT::kCols + c0 + i];
        const float p = __expf(dot4(ql, km) + bv[i] - lq);
        acc[i] = fmaf(p, dot4(gl, vm) - cq, acc[i]);
      }
    }
  }

  if (!row_ok) return;
#pragma unroll
  for (int i = 0; i < P; ++i) {
    if (c0 + i < n_cols) dbias[(head + l) * L + m0 + c0 + i] = acc[i];
  }
}

// Above 48 KB a block's dynamic shared memory must be allowed once per
// kernel instantiation; `bytes` is the most any L <= kMaxL takes.
template <typename K>
cudaError_t allow_smem(K kernel, int bytes) {
  return cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, bytes);
}

// The dbias columns a thread carries: the most, up to kMaxCols, that still
// give at least kBiasBlocks blocks.
int dbias_cols(int H, int L) {
  int P = kMaxCols;
  while (P > 1 && static_cast<long long>(H) * ((L + 31) / 32) *
                      ((L + kWarps * P - 1) / (kWarps * P)) < kBiasBlocks) {
    P /= 2;
  }
  return P;
}

template <typename T, int P>
cudaError_t launch_dbias(const T* q, const T* k, const T* v, const T* bias, const T* g,
                         const float* lse, const float* c, float* dbias, int B, int H, int L,
                         cudaStream_t stream) {
  static const cudaError_t allowed = allow_smem(attention_bwd_dbias_kernel<T, P>,
                                                dbias_bytes<T, P>());
  if (allowed != cudaSuccess) return allowed;
  constexpr int kCols = kWarps * P;
  const long long blocks = static_cast<long long>(H) * ((L + 31) / 32) * ((L + kCols - 1) / kCols);
  attention_bwd_dbias_kernel<T, P><<<static_cast<int>(blocks), kThreads, dbias_bytes<T, P>(),
                                     stream>>>(q, k, v, bias, g, lse, c, dbias, B, H, L);
  return cudaGetLastError();
}

template <typename T, bool kBias>
cudaError_t launch_passes(const T* q, const T* k, const T* v, const T* bias, const T* g,
                          const T* o, const float* lse, float* c, T* dq, T* dk, T* dv,
                          int B, int H, int L, cudaStream_t stream) {
  static const cudaError_t allowed_dq =
      allow_smem(attention_bwd_dq_kernel<T, kBias>, dq_bytes<T>(kMaxL, kBias));
  static const cudaError_t allowed_dkdv =
      allow_smem(attention_bwd_dkdv_kernel<T, kBias>, dkdv_bytes<T>(kMaxL, kBias));
  if (allowed_dq != cudaSuccess) return allowed_dq;
  if (allowed_dkdv != cudaSuccess) return allowed_dkdv;
  const Tiling t(L);
  const long long blocks = static_cast<long long>((B + t.elems - 1) / t.elems) * H * t.tiles;
  if (blocks > 0x7fffffffLL) return cudaErrorInvalidValue;
  const bool vec = bias_vectors(bias, L);
  attention_bwd_dq_kernel<T, kBias><<<static_cast<int>(blocks), kThreads,
                                      dq_bytes<T>(L, kBias), stream>>>(
      q, k, v, bias, g, o, lse, c, dq, B, H, L, vec);
  cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess) return err;
  attention_bwd_dkdv_kernel<T, kBias><<<static_cast<int>(blocks), kThreads,
                                        dkdv_bytes<T>(L, kBias), stream>>>(
      q, k, v, bias, g, lse, c, dk, dv, B, H, L, vec);
  return cudaGetLastError();
}

template <typename T>
cudaError_t launch(const void* q, const void* k, const void* v,
                   const void* bias, const void* g, const void* o,
                   const float* lse, float* c, void* dq, void* dk, void* dv,
                   float* dbias, int B, int H, int L, cudaStream_t stream) {
  const T* qt = static_cast<const T*>(q);
  const T* kt = static_cast<const T*>(k);
  const T* vt = static_cast<const T*>(v);
  const T* bt = static_cast<const T*>(bias);
  const T* gt = static_cast<const T*>(g);
  const T* ot = static_cast<const T*>(o);
  T* dqt = static_cast<T*>(dq);
  T* dkt = static_cast<T*>(dk);
  T* dvt = static_cast<T*>(dv);
  cudaError_t err =
      bias != nullptr
          ? launch_passes<T, true>(qt, kt, vt, bt, gt, ot, lse, c, dqt, dkt, dvt, B, H, L, stream)
          : launch_passes<T, false>(qt, kt, vt, bt, gt, ot, lse, c, dqt, dkt, dvt, B, H, L, stream);
  if (err != cudaSuccess || dbias == nullptr) return err;
  switch (dbias_cols(H, L)) {
    case 8: return launch_dbias<T, 8>(qt, kt, vt, bt, gt, lse, c, dbias, B, H, L, stream);
    case 4: return launch_dbias<T, 4>(qt, kt, vt, bt, gt, lse, c, dbias, B, H, L, stream);
    case 2: return launch_dbias<T, 2>(qt, kt, vt, bt, gt, lse, c, dbias, B, H, L, stream);
    default: return launch_dbias<T, 1>(qt, kt, vt, bt, gt, lse, c, dbias, B, H, L, stream);
  }
}

}  // namespace

// Plain C interface for ctypes. D: 4 (the kernels above, L <= kMaxL), 8,
// 16, 32, 64 (the mma template, any L whose grids fit an int) or a
// multiple of 64 past 64 (the wide passes, any L). dtype: 0 =
// float32, 1 = bfloat16. `bias` may be null; `dbias` is null, or (with a
// bias) a float32 (1, H, L, L) output. `lse` is the forward's float32 (B,
// H, L) residual and `c` a float32 (B, H, L) scratch the call fills.
// Launches on `stream` of card `device`, does not synchronise and allocates
// nothing. Returns the first failing launch's cudaError_t (0 = success).
extern "C" int ecg_attention_bwd(const void* q, const void* k, const void* v,
                                 const void* bias, const void* g,
                                 const void* o, const void* lse, void* c,
                                 void* dq, void* dk, void* dv, void* dbias,
                                 int B, int H, int L, int D, int dtype,
                                 int device, void* stream) {
  if (B < 1 || H < 1 || L < 1 || (D == kD && L > kMaxL) ||
      (dbias != nullptr && bias == nullptr)) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return static_cast<int>(err);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const float* lse_f = static_cast<const float*>(lse);
  float* c_f = static_cast<float*>(c);
  float* dbias_f = static_cast<float*>(dbias);
  switch (dtype) {
    case 0:
      err = D == kD ? launch<float>(q, k, v, bias, g, o, lse_f, c_f, dq, dk, dv, dbias_f,
                                    B, H, L, s)
            : D <= mma_bwd::kWideD
                ? mma_bwd::launch_mma<float>(q, k, v, bias, g, o, lse_f, c_f, dq, dk, dv, dbias_f,
                                             B, H, L, D, s)
                : mma_bwd::launch_wide<float, false>(q, k, v, bias, g, o, lse_f, c_f, dq, dk, dv,
                                                     dbias_f, B, H, L, D, nullptr, 0, s);
      break;
    case 1:
      err = D == kD ? launch<__nv_bfloat16>(q, k, v, bias, g, o, lse_f, c_f, dq, dk, dv,
                                            dbias_f, B, H, L, s)
            : D <= mma_bwd::kWideD
                ? mma_bwd::launch_mma<__nv_bfloat16>(q, k, v, bias, g, o, lse_f, c_f, dq, dk, dv,
                                                     dbias_f, B, H, L, D, s)
                : mma_bwd::launch_wide<__nv_bfloat16, false>(q, k, v, bias, g, o, lse_f, c_f, dq,
                                                             dk, dv, dbias_f, B, H, L, D,
                                                             nullptr, 0, s);
      break;
    default:
      err = cudaErrorInvalidValue;
  }
  return static_cast<int>(err);
}

// The wide passes' clusters at head dim D (a multiple of 64 past 64):
// out[0] the dq pass's size in blocks, out[1] the clusters of it card
// `device` holds at once (cudaOccupancyMaxActiveClusters), out[2] and out[3]
// the dk/dv pass's.
// dtype as above; with_bias: the instantiations with a bias.
// Returns a cudaError_t (0 = success).
extern "C" int ecg_wide_clusters(int D, int dtype, int with_bias, int device, int* out) {
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return static_cast<int>(err);
  switch (dtype) {
    case 0: err = mma_bwd::wide_clusters<float, false>(D, with_bias != 0, out); break;
    case 1: err = mma_bwd::wide_clusters<__nv_bfloat16, false>(D, with_bias != 0, out); break;
    default: err = cudaErrorInvalidValue;
  }
  return static_cast<int>(err);
}

extern "C" const char* ecg_cuda_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}
