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
// L <= 256 (D = 8, 16, 32, 64: the mma template below, with the same
// contract but any L; D a multiple of 64 past 64: the wide passes at the
// end of this file, any L); bias is a contiguous (1, H, L, L)
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
// ---------------------------------------------------------------------------
// head_dim 8, 16, 32 and 64: one template on D, on Hopper's tensor cores.
// Transformer1d's heads are 32 wide; the wrapper (kernels/attention.py)
// zero-pads any other D <= 64 to the next instantiated one, and a D = 4
// call past 256 keys to 8. The D = 4 kernels above are left as they are,
// bit for bit.
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
      const bool in0 = m < L, in1 = m + 1 < L;
      // ds = exp(s + bias - lse) (dP - c), summed over b in order.
      if (in0) {
        acc[j][0] += ok0 ? __expf(s[0] + to_float(brow0[m]) - lse0) * (dp[0] - c0) : 0.f;
        acc[j][2] += ok1 ? __expf(s[2] + to_float(brow1[m]) - lse1) * (dp[2] - c1) : 0.f;
      }
      if (in1) {
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
                              const T* o, const float* lse, float* c, T* dq, T* dk, T* dv,
                              int B, int H, int L, cudaStream_t stream) {
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
  cudaError_t err =
      bias != nullptr
          ? launch_mma_passes<T, D, true>(qt, kt, vt, bt, gt, ot, lse, c, dqt, dkt, dvt, B, H,
                                          L, stream)
          : launch_mma_passes<T, D, false>(qt, kt, vt, bt, gt, ot, lse, c, dqt, dkt, dvt, B, H,
                                           L, stream);
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

// The template at head dim D = 8, 16, 32 or 64; any other D is refused.
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

template <typename T, bool kBias>
__global__ void __launch_bounds__(kMmaThreads)
attention_bwd_dq_wide_kernel(const T* __restrict__ q, const T* __restrict__ k,
                             const T* __restrict__ v, const T* __restrict__ bias,
                             const T* __restrict__ g, const T* __restrict__ o,
                             const float* __restrict__ lse, float* __restrict__ c,
                             T* __restrict__ dq, int B, int H, int L, int D) {
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
          if (m < L) {
            s[j][0] += w.ok0 ? to_float(brow0[m]) : 0.f;
            s[j][2] += w.ok1 ? to_float(brow1[m]) : 0.f;
          }
          if (m + 1 < L) {
            s[j][1] += w.ok0 ? to_float(brow0[m + 1]) : 0.f;
            s[j][3] += w.ok1 ? to_float(brow1[m + 1]) : 0.f;
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

template <typename T, bool kBias>
__global__ void __launch_bounds__(kMmaThreads)
attention_bwd_dkdv_wide_kernel(const T* __restrict__ q, const T* __restrict__ k,
                               const T* __restrict__ v, const T* __restrict__ bias,
                               const T* __restrict__ g, const float* __restrict__ lse,
                               const float* __restrict__ c, T* __restrict__ dk,
                               T* __restrict__ dv, int B, int H, int L, int D) {
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
        if (l < L) {
          p[j][0] += w.ok0 ? to_float(bcol0[static_cast<size_t>(l) * L]) : 0.f;
          p[j][2] += w.ok1 ? to_float(bcol1[static_cast<size_t>(l) * L]) : 0.f;
        }
        if (l + 1 < L) {
          p[j][1] += w.ok0 ? to_float(bcol0[static_cast<size_t>(l + 1) * L]) : 0.f;
          p[j][3] += w.ok1 ? to_float(bcol1[static_cast<size_t>(l + 1) * L]) : 0.f;
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
  // Element st / per, step c = st % per: chunk c of (q, K), then chunk c -
  // chunks of (g, V).
  const int per = 2 * chunks;
  const long long n_stages = static_cast<long long>(B) * per;
  auto stage = [&](long long st) {
    float* buf = ring + (st & 1) * 2 * kPlane;
    const long long b = st / per;
    const int cs = static_cast<int>(st - b * per);
    const bool second = cs >= chunks;
    const int col = (second ? cs - chunks : cs) * kWideD;
    const long long bh = b * H + h;
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
    const float* buf = ring + (st & 1) * 2 * kPlane;
    const long long b = st / per;
    const int cs = static_cast<int>(st - b * per);
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

template <typename T, bool kBias>
cudaError_t launch_wide_passes(const T* q, const T* k, const T* v, const T* bias, const T* g,
                               const T* o, const float* lse, float* c, T* dq, T* dk, T* dv,
                               int B, int H, int L, int D, cudaStream_t stream) {
  static const cudaError_t allowed_dq =
      allow_smem(attention_bwd_dq_wide_kernel<T, kBias>, wide_smem_bytes(false));
  static const cudaError_t allowed_dkdv =
      allow_smem(attention_bwd_dkdv_wide_kernel<T, kBias>, wide_smem_bytes(true));
  if (allowed_dq != cudaSuccess) return allowed_dq;
  if (allowed_dkdv != cudaSuccess) return allowed_dkdv;
  const MmaTiling t(L);
  const long long groups = (static_cast<long long>(B) * H + t.heads - 1) / t.heads;
  const long long blocks = groups * t.tiles;
  if (blocks > 0x7fffffffLL || D / kWideD > 65535) return cudaErrorInvalidValue;
  const dim3 grid(static_cast<unsigned>(blocks), D / kWideD);
  attention_bwd_dq_wide_kernel<T, kBias>
      <<<grid, kMmaThreads, wide_smem_bytes(false), stream>>>(q, k, v, bias, g, o, lse, c, dq,
                                                               B, H, L, D);
  const cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess) return err;
  attention_bwd_dkdv_wide_kernel<T, kBias>
      <<<grid, kMmaThreads, wide_smem_bytes(true), stream>>>(q, k, v, bias, g, lse, c, dk, dv,
                                                              B, H, L, D);
  return cudaGetLastError();
}

// The wide passes at D, a multiple of 64 past 64; any other D is refused.
template <typename T>
cudaError_t launch_wide(const void* q, const void* k, const void* v, const void* bias,
                        const void* g, const void* o, const float* lse, float* c, void* dq,
                        void* dk, void* dv, float* dbias, int B, int H, int L, int D,
                        cudaStream_t stream) {
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
  cudaError_t err =
      bias != nullptr
          ? launch_wide_passes<T, true>(qt, kt, vt, bt, gt, ot, lse, c, dqt, dkt, dvt, B, H, L,
                                        D, stream)
          : launch_wide_passes<T, false>(qt, kt, vt, bt, gt, ot, lse, c, dqt, dkt, dvt, B, H, L,
                                         D, stream);
  if (err != cudaSuccess || dbias == nullptr) return err;
  static const cudaError_t allowed =
      allow_smem(attention_bwd_dbias_wide_kernel<T>, wide_smem_bytes(false));
  if (allowed != cudaSuccess) return allowed;
  const long long tiles = (L + kTile - 1) / kTile;
  const long long blocks = H * tiles * tiles;
  if (blocks > 0x7fffffffLL) return cudaErrorInvalidValue;
  attention_bwd_dbias_wide_kernel<T>
      <<<static_cast<int>(blocks), kMmaThreads, wide_smem_bytes(false), stream>>>(
          qt, kt, vt, bt, gt, lse, c, dbias, B, H, L, D);
  return cudaGetLastError();
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
            : D <= kWideD ? launch_mma<float>(q, k, v, bias, g, o, lse_f, c_f, dq, dk, dv,
                                              dbias_f, B, H, L, D, s)
                          : launch_wide<float>(q, k, v, bias, g, o, lse_f, c_f, dq, dk, dv,
                                               dbias_f, B, H, L, D, s);
      break;
    case 1:
      err = D == kD ? launch<__nv_bfloat16>(q, k, v, bias, g, o, lse_f, c_f, dq, dk, dv,
                                            dbias_f, B, H, L, s)
            : D <= kWideD ? launch_mma<__nv_bfloat16>(q, k, v, bias, g, o, lse_f, c_f, dq, dk,
                                                      dv, dbias_f, B, H, L, D, s)
                          : launch_wide<__nv_bfloat16>(q, k, v, bias, g, o, lse_f, c_f, dq,
                                                       dk, dv, dbias_f, B, H, L, D, s);
      break;
    default:
      err = cudaErrorInvalidValue;
  }
  return static_cast<int>(err);
}

extern "C" const char* ecg_cuda_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}
