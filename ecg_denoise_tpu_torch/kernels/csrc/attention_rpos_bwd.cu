// Attention with a per-window R-peak bias, backward — the gradient of
// RA-LENet's R-wave attention (`--r_pos detect`) on Hopper (sm_90a).
//
// Replaces the TPU kernel ecg_denoise_tpu/kernels/attention_pallas.py
// _bwd_rpos_kernel (:859), launched through _rpos_bwd_call (:1037) from
// _rpos_bwd (:1058), the custom VJP of _rpos_single.
//
// Computes, for every (b, h), with the forward's log-sum-exp residual lse
// (attention_rpos_fwd.cu) and the incoming gradient g of the output o,
// where bias_b[h,l,m] = toep[0,h,l,m] * in_b[l] * in_b[m] and
// in_b[i] = (off_b <= i < off_b + W):
//   p[l,m]  = exp(q[l] . k[m] + bias_b[h,l,m] - lse[l])
//   c[l]    = sum_d g[l,d] * o[l,d]          (the flash delta identity)
//   ds[l,m] = p[l,m] * (g[l] . v[m] - c[l])
//   dq[l]   = sum_m ds[l,m] * k[m]
//   dk[m]   = sum_l ds[l,m] * q[l]
//   dv[m]   = sum_l p[l,m] * g[l]
//   dtoep[h,l,m] = sum_b ds[b,h,l,m] * in_b[l] * in_b[m]   (float32)
// The offsets get no gradient. q arrives pre-scaled. Operands are
// contiguous (B, H, L, D); toep is a contiguous (1, H, L, L) array in the
// operand dtype and offsets a contiguous (B,) float32 array. float32 and
// bfloat16 operands; every exp and sum is float32, dq, dk and dv are
// rounded once to the operand dtype, and dtoep is written in float32 (the
// caller casts it to toep's dtype).
//
// Which kernel takes which (D, L), and why:
// * D = 4 at L <= 256 (RA-LENet's `--r_pos detect` path, every stage): the
//   passes below, a thread two rows, K and V (q and g) of the block's heads
//   in shared memory at once, and dtoep by a pass of its own. The TPU
//   kernel rounds e and ds to bf16 before its products; these do not.
// * D = 4 past 256 keys (PTB-XL's 10 s records at 100 Hz, L = 1,000), and
//   D = 8, 16, 32, 64 at any L (bf16 from 16; the wrapper pads other D <= 64
//   up): B4's window kernel on the tensor cores
//   (attention_rpos_bwd_mma.cuh). D = 4 runs there unpadded, the window is
//   tested once a (warp, tile), and f32 operands are split into TF32
//   halves once a tile. At bf16 it rounds p and ds to bf16 before their
//   products (ds.K, ds^T.q, p^T.g), as the TPU kernel does; B2's template,
//   which took these shapes before, split them into TF32 halves.
// * D > 64, a multiple of 64 (the wrapper pads other D up): B2's wide
//   passes in their window mode (attention_bwd_mma.cuh, kWin), thread-block
//   clusters along D.
// Past the D = 4 kernel the dq pass leaves the windowed ds in a scratch
// and `attention_rpos_dtoep_sum_kernel` below, a launch of its own, sums
// it into dtoep.
//
// The D = 4 kernel. What bounds it: as for attention_bwd.cu, per (b, h)
// the work is 2*(5*L*L*D + 3*L*L) flops and L*L exps, with D = 4 below
// every tensor-core shape, so the products run on the CUDA cores in f32; by
// bytes it moves q, k, v, g, o, dq, dk, dv, lse, the toep entries the
// windows reach, offsets and dtoep once. Operations bound it at L >= 128
// and bytes below. The per-window bias is never built in memory.
//
// The first version (three launches, a thread a row in the dq and dk/dv
// passes, a thread per (h, l, m) looping over the batch in the dtoep pass)
// tested the window on every key of every row, and its dtoep pass, for
// each of the B elements, recomputed the element's window from offsets[b]
// and, for the one triple in about 15 that counts, read q, k, v, g, lse
// and c straight from global memory, one dependent round trip at a time.
//
// Design: three passes, launched so that they run side by side; every
// output element is still summed by one thread, in the first version's
// order, with its expressions.
// * dq pass. A thread owns R consecutive rows of one (b, h) (R = 2 when L
//   is even, so that one shared-memory load of a key feeds both rows; 1
//   otherwise) and a block kThreads * R rows; K and V of the block's heads
//   are staged in shared memory as f32. The element's window [lo, hi) is
//   computed once. The L keys go in three runs: [0, lo) and [hi, L) with
//   no bias and no test, and [lo, hi), where a row inside the window adds
//   toep[h, l, m] (a predicated load and add). A warp whose rows all lie
//   outside their windows makes one bias-free run. In RA-LENet a warp's
//   rows share one batch element (H * L = 512), so the runs are uniform
//   across the warp. Each thread writes its rows' c to the float32
//   (B, H, L) scratch.
// * dk/dv pass, its transpose: a thread owns R keys, the block stages q,
//   g and the (lse, c) pairs of its heads, and the L query rows go in the
//   same three runs; a key inside the window adds toep[h, l, m] read by
//   column (neighbouring lanes, neighbouring addresses).
// * dtoep pass. A block owns one head and a tile of 32 rows (a lane a row)
//   by 4 key columns (a warp a column). A tile wholly outside the
//   band |l - m| < W, where no window holds both l and m, writes zeros and
//   stops. Otherwise the block computes the windows of the batch, 512
//   elements at a time, and lists in order the elements whose window meets
//   both its rows and its columns (a ballot and a prefix over the block).
//   It walks that list in stages of 16 elements through a ring of three
//   cp.async buffers, staging of each listed element only the rows and
//   columns inside its window. An element adds to the accumulator of
//   (l, m) only where its window holds both: the row test is a lane's,
//   the column test the warp's (a branch). Each accumulator still sums its
//   contributing b in ascending order with fmaf(p, g.v - c, acc) after
//   __expf(q.k + t - lse).
// * Side by side. The dk/dv and dtoep passes form c = g . o from g and o
//   as the dq pass does, so no pass reads another's output. The dtoep pass
//   (a few microseconds of waiting on memory per call, whatever the shape)
//   is launched first; the dq and then the dk/dv pass follow by
//   programmatic dependent launch: each may start as soon as every block
//   of the one before it has started, on the SMs that one leaves free, and
//   waits for it to complete only before its own threads exit, so the
//   three complete in order and a later kernel of the stream sees all of
//   their writes. At the small stage shapes the three passes' latencies
//   now overlap instead of adding up.
// * Arithmetic as the first version: dq, dk, dv and dtoep are its outputs
//   bit for bit. No atomics, no TF32, no cross-block reduction: a call
//   gives bit-identical results every time.

#include <cuda_bf16.h>
#include <cuda_runtime.h>

#include <cstdint>
#include <type_traits>

#include "attention_bwd_mma.cuh"
#include "attention_rpos_bwd_mma.cuh"

namespace {

constexpr int kD = 4;
constexpr int kThreads = 128;
constexpr int kWarps = kThreads / 32;
constexpr int kMaxL = 256;
constexpr int kToepElems = 16;    // batch elements of one dtoep stage
constexpr int kToepDepth = 3;     // dtoep stages in flight: the ring's buffers
constexpr int kToepCols = kWarps;  // key columns of a dtoep tile: a warp a column
constexpr int kScan = 512;        // elements one dtoep list covers: 4 a thread
constexpr int kScanRounds = kScan / kThreads;

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

// Programmatic dependent launch (sm_90): let the stream's next kernel,
// launched with programmatic stream serialization, start on the SMs this
// grid leaves free; and wait until the stream's previous grid has
// completed and its writes are visible.
__device__ __forceinline__ void launch_dependents() {
  asm volatile("griddepcontrol.launch_dependents;\n" ::: "memory");
}

__device__ __forceinline__ void wait_previous_grid() {
  asm volatile("griddepcontrol.wait;\n" ::: "memory");
}

// The dtoep pass's ring: kToepDepth stage buffers, each `rows` operand rows
// (4 values of T) then `scalars` f32 values; for bf16 one more buffer
// holding a stage's rows converted to f32 (attention_bwd.cu's Stages).
template <typename T>
struct Stages {
  static constexpr int kRowBytes = kD * sizeof(T);
  unsigned char* base;
  int rows, bytes;  // bytes: one stage buffer, 16-byte aligned
  __host__ __device__ Stages(unsigned char* base_, int rows_, int scalars_)
      : base(base_), rows(rows_), bytes((rows_ * kRowBytes + scalars_ * 4 + 15) / 16 * 16) {}
  __host__ __device__ int total() const {
    return kToepDepth * bytes + (sizeof(T) == 4 ? 0 : rows * 16);
  }
  __device__ unsigned char* raw(int s) const { return base + (s % kToepDepth) * bytes; }
  __device__ float* scal(int s) const {
    return reinterpret_cast<float*>(raw(s) + rows * kRowBytes);
  }
  __device__ const float4* f32(int s) const {
    return reinterpret_cast<const float4*>(sizeof(T) == 4 ? raw(s)
                                                          : base + kToepDepth * bytes);
  }
  __device__ void row(int s, int i, const T* src) const {
    cp_async_row(raw(s) + i * kRowBytes, src);
  }
  __device__ void scalar(int s, int i, const float* src) const {
    cp_async_f32(scal(s) + i, src);
  }
  // bf16: convert stage s's rows into the f32 buffer (rows not staged
  // convert to values that are never used). The caller synchronises
  // before and after.
  __device__ void convert(int s) const {
    if constexpr (sizeof(T) != 4) {
      float4* dst = reinterpret_cast<float4*>(base + kToepDepth * bytes);
      const unsigned char* src = raw(s);
      for (int i = threadIdx.x; i < rows; i += kThreads) {
        dst[i] = load4(reinterpret_cast<const T*>(src + i * kRowBytes));
      }
    }
  }
};

// Rows one block of the dq or dk/dv pass may need to stage: kThreads * R
// consecutive rows span at most ceil((kThreads * R - 1) / L) + 1 heads of
// L rows each.
__host__ __device__ __forceinline__ int head_capacity(int L, int R) {
  return ((kThreads * R - 1 + L - 1) / L + 1) * L;
}

using Plain = std::false_type;
using Biased = std::true_type;

template <typename T, int R>
__global__ void __launch_bounds__(kThreads)
attention_rpos_bwd_dq_kernel(const T* __restrict__ q, const T* __restrict__ k,
                             const T* __restrict__ v, const T* __restrict__ toep,
                             const float* __restrict__ offsets,
                             const T* __restrict__ g, const T* __restrict__ o,
                             const float* __restrict__ lse, float* __restrict__ c,
                             T* __restrict__ dq, int H, int L, int W, int n_rows) {
  launch_dependents();
  extern __shared__ __align__(16) unsigned char smem[];
  float4* ks = reinterpret_cast<float4*>(smem);
  float4* vs = ks + head_capacity(L, R);

  const int row0 = blockIdx.x * (kThreads * R);
  const int row_end = min(row0 + kThreads * R, n_rows);
  const int key0 = (row0 / L) * L;
  const int n_keys = ((row_end - 1) / L + 1) * L - key0;
  for (int i = threadIdx.x; i < n_keys; i += kThreads) {
    ks[i] = load4(k + static_cast<size_t>(key0 + i) * kD);
    vs[i] = load4(v + static_cast<size_t>(key0 + i) * kD);
  }
  __syncthreads();

  // This thread: rows first .. first + R - 1, all of one (b, h) (L % R == 0).
  const int first = row0 + threadIdx.x * R;
  if (first >= n_rows) return;
  const int bh = first / L;
  const int l0 = first - bh * L;
  const int b = bh / H;
  const int h = bh - b * H;
  const float4* kh = ks + (bh * L - key0);
  const float4* vh = vs + (bh * L - key0);
  const Window win = window_of(offsets[b], W, L);  // attention_window.cuh
  const int lo = win.lo, hi = win.hi;
  float4 qr[R], gr[R], acc[R];
  float cr[R], lr[R];
  bool in[R];
  const T* trow[R];
  bool any_in = false;
#pragma unroll
  for (int i = 0; i < R; ++i) {
    const size_t row = static_cast<size_t>(first + i);
    qr[i] = load4(q + row * kD);
    gr[i] = load4(g + row * kD);
    cr[i] = dot4(gr[i], load4(o + row * kD));
    lr[i] = lse[row];
    c[row] = cr[i];
    in[i] = l0 + i >= lo && l0 + i < hi;  // a row outside the window: no bias
    any_in |= in[i];
    trow[i] = toep + (static_cast<size_t>(h) * L + l0 + i) * L;
    acc[i] = make_float4(0.f, 0.f, 0.f, 0.f);
  }

  auto run = [&](int m_begin, int m_end, auto biased) {
#pragma unroll 4
    for (int m = m_begin; m < m_end; ++m) {
      const float4 km = kh[m];
      const float4 vm = vh[m];
#pragma unroll
      for (int i = 0; i < R; ++i) {
        float s = dot4(qr[i], km);
        if constexpr (decltype(biased)::value) {
          if (in[i]) s += to_float(trow[i][m]);
        }
        const float ds = __expf(s - lr[i]) * (dot4(gr[i], vm) - cr[i]);
        fma4(ds, km, acc[i]);
      }
    }
  };
  // The keys in order, in three runs; a warp none of whose rows lies in
  // its window makes one bias-free run.
  if (__any_sync(__activemask(), any_in)) {
    run(0, lo, Plain{});
    run(lo, hi, Biased{});
    run(hi, L, Plain{});
  } else {
    run(0, L, Plain{});
  }
#pragma unroll
  for (int i = 0; i < R; ++i) store4(dq + static_cast<size_t>(first + i) * kD, acc[i]);
  wait_previous_grid();  // this grid completes after the dtoep pass
}

template <typename T, int R>
__global__ void __launch_bounds__(kThreads)
attention_rpos_bwd_dkdv_kernel(const T* __restrict__ q, const T* __restrict__ k,
                               const T* __restrict__ v, const T* __restrict__ toep,
                               const float* __restrict__ offsets,
                               const T* __restrict__ g, const T* __restrict__ o,
                               const float* __restrict__ lse, T* __restrict__ dk,
                               T* __restrict__ dv, int H, int L, int W, int n_rows) {
  launch_dependents();
  extern __shared__ __align__(16) unsigned char smem[];
  const int cap = head_capacity(L, R);
  float4* qs = reinterpret_cast<float4*>(smem);
  float4* gs = qs + cap;
  float2* lcs = reinterpret_cast<float2*>(qs + 2 * cap);  // (lse, c)

  const int row0 = blockIdx.x * (kThreads * R);  // key rows of the flattened B*H*L
  const int row_end = min(row0 + kThreads * R, n_rows);
  const int first_q = (row0 / L) * L;            // first query row staged
  const int n_staged = ((row_end - 1) / L + 1) * L - first_q;
  for (int i = threadIdx.x; i < n_staged; i += kThreads) {
    const size_t row = static_cast<size_t>(first_q + i);
    const float4 gr = load4(g + row * kD);
    qs[i] = load4(q + row * kD);
    gs[i] = gr;
    lcs[i] = make_float2(lse[row], dot4(gr, load4(o + row * kD)));  // c as the dq pass's
  }
  __syncthreads();

  // This thread: keys first .. first + R - 1, all of one (b, h).
  const int first = row0 + threadIdx.x * R;
  if (first >= n_rows) return;
  const int bh = first / L;
  const int m0 = first - bh * L;
  const int b = bh / H;
  const int h = bh - b * H;
  const int off = bh * L - first_q;
  const Window win = window_of(offsets[b], W, L);  // attention_window.cuh
  const int lo = win.lo, hi = win.hi;
  float4 kr[R], vr[R], dk_acc[R], dv_acc[R];
  bool in[R];
  const T* tcol[R];  // toep[h, l, m] is tcol[l * L]
  bool any_in = false;
#pragma unroll
  for (int i = 0; i < R; ++i) {
    const size_t row = static_cast<size_t>(first + i);
    kr[i] = load4(k + row * kD);
    vr[i] = load4(v + row * kD);
    in[i] = m0 + i >= lo && m0 + i < hi;  // a key outside the window: no bias
    any_in |= in[i];
    tcol[i] = toep + static_cast<size_t>(h) * L * L + m0 + i;
    dk_acc[i] = dv_acc[i] = make_float4(0.f, 0.f, 0.f, 0.f);
  }

  auto run = [&](int l_begin, int l_end, auto biased) {
#pragma unroll 4
    for (int l = l_begin; l < l_end; ++l) {
      const float4 ql = qs[off + l];
      const float4 gl = gs[off + l];
      const float2 lc = lcs[off + l];
#pragma unroll
      for (int i = 0; i < R; ++i) {
        float s = dot4(ql, kr[i]);
        if constexpr (decltype(biased)::value) {
          if (in[i]) s += to_float(tcol[i][static_cast<size_t>(l) * L]);
        }
        const float p = __expf(s - lc.x);
        fma4(p, gl, dv_acc[i]);
        fma4(p * (dot4(gl, vr[i]) - lc.y), ql, dk_acc[i]);
      }
    }
  };
  if (__any_sync(__activemask(), any_in)) {
    run(0, lo, Plain{});
    run(lo, hi, Biased{});
    run(hi, L, Plain{});
  } else {
    run(0, L, Plain{});
  }
#pragma unroll
  for (int i = 0; i < R; ++i) {
    const size_t row = static_cast<size_t>(first + i);
    store4(dk + row * kD, dk_acc[i]);
    store4(dv + row * kD, dv_acc[i]);
  }
  wait_previous_grid();  // this grid completes after the dq pass
}

// The dtoep pass's stage buffer: q, g and o rows of 32 query rows, then k
// and v rows of kToepCols keys, for each of kToepElems elements; the
// rows' lse.
constexpr int kQ = 0, kG = kToepElems * 32, kO = 2 * kToepElems * 32;
constexpr int kK = 3 * kToepElems * 32;
constexpr int kV = kK + kToepElems * kToepCols;
constexpr int kStageRows = kV + kToepElems * kToepCols;
constexpr int kStageScalars = kToepElems * 32;

// The dtoep pass's shared memory: the ring, then the list of elements (b,
// then lo | hi << 16) and the scan's per-warp counts.
template <typename T>
__host__ __device__ int dtoep_bytes() {
  return Stages<T>(nullptr, kStageRows, kStageScalars).total() + 2 * kScan * 4 +
         kScanRounds * kWarps * 4;
}

// Whether any (l, m) of the tile [l0, l0 + nr) x [m0, m0 + nc) lies in the
// band |l - m| < W, the only entries a window can reach.
__device__ __forceinline__ bool in_band(int l0, int nr, int m0, int nc, int W) {
  const int gap = max(0, max(m0 - (l0 + nr - 1), l0 - (m0 + nc - 1)));
  return gap < W;
}

template <typename T>
__global__ void __launch_bounds__(kThreads)
attention_rpos_bwd_dtoep_kernel(const T* __restrict__ q, const T* __restrict__ k,
                                const T* __restrict__ v, const T* __restrict__ toep,
                                const float* __restrict__ offsets,
                                const T* __restrict__ g, const T* __restrict__ o,
                                const float* __restrict__ lse, float* __restrict__ dtoep,
                                int B, int H, int L, int W) {
  launch_dependents();
  extern __shared__ __align__(16) unsigned char smem[];
  const int col_tiles = (L + kToepCols - 1) / kToepCols;
  const int row_tiles = (L + 31) / 32;
  const int m0 = (blockIdx.x % col_tiles) * kToepCols;
  const int l0 = ((blockIdx.x / col_tiles) % row_tiles) * 32;
  const int h = blockIdx.x / (col_tiles * row_tiles);
  const int n_rows = min(32, L - l0), n_cols = min(kToepCols, L - m0);
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int l = l0 + lane;  // this thread: row l and the warp's column m
  const int m = m0 + warp;
  const bool out_ok = lane < n_rows && warp < n_cols;
  const size_t head = static_cast<size_t>(h) * L;
  float* out = dtoep + (head + l) * L + m;
  if (!in_band(l0, n_rows, m0, n_cols, W)) {  // no window holds both l and m
    if (out_ok) *out = 0.f;
    return;
  }

  const Stages<T> st(smem, kStageRows, kStageScalars);
  int* list_b = reinterpret_cast<int*>(smem + st.total());
  int* list_win = list_b + kScan;  // lo | hi << 16
  int* counts = list_win + kScan;  // [round][warp]
  const size_t hl = static_cast<size_t>(H) * L;  // rows between batch elements
  const float tv = out_ok ? to_float(toep[(head + l) * L + m]) : 0.f;
  float acc = 0.f;

  int n_list = 0;
  // Issue stage s's listed elements by cp.async, a warp an element: its
  // rows and columns inside its window only. One commit group (empty past
  // the list's end, so that the ring's group count stays uniform).
  auto stage = [&](int s) {
    const int ne = min(kToepElems, n_list - s * kToepElems);
    for (int e = warp; e < ne; e += kWarps) {
      const int idx = s * kToepElems + e;
      const size_t bb = static_cast<size_t>(list_b[idx]) * hl + head;
      const int win = list_win[idx];
      const int lo = win & 0xffff;
      const unsigned width = static_cast<unsigned>((win >> 16) - lo);
      if (static_cast<unsigned>(l0 + lane - lo) < width) {
        const size_t row = bb + l0 + lane;
        const int at = e * 32 + lane;
        st.row(s, kQ + at, q + row * kD);
        st.row(s, kG + at, g + row * kD);
        st.row(s, kO + at, o + row * kD);
        st.scalar(s, at, lse + row);
      }
      if (lane < kToepCols && static_cast<unsigned>(m0 + lane - lo) < width) {
        const size_t row = bb + m0 + lane;
        const int at = e * kToepCols + lane;
        st.row(s, kK + at, k + row * kD);
        st.row(s, kV + at, v + row * kD);
      }
    }
    cp_async_commit();
  };

  for (int base = 0; base < B; base += kScan) {
    // The elements base .. base + kScan - 1 whose window meets both the
    // tile's rows and its columns, listed in ascending b.
    bool hit[kScanRounds];
    int win[kScanRounds], rank[kScanRounds];
#pragma unroll
    for (int r = 0; r < kScanRounds; ++r) {
      const int b = base + r * kThreads + threadIdx.x;
      const Window w = b < B ? window_of(offsets[b], W, L) : Window{0, 0};
      const int lo = w.lo, hi = w.hi;
      hit[r] = lo < hi && lo < l0 + n_rows && hi > l0 && lo < m0 + n_cols && hi > m0;
      win[r] = lo | hi << 16;
      const unsigned ballot = __ballot_sync(0xffffffffu, hit[r]);
      rank[r] = __popc(ballot & ((1u << lane) - 1u));
      if (lane == 0) counts[r * kWarps + warp] = __popc(ballot);
    }
    __syncthreads();
    int total = 0;
#pragma unroll
    for (int r = 0; r < kScanRounds; ++r) {
      for (int w = 0; w < kWarps; ++w) {
        if (w == warp) rank[r] += total;
        total += counts[r * kWarps + w];
      }
    }
#pragma unroll
    for (int r = 0; r < kScanRounds; ++r) {
      if (hit[r]) {
        list_b[rank[r]] = base + r * kThreads + threadIdx.x;
        list_win[rank[r]] = win[r];
      }
    }
    n_list = total;
    __syncthreads();

    const int n_stages = (n_list + kToepElems - 1) / kToepElems;
    for (int s = 0; s < kToepDepth - 1; ++s) stage(s);
    for (int s = 0; s < n_stages; ++s) {
      cp_async_wait<kToepDepth - 2>();
      // Stage s is in for every thread, and every thread is done with the
      // buffer stage s + kToepDepth - 1 overwrites (read in stage s - 1).
      __syncthreads();
      stage(s + kToepDepth - 1);
      if constexpr (sizeof(T) != 4) {
        st.convert(s);
        __syncthreads();
      }
      if (!out_ok) continue;
      const float4* rows = st.f32(s);
      const float* sc = st.scal(s);
      const int ne = min(kToepElems, n_list - s * kToepElems);
      // The listed b in ascending order: the accumulator's chain over the
      // batch is the first version's.
      for (int e = 0; e < ne; ++e) {
        const int win_e = list_win[s * kToepElems + e];
        const int lo = win_e & 0xffff;
        const unsigned width = static_cast<unsigned>((win_e >> 16) - lo);
        // The column test is the warp's (a branch), the row test a lane's.
        if (static_cast<unsigned>(m - lo) >= width || static_cast<unsigned>(l - lo) >= width) {
          continue;
        }
        const int at = e * 32 + lane;
        const float4 gl = rows[kG + at];
        const float cq = dot4(gl, rows[kO + at]);  // c as the dq pass's
        const float4 km = rows[kK + e * kToepCols + warp];  // a broadcast
        const float4 vm = rows[kV + e * kToepCols + warp];
        const float p = __expf(dot4(rows[kQ + at], km) + tv - sc[at]);
        acc = fmaf(p, dot4(gl, vm) - cq, acc);
      }
    }
    cp_async_wait<0>();
    __syncthreads();  // the ring and the list are free for the next elements
  }

  if (out_ok) *out = acc;
}

// Above 48 KB a block's dynamic shared memory must be allowed once per
// kernel instantiation.
template <typename K>
cudaError_t allow_smem(K kernel, int bytes) {
  return cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, bytes);
}

// Launch `kernel` after the stream's previous kernel with programmatic
// stream serialization: it may start once every block of that kernel has
// started, and completes only after it (each pass waits for the previous
// grid before it exits).
template <typename... Params, typename... Args>
cudaError_t launch_beside(void (*kernel)(Params...), int grid, size_t smem,
                          cudaStream_t stream, Args... args) {
  cudaLaunchAttribute attr;
  attr.id = cudaLaunchAttributeProgrammaticStreamSerialization;
  attr.val.programmaticStreamSerializationAllowed = 1;
  cudaLaunchConfig_t cfg = {};
  cfg.gridDim = dim3(grid);
  cfg.blockDim = dim3(kThreads);
  cfg.dynamicSmemBytes = smem;
  cfg.stream = stream;
  cfg.attrs = &attr;
  cfg.numAttrs = 1;
  return cudaLaunchKernelEx(&cfg, kernel, args...);
}

template <typename T>
cudaError_t launch_dtoep(const T* q, const T* k, const T* v, const T* toep,
                         const float* offsets, const T* g, const T* o, const float* lse,
                         float* dtoep, int B, int H, int L, int W, cudaStream_t stream) {
  static const cudaError_t allowed =
      allow_smem(attention_rpos_bwd_dtoep_kernel<T>, dtoep_bytes<T>());
  if (allowed != cudaSuccess) return allowed;
  const long long blocks =
      static_cast<long long>(H) * ((L + 31) / 32) * ((L + kToepCols - 1) / kToepCols);
  if (blocks > 0x7fffffffLL) return cudaErrorInvalidValue;
  attention_rpos_bwd_dtoep_kernel<T><<<static_cast<int>(blocks), kThreads, dtoep_bytes<T>(),
                                       stream>>>(
      q, k, v, toep, offsets, g, o, lse, dtoep, B, H, L, W);
  return cudaGetLastError();
}

template <typename T, int R>
cudaError_t launch_rows(const T* q, const T* k, const T* v, const T* toep,
                        const float* offsets, const T* g, const T* o, const float* lse,
                        float* c, T* dq, T* dk, T* dv, int B, int H, int L, int W,
                        cudaStream_t stream) {
  const int n_rows = B * H * L;  // below 2^31: checked by the caller
  const int grid = (n_rows + kThreads * R - 1) / (kThreads * R);
  const int cap = head_capacity(L, R);  // at most 766 rows: below 48 KB
  const size_t smem_dq = 2 * cap * sizeof(float4);
  const size_t smem_dkdv = cap * (2 * sizeof(float4) + sizeof(float2));
  cudaError_t err = launch_beside(attention_rpos_bwd_dq_kernel<T, R>, grid, smem_dq, stream,
                                  q, k, v, toep, offsets, g, o, lse, c, dq, H, L, W, n_rows);
  if (err != cudaSuccess) return err;
  return launch_beside(attention_rpos_bwd_dkdv_kernel<T, R>, grid, smem_dkdv, stream,
                       q, k, v, toep, offsets, g, o, lse, dk, dv, H, L, W, n_rows);
}

// The dtoep pass first (it waits on memory most), then the dq and dk/dv
// passes beside it: none reads another's output (the dk/dv and dtoep
// passes form c from g and o as the dq pass does).
template <typename T>
cudaError_t launch(const void* q, const void* k, const void* v,
                   const void* toep, const float* offsets, const void* g,
                   const void* o, const float* lse, float* c, void* dq,
                   void* dk, void* dv, float* dtoep, int B, int H, int L,
                   int W, cudaStream_t stream) {
  if (static_cast<long long>(B) * H * L > 0x7fffffffLL) return cudaErrorInvalidValue;
  const T* qt = static_cast<const T*>(q);
  const T* kt = static_cast<const T*>(k);
  const T* vt = static_cast<const T*>(v);
  const T* tt = static_cast<const T*>(toep);
  const T* gt = static_cast<const T*>(g);
  const T* ot = static_cast<const T*>(o);
  T* dqt = static_cast<T*>(dq);
  T* dkt = static_cast<T*>(dk);
  T* dvt = static_cast<T*>(dv);
  const cudaError_t err =
      launch_dtoep<T>(qt, kt, vt, tt, offsets, gt, ot, lse, dtoep, B, H, L, W, stream);
  if (err != cudaSuccess) return err;
  return L % 2 == 0 ? launch_rows<T, 2>(qt, kt, vt, tt, offsets, gt, ot, lse, c, dqt, dkt, dvt,
                                        B, H, L, W, stream)
                    : launch_rows<T, 1>(qt, kt, vt, tt, offsets, gt, ot, lse, c, dqt, dkt, dvt,
                                        B, H, L, W, stream);
}

// dtoep past the D = 4 kernel (the window kernel and the wide passes). Their
// dq pass leaves each head's ds inside its element's window in `ds`, an f32
// (B, H, W', W') scratch, W' = min(W, L), entry (l, m) at (l - s_b, m - s_b)
// with s_b the window's first position (attention_bwd_mma.cuh
// store_window_ds); this kernel forms
//   dtoep[h, l, m] = sum_b ds_b[l - s_b, m - s_b] over the b whose window
//                    holds both l and m,
// one thread an (h, l, m), b ascending: one ordered f32 sum per output, no
// atomics. It replaces the first design's dtoep pass, which formed S and dP
// a third time on a grid of H x 64 x 64 tiles (4 blocks at (L, H) = (128,
// 1)).
// What bounds it: bytes, the scratch's windowed entries read once and
// dtoep (H, L, L) written once. A block is kSumThreads consecutive keys of
// one (h, l), H * L * L / 64 blocks (256 at (128, 1): every SM busy). Per
// kSumThreads elements the block lists, in order, those whose window holds
// its row (a ballot and a prefix over its two warps), then every thread
// walks the list, adding the entries whose window also holds its key
// (neighbouring threads, neighbouring addresses). A block whose keys all
// lie W' or more from its row, where no window holds both, writes zeros.
constexpr int kSumThreads = 64;

__global__ void __launch_bounds__(kSumThreads)
attention_rpos_dtoep_sum_kernel(const float* __restrict__ ds, const float* __restrict__ offsets,
                                float* __restrict__ dtoep, int B, int H, int L, int W) {
  __shared__ int4 list[kSumThreads];  // (b, window lo, window hi) of the listed elements
  __shared__ int counts[kSumThreads / 32];
  const int Wp = W < L ? W : L;
  const int m0 = blockIdx.x * kSumThreads, m = m0 + threadIdx.x;
  const int l = blockIdx.y, h = blockIdx.z;
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  float acc = 0.f;
  if (m0 < l + Wp && m0 + kSumThreads > l - Wp + 1) {  // a key of the block within the band
    for (int b0 = 0; b0 < B; b0 += kSumThreads) {
      const int b = b0 + threadIdx.x;
      const Window win = window_of(b < B ? offsets[b] : 0.f, W, L);
      const bool holds = b < B && win.has(l);
      const unsigned mask = __ballot_sync(0xffffffffu, holds);
      if (lane == 0) counts[warp] = __popc(mask);
      __syncthreads();
      int at = __popc(mask & ((1u << lane) - 1u)), n = 0;
#pragma unroll
      for (int i = 0; i < kSumThreads / 32; ++i) {
        at += i < warp ? counts[i] : 0;
        n += counts[i];
      }
      if (holds) list[at] = make_int4(b, win.lo, win.hi, 0);
      __syncthreads();
      for (int i = 0; i < n; ++i) {
        const int4 e = list[i];
        if (m >= e.y && m < e.z) {
          acc += ds[((static_cast<size_t>(e.x) * H + h) * Wp + (l - e.y)) * Wp + (m - e.y)];
        }
      }
      __syncthreads();  // the list is read before the next chunk overwrites it
    }
  }
  if (m < L) dtoep[(static_cast<size_t>(h) * L + l) * L + m] = acc;
}

cudaError_t launch_dtoep_sum(const float* ds, const float* offsets, float* dtoep, int B, int H,
                             int L, int W, cudaStream_t stream) {
  if (L > 65535 || H > 65535) return cudaErrorInvalidValue;
  const dim3 grid((L + kSumThreads - 1) / kSumThreads, L, H);
  attention_rpos_dtoep_sum_kernel<<<grid, kSumThreads, 0, stream>>>(ds, offsets, dtoep, B, H, L,
                                                                    W);
  return cudaGetLastError();
}

}  // namespace

// Plain C interface for ctypes. D: 4 (the passes above at L <= kMaxL, the
// window kernel past it), 8, 16, 32, 64 (the window kernel, any L whose
// grids fit an int; bf16 from 16) or a multiple of 64 past 64 (the wide
// passes, any L). dtype: 0 = float32, 1 = bfloat16. `lse` is the forward's
// float32 (B, H, L) residual, `c` a float32 (B, H, L) scratch the call
// fills; with the D = 4 passes `dtoep` is the float32 (1, H, L, L) output
// (`ds` may be null), with every other kernel `ds` the float32 (B, H, W',
// W') scratch, W' = min(W, L), that ecg_attention_rpos_dtoep_sum then sums
// into dtoep (`dtoep` not written). Launches on `stream` of card `device`,
// does not synchronise and allocates nothing. Returns the first failing
// launch's cudaError_t (0 = success).
extern "C" int ecg_attention_rpos_bwd(const void* q, const void* k,
                                      const void* v, const void* toep,
                                      const void* offsets, const void* g,
                                      const void* o, const void* lse, void* c,
                                      void* dq, void* dk, void* dv,
                                      void* dtoep, void* ds, int B, int H, int L,
                                      int D, int W, int dtype, int device,
                                      void* stream) {
  const bool small = D == kD && L <= kMaxL;
  if (B < 1 || H < 1 || L < 1 || W < 1 || toep == nullptr || offsets == nullptr ||
      (small ? dtoep : ds) == nullptr) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return static_cast<int>(err);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const float* off = static_cast<const float*>(offsets);
  const float* lse_f = static_cast<const float*>(lse);
  float* c_f = static_cast<float*>(c);
  float* dtoep_f = static_cast<float*>(dtoep);
  float* ds_f = static_cast<float*>(ds);
  switch (dtype) {
    case 0:
      err = small ? launch<float>(q, k, v, toep, off, g, o, lse_f, c_f, dq, dk, dv, dtoep_f,
                                  B, H, L, W, s)
            : D <= mma_bwd::kWideD
                ? rpos_bwd::launch<float>(q, k, v, toep, off, g, o, lse_f, c_f, dq, dk, dv, ds_f,
                                          B, H, L, D, W, s)
                : mma_bwd::launch_wide<float, true>(q, k, v, toep, g, o, lse_f, c_f, dq, dk, dv,
                                                    ds_f, B, H, L, D, off, W, s);
      break;
    case 1:
      err = small ? launch<__nv_bfloat16>(q, k, v, toep, off, g, o, lse_f, c_f, dq, dk, dv,
                                          dtoep_f, B, H, L, W, s)
            : D <= mma_bwd::kWideD
                ? rpos_bwd::launch<__nv_bfloat16>(q, k, v, toep, off, g, o, lse_f, c_f, dq, dk,
                                                  dv, ds_f, B, H, L, D, W, s)
                : mma_bwd::launch_wide<__nv_bfloat16, true>(q, k, v, toep, g, o, lse_f, c_f, dq,
                                                            dk, dv, ds_f, B, H, L, D, off, W,
                                                            s);
      break;
    default:
      err = cudaErrorInvalidValue;
  }
  return static_cast<int>(err);
}

// The dtoep sum (attention_rpos_dtoep_sum_kernel) for a call past the D = 4
// kernel, after ecg_attention_rpos_bwd has filled `ds`: `dtoep` the
// float32 (1, H, L, L) output, `offsets` and W the call's. Launches on
// `stream` of card `device`, does not synchronise and allocates nothing.
// Returns the launch's cudaError_t (0 = success).
extern "C" int ecg_attention_rpos_dtoep_sum(const void* ds, const void* offsets, void* dtoep,
                                            int B, int H, int L, int W, int device,
                                            void* stream) {
  if (B < 1 || H < 1 || L < 1 || W < 1 || ds == nullptr || offsets == nullptr ||
      dtoep == nullptr) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return static_cast<int>(err);
  return static_cast<int>(launch_dtoep_sum(static_cast<const float*>(ds),
                                           static_cast<const float*>(offsets),
                                           static_cast<float*>(dtoep), B, H, L, W,
                                           static_cast<cudaStream_t>(stream)));
}

// The wide passes' clusters at head dim D (a multiple of 64 past 64):
// out[0] the dq pass's size in blocks, out[1] the clusters of it card
// `device` holds at once (cudaOccupancyMaxActiveClusters), out[2] and out[3]
// the dk/dv pass's.
// dtype as above; with_bias is not read (the window mode has its bias).
// Returns a cudaError_t (0 = success).
extern "C" int ecg_wide_clusters(int D, int dtype, int with_bias, int device, int* out) {
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return static_cast<int>(err);
  switch (dtype) {
    case 0: err = mma_bwd::wide_clusters<float, true>(D, with_bias != 0, out); break;
    case 1: err = mma_bwd::wide_clusters<__nv_bfloat16, true>(D, with_bias != 0, out); break;
    default: err = cudaErrorInvalidValue;
  }
  return static_cast<int>(err);
}

extern "C" const char* ecg_cuda_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}
