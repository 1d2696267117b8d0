// Dense-packed attention forward (B5) — RA-LENet's short-sequence attention
// stages on Hopper (sm_90a), the eval forward with ECG_ATTN_DENSE=1; and, at
// head_dim 32, Transformer1d's (the second kernel, at the end of this file,
// behind the same C entry point).
//
// Replaces the TPU kernel ecg_denoise_tpu/kernels/attention_pallas.py
// _fwd_dense_kernel (:449), launched through _fwd_dense (:524-559, the
// pallas_call at :546) from fused_attention -> _fused_single -> _fwd (:618)
// when the stage is lane-packable (_pack_factor: L < 128 a power of two,
// P = min(128 / L, H) > 1), ECG_ATTN_DENSE=1 and no softmax residual is
// wanted.
//
// Computes exactly attention_fwd.cu's function, without the lse:
//   out[b,h,l,:] = sum_m p[l,m] * v[b,h,m,:]
//   p[l,:]       = softmax_m(q[b,h,l,:] . k[b,h,m,:] + bias[0,h,l,m])
// q arrives pre-scaled. Operands are contiguous (B, H, L, D) with D = 4;
// bias is a contiguous (1, H, L, L) array shared by the batch, or absent.
// float32 and bfloat16 operands; logits, the row max, exp, the sums and the
// weighted sum are float32, and the output is rounded once.
//
// Where it parts from the TPU kernel on purpose: the TPU kernel subtracts
// ONE max over the whole packed (L, P*L) row, across all P heads, and
// clamps the sum at 1e-37; a head whose logits sit some 87 below another
// head's at the same query underflows to a zero sum and its output
// collapses. Here every head subtracts its own row max: the exact softmax.
// The two agree wherever the TPU kernel is exact (ROADMAP section C).
//
// What bounds it: per (b, h) the work is 2*(2*L*L*D + L*L) flops and L*L
// exps against 4*L*D operand elements plus the shared bias. At the four
// shapes the route takes in RA-LENet, B = 1024, f32, that is HBM: 33.7 MB
// at (L, H) = (64, 8), 33.6 MB at (32, 16), 33.5 MB at (16, 32) and 16.8 MB
// at (64, 4), about 10 us (5 us at (64, 4)) at 3.35 TB/s, against 9.0, 4.5,
// 2.3 and 4.5 us of f32 arithmetic at 67 TFLOP/s. D = 4 is below every
// tensor-core shape. The flop count leaves out the exps, the bias adds, the
// max and the shared-memory loads: this design issues about 21 instructions
// per (row, key) pair (its SASS at L = 64 with the bias: 7.3 FFMA, 4 FMUL,
// 3 FADD, 2.3 LDS, 1.05 FMNMX, 1 FSETP and 1.06 MUFU; __expf's exact path
// for tiny results is the FSETP and two of the FMULs) where the bound counts
// 9 flops.
//
// Design: the TPU's dense (L, P*L) tile, held a row per thread.
// * Grid. A block owns the P heads that the TPU packs into one 128-lane
//   row (a head group g) and a group of batch elements; the last group is
//   ragged. It has one thread per (head, query row), P*L threads: 128 at
//   the route's four RA-LENet shapes. Where P*L < 128 the block takes
//   128 / (P*L) elements side by side, so that no block is a few warps.
//   It walks `iters` rounds of those elements (at most kMaxIters), chosen
//   at launch so that the grid is about kBlocksPerSM blocks an SM: the
//   blocks of one call are resident together, in one wave.
// * Bias, staged once per block. The block copies its P heads' (L x L)
//   bias rows into shared memory once, as f32, and reuses them over all
//   its elements: the previous design read each warp's bias rows
//   from global memory (L2) for every element, B*H*L*L*elt a call (134 MB
//   at (64, 8), B = 1024, f32, four times the call's byte bound); now
//   (B / nb)*H*L*L*elt, nb the block's elements. Thread r reads row r 16
//   bytes at a time (LDS.128): with a row stride of L + 4 floats (L >= 8)
//   the 8 lanes of a quarter warp start 4 banks apart, conflict-free.
// * K, V and q. Each element's P*L rows of q, K and V reach shared memory
//   by cp.async (a thread its own row of each), double-buffered: the next
//   element is in flight while this one is used. bf16 rows land raw and
//   are converted to f32 once, in shared memory. A warp's lanes read one
//   key of one head at a time: a broadcast.
// * One pass over the keys. L <= 64, so a thread holds its row's L logits
//   in registers (the kernel is templated on L): each dot4 is computed
//   once, then the max over the registers, then exp, the sum and the
//   V-weighted sum. No shuffles, no cross-lane reductions: the previous
//   design spread a row over 32 / P lanes and reduced it with butterfly
//   shuffles after dependent global loads, a row after another.
// * B1's arithmetic, keys in order: x = dot4(q, k), x += bias, the row max
//   by fmaxf (exact, so its order does not matter), then __expf(x - mx),
//   sum += ex and fmaf(ex, v, acc) in key order, and acc / sum: the output
//   equals attention_fwd.cu's without lse bit for bit, f32 and bf16. No
//   atomics: two calls give bit-identical outputs.
//
// Measured (chip_smoke.py phase 16, NVIDIA H100 80GB HBM3, 700.00 W power
// limit; CUDA graph replays at B = 1024, in turns with this kernel's
// previous design, a warp per query row): f32 33.8 us at (L, H) = (64, 8)
// with the bias (the previous design 116.5, attention_fwd.cu without lse
// 50.7), 19.6 at (32, 16) (59.0, 27.8), 11.4 at (16, 32) without a bias
// (29.5, 17.4), 18.6 at (64, 4) (59.7, 27.2); bf16 33.3, 19.6, 12.2 and
// 19.1 us. Tried on the card and dropped, each slower or level at the
// route's shapes: the f32 bias tile copied by cp.async with the first
// element's rows; the grid sized by the occupancy calculator; two query
// rows of one head a thread, so that each K and V load feeds both.

#include <cuda_bf16.h>
#include <cuda_runtime.h>

#include <cstdint>

namespace {

constexpr int kD = 4;
constexpr int kMaxPairs = 128;    // P*L of the route: the TPU's 128-lane row
constexpr int kMaxIters = 16;     // elements a thread walks in one block, at most
constexpr int kBlocksPerSM = 4;   // the grid this aims at, per SM

__device__ __forceinline__ float4 to_float4(uint2 raw) {  // 4 bf16, low first
  return make_float4(__uint_as_float(raw.x << 16), __uint_as_float(raw.x & 0xffff0000u),
                     __uint_as_float(raw.y << 16), __uint_as_float(raw.y & 0xffff0000u));
}

// One (b, h, l) row of 4 bf16 operand values as f32.
__device__ __forceinline__ float4 load4(const __nv_bfloat16* p) {
  return to_float4(*reinterpret_cast<const uint2*>(p));
}

__device__ __forceinline__ float to_float(float x) { return x; }
__device__ __forceinline__ float to_float(__nv_bfloat16 x) { return __bfloat162float(x); }

// 16 bytes of bias as f32 values.
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

__device__ __forceinline__ float dot4(float4 a, float4 b) {
  float s = a.x * b.x;
  s = fmaf(a.y, b.y, s);
  s = fmaf(a.z, b.z, s);
  return fmaf(a.w, b.w, s);
}

// cp.async of one operand row (16 bytes f32, 8 bytes bf16) into shared memory.
template <typename T>
__device__ __forceinline__ void cp_async_row(void* dst, const T* src) {
  const unsigned s = static_cast<unsigned>(__cvta_generic_to_shared(dst));
  if constexpr (sizeof(T) == 4) {
    asm volatile("cp.async.cg.shared.global [%0], [%1], 16;\n" ::"r"(s), "l"(src));
  } else {
    asm volatile("cp.async.ca.shared.global [%0], [%1], 8;\n" ::"r"(s), "l"(src));
  }
}

__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::);
}

__device__ __forceinline__ void cp_async_wait_all() {
  asm volatile("cp.async.wait_group 0;\n" ::);
}

// The tiling of one call, the same on host and device.
struct Tiling {
  int rows;     // (head, query row) pairs of one element: P * L
  int slots;    // elements side by side in a block: 128 / rows, at least 1
  int threads;  // slots * rows
  int stride;   // the bias tile's row stride in floats
  int bias_bytes;  // the bias tile, rounded up to 16 bytes
  __host__ __device__ Tiling(int L, int P) {
    rows = P * L;
    slots = rows < kMaxPairs ? kMaxPairs / rows : 1;
    threads = slots * rows;
    stride = L >= 8 ? L + 4 : L;  // L <= 4: one 16-byte row or less, packed
    bias_bytes = (rows * stride * 4 + 15) / 16 * 16;
  }
};

// Shared memory, in bytes: the bias tile (with a bias), then two buffers of
// q, K and V rows as they arrive, then (bf16) one buffer of K and V in f32.
template <typename T>
__host__ __device__ int smem_bytes(int L, int P, bool with_bias) {
  const Tiling t(L, P);
  const int staged = 2 * 3 * t.threads * kD * static_cast<int>(sizeof(T));
  const int converted = sizeof(T) == 4 ? 0 : 2 * t.threads * 16;
  return (with_bias ? t.bias_bytes : 0) + staged + converted;
}

// The most any call takes: 128 rows of 64 keys. Below 48 KB, so no launch
// needs the opt-in to more dynamic shared memory.
static_assert(128 * 68 * 4 + 2 * 3 * 128 * 16 <= 48 * 1024, "f32 shared memory");
static_assert(128 * 68 * 4 + 2 * 3 * 128 * 8 + 2 * 128 * 16 <= 48 * 1024, "bf16 shared memory");

template <typename T, int L, bool kBias>
__global__ void __launch_bounds__(kMaxPairs)
attention_dense_fwd_kernel(const T* __restrict__ q, const T* __restrict__ k,
                           const T* __restrict__ v, const T* __restrict__ bias,
                           T* __restrict__ o, int B, int H, int P, int iters,
                           bool bias_vec) {
  extern __shared__ __align__(16) unsigned char smem[];
  const Tiling t(L, P);
  const int groups = H / P;
  const int g = blockIdx.x % groups;
  const int elems = iters * t.slots;                 // elements of a full block
  const int b0 = (blockIdx.x / groups) * elems;
  const int n_elems = min(elems, B - b0);            // elements of this block
  const int n_iters = (n_elems + t.slots - 1) / t.slots;
  const int tid = threadIdx.x;
  const int slot = tid / t.rows;
  const int r = tid - slot * t.rows;  // p * L + l: the head group's row
  const int p = r / L;

  constexpr int kRowBytes = kD * sizeof(T);
  float* tile = reinterpret_cast<float*>(smem);
  unsigned char* staged = smem + (kBias ? t.bias_bytes : 0);
  const int buf_bytes = 3 * t.threads * kRowBytes;  // one buffer: q, K, V rows
  float4* kvf = reinterpret_cast<float4*>(staged + 2 * buf_bytes);  // bf16 only

  // Start the cp.async copies of element (it * slots + slot)'s rows r of q, K and V.
  auto stage = [&](int it) {
    const int e = it * t.slots + slot;
    if (e < n_elems) {
      const size_t row = (static_cast<size_t>(b0 + e) * H + static_cast<size_t>(g) * P) * L + r;
      unsigned char* dst = staged + (it & 1) * buf_bytes + tid * kRowBytes;
      cp_async_row(dst, q + row * kD);
      cp_async_row(dst + t.threads * kRowBytes, k + row * kD);
      cp_async_row(dst + 2 * t.threads * kRowBytes, v + row * kD);
    }
    cp_async_commit();
  };

  stage(0);
  if (kBias) {  // the group's (P*L x L) rows, once per block, as f32
    const T* src = bias + static_cast<size_t>(g) * t.rows * L;
    const int n = t.rows * L;
    if (bias_vec) {  // 16-byte loads: L * elt and the group's start are 16-aligned
      constexpr int kVec = 16 / sizeof(T);
#pragma unroll 4
      for (int i = tid * kVec; i < n; i += t.threads * kVec) {
        float vals[kVec];
        unpack(*reinterpret_cast<const uint4*>(src + i), vals);
        const int row = i / L, m = i - row * L;  // L % kVec == 0: one row
        float4* dst = reinterpret_cast<float4*>(tile + row * t.stride + m);
#pragma unroll
        for (int j = 0; j < kVec / 4; ++j) {
          dst[j] = make_float4(vals[4 * j], vals[4 * j + 1], vals[4 * j + 2], vals[4 * j + 3]);
        }
      }
    } else {
#pragma unroll 4
      for (int i = tid; i < n; i += t.threads) {
        const int row = i / L, m = i - row * L;
        tile[row * t.stride + m] = to_float(src[i]);
      }
    }
  }
  const float* brow = tile + r * t.stride;

  for (int it = 0; it < n_iters; ++it) {
    cp_async_wait_all();
    // This element's rows are in for every thread, and every thread is
    // done with the buffer that the next element's rows overwrite.
    __syncthreads();
    if (it + 1 < n_iters) stage(it + 1);
    const unsigned char* buf = staged + (it & 1) * buf_bytes;
    const bool ok = it * t.slots + slot < n_elems;
    float4 qr = make_float4(0.f, 0.f, 0.f, 0.f);
    const float4* kh;  // this head's L keys
    if constexpr (sizeof(T) == 4) {
      const float4* fb = reinterpret_cast<const float4*>(buf);
      if (ok) qr = fb[tid];
      kh = fb + t.threads + slot * t.rows + p * L;
    } else {  // bf16: convert this thread's rows of K and V once
      if (ok) {
        qr = load4(reinterpret_cast<const T*>(buf + tid * kRowBytes));
        kvf[tid] = load4(reinterpret_cast<const T*>(buf + (t.threads + tid) * kRowBytes));
        kvf[t.threads + tid] =
            load4(reinterpret_cast<const T*>(buf + (2 * t.threads + tid) * kRowBytes));
      }
      __syncthreads();
      kh = kvf + slot * t.rows + p * L;
    }
    if (!ok) continue;
    const float4* vh = kh + t.threads;  // V's rows follow K's, the same layout

    float s[L];  // the row's logits, in registers
    if constexpr (L >= 4) {
#pragma unroll
      for (int m = 0; m < L; m += 4) {
        float4 b4 = make_float4(0.f, 0.f, 0.f, 0.f);
        if (kBias) b4 = *reinterpret_cast<const float4*>(brow + m);
        const float bm[4] = {b4.x, b4.y, b4.z, b4.w};
#pragma unroll
        for (int j = 0; j < 4; ++j) {
          float x = dot4(qr, kh[m + j]);
          if (kBias) x += bm[j];
          s[m + j] = x;
        }
      }
    } else {
#pragma unroll
      for (int m = 0; m < L; ++m) {
        float x = dot4(qr, kh[m]);
        if (kBias) x += brow[m];
        s[m] = x;
      }
    }
    // The row max: fmaxf is exact, so four interleaved chains give the
    // same value as one in key order.
    float mx4[4];
#pragma unroll
    for (int j = 0; j < 4; ++j) mx4[j] = __int_as_float(0xff800000);  // -inf
#pragma unroll
    for (int m = 0; m < L; ++m) mx4[m & 3] = fmaxf(mx4[m & 3], s[m]);
    const float mx = fmaxf(fmaxf(mx4[0], mx4[1]), fmaxf(mx4[2], mx4[3]));

    // exp, the sum and the V-weighted sum, keys in order.
    float sum = 0.f;
    float4 acc = make_float4(0.f, 0.f, 0.f, 0.f);
#pragma unroll
    for (int m = 0; m < L; ++m) {
      const float ex = __expf(s[m] - mx);
      const float4 vv = vh[m];
      sum += ex;
      acc.x = fmaf(ex, vv.x, acc.x);
      acc.y = fmaf(ex, vv.y, acc.y);
      acc.z = fmaf(ex, vv.z, acc.z);
      acc.w = fmaf(ex, vv.w, acc.w);
    }
    const size_t row =
        (static_cast<size_t>(b0 + it * t.slots + slot) * H + static_cast<size_t>(g) * P) * L + r;
    store4(o + row * kD,
           make_float4(acc.x / sum, acc.y / sum, acc.z / sum, acc.w / sum));
  }
}

template <typename T, int L>
cudaError_t launch_l(const T* q, const T* k, const T* v, const T* bias, T* o,
                     int B, int H, int P, int device, cudaStream_t stream) {
  const Tiling t(L, P);
  const int groups = H / P;
  int sms = 0;
  const cudaError_t err = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, device);
  if (err != cudaSuccess) return err;
  // Elements a thread walks: enough that the grid is about kBlocksPerSM
  // blocks an SM, all resident at once, and no more than kMaxIters.
  const long long work = static_cast<long long>((B + t.slots - 1) / t.slots) * groups;
  const long long want = static_cast<long long>(kBlocksPerSM) * sms;
  long long iters = (work + want - 1) / want;
  if (iters < 1) iters = 1;
  if (iters > kMaxIters) iters = kMaxIters;
  const long long elems = iters * t.slots;
  const long long blocks = (B + elems - 1) / elems * groups;
  if (blocks > 0x7fffffffLL) return cudaErrorInvalidValue;
  const bool with_bias = bias != nullptr;
  const bool bias_vec = with_bias && (L * sizeof(T)) % 16 == 0 &&
                        reinterpret_cast<uintptr_t>(bias) % 16 == 0;
  const int smem = smem_bytes<T>(L, P, with_bias);
  if (with_bias) {
    attention_dense_fwd_kernel<T, L, true><<<static_cast<int>(blocks), t.threads, smem, stream>>>(
        q, k, v, bias, o, B, H, P, static_cast<int>(iters), bias_vec);
  } else {
    attention_dense_fwd_kernel<T, L, false><<<static_cast<int>(blocks), t.threads, smem, stream>>>(
        q, k, v, bias, o, B, H, P, static_cast<int>(iters), false);
  }
  return cudaGetLastError();
}

template <typename T>
cudaError_t launch(const void* q, const void* k, const void* v,
                   const void* bias, void* o, int B, int H, int L, int P,
                   int device, cudaStream_t stream) {
  const T* qt = static_cast<const T*>(q);
  const T* kt = static_cast<const T*>(k);
  const T* vt = static_cast<const T*>(v);
  const T* bt = static_cast<const T*>(bias);
  T* ot = static_cast<T*>(o);
  switch (L) {
    case 1: return launch_l<T, 1>(qt, kt, vt, bt, ot, B, H, P, device, stream);
    case 2: return launch_l<T, 2>(qt, kt, vt, bt, ot, B, H, P, device, stream);
    case 4: return launch_l<T, 4>(qt, kt, vt, bt, ot, B, H, P, device, stream);
    case 8: return launch_l<T, 8>(qt, kt, vt, bt, ot, B, H, P, device, stream);
    case 16: return launch_l<T, 16>(qt, kt, vt, bt, ot, B, H, P, device, stream);
    case 32: return launch_l<T, 32>(qt, kt, vt, bt, ot, B, H, P, device, stream);
    case 64: return launch_l<T, 64>(qt, kt, vt, bt, ot, B, H, P, device, stream);
    default: return cudaErrorInvalidValue;
  }
}

// ---------------------------------------------------------------------------
// head_dim 32: Transformer1d's lane-packable stages. At its defaults on 256
// samples those are (L, H) = (64, 16), P = 2, and (32, 32), P = 4: 6 and 2
// of the 12 attention calls of one forward. The D = 4 kernel above is left
// as it is, bit for bit.
//
// Computes the same function at D = 32: softmax(q.k^T + bias).v over
// contiguous (B, H, L, 32) operands, q pre-scaled, bias (1, H, L, L) or
// absent, f32 or bf16, no lse. Every head subtracts its own row max, where
// the TPU kernel subtracts one max over the packed row of P heads (see
// above).
//
// What bounds it. Per (b, h) the work is 2*(2*L*L*D + L*L) flops against
// 4*L*D operand elements: at the two stages and B = 256, f32, 2.18 and
// 1.09 GFLOP a call, 33 and 16 us at 67 TFLOP/s, against 134 MB of q, k, v
// and o, 40 us at 3.35 TB/s: the bytes bound it, by a little at (64, 16).
// This first version stays in f32 on the CUDA cores, as B1 at D = 32 does.
//
// Design, simple first: the TPU packs P heads into one (L, P*L) row of
// logits; here a block owns the same P heads (a head group g) of one
// element and has one thread per (head, query row), P*L threads (128 at
// both Transformer1d stages). The block's P heads are contiguous in the
// (B, H, L, D) layout, so their K and V rows, P*L rows of 32 (16 KB each
// as f32), are staged once per element into shared memory with 16-byte
// loads (bf16 converted as it lands) and read by a warp as broadcasts.
// Each thread keeps its q row and its f32 output accumulator in registers
// and makes B1 at D = 32's pass over its head's L keys, in chunks of 32
// keys with an online softmax, with the same operations in the same order:
// the output equals attention_fwd.cu's D = 32 kernel without lse, given the
// same contraction into FMAs by the compiler (chip_smoke.py phase 25
// checks it). With a bias, the group's (P*L x L) tile is staged once per
// block as f32 (row stride L | 1, odd: the lanes' reads at one key fall in
// distinct banks), and the block walks `elems` elements so that it is
// reused; without one, a block is one element. No atomics: a call gives
// bit-identical results every time.
//
// Measured (chip_smoke.py phase 25, NVIDIA H100 80GB HBM3, 700.00 W power
// limit; CUDA graph replays at B = 256, f32, no bias, in turns with B1 at
// D = 32 without lse): 166.8 us at (64, 16) (B1 165.9), 123.3 us at (32,
// 32) (B1 128.2); 1.248 ms over a forward's 8 calls against B1's 1.251, 3.9
// times the bound. Equal to B1 bit for bit at every case checked. 151-154
// registers, no spills.

constexpr int kD32 = 32;
constexpr int kChunk32 = 32;  // keys of one online-softmax step

// Dynamic shared memory, in bytes: K and V of the group as f32, then the
// bias tile.
__host__ __device__ inline int smem_bytes_d32(int L, int P, bool with_bias) {
  return 2 * P * L * kD32 * 4 + (with_bias ? P * L * (L | 1) * 4 : 0);
}

// stage_f32, load_row32, store_row32 and dot32 below are copies of the
// helpers of the same names in attention_fwd.cu (each library is built from
// one source). Keep them identical: this kernel equals B1 at D = 32 bit for
// bit only while they do the same operations in the same order.

// n contiguous operand values (n a multiple of 8, src 16-byte aligned)
// into shared memory as f32, 16 bytes a load.
__device__ __forceinline__ void stage_f32(float* dst, const float* src, int n) {
  for (int i = threadIdx.x * 4; i < n; i += blockDim.x * 4) {
    *reinterpret_cast<float4*>(dst + i) = *reinterpret_cast<const float4*>(src + i);
  }
}

__device__ __forceinline__ void stage_f32(float* dst, const __nv_bfloat16* src, int n) {
  for (int i = threadIdx.x * 8; i < n; i += blockDim.x * 8) {
    float vals[8];
    unpack(*reinterpret_cast<const uint4*>(src + i), vals);
    float4* d = reinterpret_cast<float4*>(dst + i);
    d[0] = make_float4(vals[0], vals[1], vals[2], vals[3]);
    d[1] = make_float4(vals[4], vals[5], vals[6], vals[7]);
  }
}

// One 32-value operand row into registers as f32.
__device__ __forceinline__ void load_row32(const float* p, float (&r)[kD32]) {
#pragma unroll
  for (int i = 0; i < kD32 / 4; ++i) {
    const float4 x = reinterpret_cast<const float4*>(p)[i];
    r[4 * i] = x.x; r[4 * i + 1] = x.y; r[4 * i + 2] = x.z; r[4 * i + 3] = x.w;
  }
}

__device__ __forceinline__ void load_row32(const __nv_bfloat16* p, float (&r)[kD32]) {
#pragma unroll
  for (int i = 0; i < kD32 / 8; ++i) {
    float vals[8];
    unpack(reinterpret_cast<const uint4*>(p)[i], vals);
#pragma unroll
    for (int j = 0; j < 8; ++j) r[8 * i + j] = vals[j];
  }
}

// r / div, rounded once to the operand dtype.
__device__ __forceinline__ void store_row32(float* p, const float (&r)[kD32], float div) {
#pragma unroll
  for (int i = 0; i < kD32 / 4; ++i) {
    reinterpret_cast<float4*>(p)[i] = make_float4(r[4 * i] / div, r[4 * i + 1] / div,
                                                  r[4 * i + 2] / div, r[4 * i + 3] / div);
  }
}

__device__ __forceinline__ void store_row32(__nv_bfloat16* p, const float (&r)[kD32],
                                            float div) {
  __nv_bfloat162* p2 = reinterpret_cast<__nv_bfloat162*>(p);
#pragma unroll
  for (int i = 0; i < kD32 / 2; ++i) {
    p2[i] = __floats2bfloat162_rn(r[2 * i] / div, r[2 * i + 1] / div);
  }
}

// a . b for a row in registers and one in shared memory (a broadcast), in
// four interleaved chains: B1 at D = 32's order.
__device__ __forceinline__ float dot32(const float (&a)[kD32], const float* b) {
  const float4* b4 = reinterpret_cast<const float4*>(b);
  float s0 = 0.f, s1 = 0.f, s2 = 0.f, s3 = 0.f;
#pragma unroll
  for (int i = 0; i < kD32 / 4; ++i) {
    const float4 x = b4[i];
    s0 = fmaf(a[4 * i], x.x, s0);
    s1 = fmaf(a[4 * i + 1], x.y, s1);
    s2 = fmaf(a[4 * i + 2], x.z, s2);
    s3 = fmaf(a[4 * i + 3], x.w, s3);
  }
  return (s0 + s1) + (s2 + s3);
}

template <typename T, bool kBias>
__global__ void __launch_bounds__(kMaxPairs)
attention_dense_fwd_d32_kernel(const T* __restrict__ q, const T* __restrict__ k,
                               const T* __restrict__ v, const T* __restrict__ bias,
                               T* __restrict__ o, int B, int H, int L, int P, int elems) {
  extern __shared__ __align__(16) unsigned char smem[];
  const int rows = P * L;  // the group's (head, query row) pairs: blockDim.x
  const int groups = H / P;
  const int g = blockIdx.x % groups;
  const int b0 = (blockIdx.x / groups) * elems;
  const int n_elems = min(elems, B - b0);
  const int stride = L | 1;
  float* ks = reinterpret_cast<float*>(smem);
  float* vs = ks + rows * kD32;
  float* bs = vs + rows * kD32;
  const int r = threadIdx.x;  // p * L + l
  const float* kh = ks + (r / L) * L * kD32;  // this thread's head's L keys
  const float* vh = vs + (r / L) * L * kD32;

  if constexpr (kBias) {  // the group's rows, contiguous in (1, H, L, L)
    const T* src = bias + static_cast<size_t>(g) * rows * L;
    for (int i = threadIdx.x; i < rows * L; i += blockDim.x) {
      const int rr = i / L, m = i - rr * L;
      bs[rr * stride + m] = to_float(src[i]);
    }
  }
  const float* brow = bs + r * stride;

  for (int e = 0; e < n_elems; ++e) {
    // The group's first row: its P heads' rows follow it.
    const size_t base = (static_cast<size_t>(b0 + e) * H + static_cast<size_t>(g) * P) * L;
    __syncthreads();  // every thread is done with the last element's K and V
    stage_f32(ks, k + base * kD32, rows * kD32);
    stage_f32(vs, v + base * kD32, rows * kD32);
    __syncthreads();

    float qr[kD32], acc[kD32];
#pragma unroll
    for (int d = 0; d < kD32; ++d) acc[d] = 0.f;
    load_row32(q + (base + r) * kD32, qr);
    float mx = __int_as_float(0xff800000), sum = 0.f;  // -inf, 0

    for (int m0 = 0; m0 < L; m0 += kChunk32) {
      const int cn = min(kChunk32, L - m0);
      float s[kChunk32];
      float cmax = __int_as_float(0xff800000);
#pragma unroll
      for (int j = 0; j < kChunk32; ++j) {
        if (j < cn) {
          float x = dot32(qr, kh + (m0 + j) * kD32);
          if constexpr (kBias) x += brow[m0 + j];
          s[j] = x;
          cmax = fmaxf(cmax, x);
        }
      }
      const float mnew = fmaxf(mx, cmax);
      const float scale = __expf(mx - mnew);  // 0 at the first chunk, 1 if the max holds
      mx = mnew;
      sum *= scale;
#pragma unroll
      for (int d = 0; d < kD32; ++d) acc[d] *= scale;
#pragma unroll
      for (int j = 0; j < kChunk32; ++j) {
        if (j < cn) {
          const float ex = __expf(s[j] - mx);
          const float4* vr = reinterpret_cast<const float4*>(vh + (m0 + j) * kD32);
          sum += ex;
#pragma unroll
          for (int i = 0; i < kD32 / 4; ++i) {
            const float4 x = vr[i];
            acc[4 * i] = fmaf(ex, x.x, acc[4 * i]);
            acc[4 * i + 1] = fmaf(ex, x.y, acc[4 * i + 1]);
            acc[4 * i + 2] = fmaf(ex, x.z, acc[4 * i + 2]);
            acc[4 * i + 3] = fmaf(ex, x.w, acc[4 * i + 3]);
          }
        }
      }
    }
    store_row32(o + (base + r) * kD32, acc, sum);
  }
}

template <typename T, bool kBias>
cudaError_t launch_d32_one(const T* q, const T* k, const T* v, const T* bias, T* o,
                           int B, int H, int L, int P, int device, cudaStream_t stream) {
  // Above 48 KB a block's dynamic shared memory must be allowed once per
  // instantiation: the most any call takes, P * L = 128 rows at L = 64.
  static const cudaError_t allowed = cudaFuncSetAttribute(
      attention_dense_fwd_d32_kernel<T, kBias>, cudaFuncAttributeMaxDynamicSharedMemorySize,
      smem_bytes_d32(64, 2, kBias));
  if (allowed != cudaSuccess) return allowed;
  const int groups = H / P;
  long long elems = 1;
  if (kBias) {  // enough elements a block that the grid is about kBlocksPerSM an SM
    int sms = 0;
    const cudaError_t err = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, device);
    if (err != cudaSuccess) return err;
    const long long want = static_cast<long long>(kBlocksPerSM) * sms;
    elems = (static_cast<long long>(B) * groups + want - 1) / want;
    if (elems < 1) elems = 1;
    if (elems > kMaxIters) elems = kMaxIters;
  }
  const long long blocks = (B + elems - 1) / elems * groups;
  if (blocks > 0x7fffffffLL) return cudaErrorInvalidValue;
  attention_dense_fwd_d32_kernel<T, kBias><<<static_cast<int>(blocks), P * L,
                                             smem_bytes_d32(L, P, kBias), stream>>>(
      q, k, v, bias, o, B, H, L, P, static_cast<int>(elems));
  return cudaGetLastError();
}

template <typename T>
cudaError_t launch_d32(const void* q, const void* k, const void* v,
                       const void* bias, void* o, int B, int H, int L, int P,
                       int device, cudaStream_t stream) {
  const T* qt = static_cast<const T*>(q);
  const T* kt = static_cast<const T*>(k);
  const T* vt = static_cast<const T*>(v);
  const T* bt = static_cast<const T*>(bias);
  T* ot = static_cast<T*>(o);
  if (bias != nullptr) {
    return launch_d32_one<T, true>(qt, kt, vt, bt, ot, B, H, L, P, device, stream);
  }
  return launch_d32_one<T, false>(qt, kt, vt, bt, ot, B, H, L, P, device, stream);
}

}  // namespace

// Plain C interface for ctypes. D: 4 (the first kernel) or 32 (the D = 32
// kernel). dtype: 0 = float32, 1 = bfloat16. `bias` may be null. P is the
// route's pack factor (dense_pack_factor in attention_dense.py): the call
// is refused unless L < 128 is a power of two, P > 1 divides H and P*L <=
// 128. Launches on `stream` of card `device`, does not synchronise and
// allocates nothing. Returns the launch's cudaError_t (0 = success).
extern "C" int ecg_attention_dense_fwd(const void* q, const void* k,
                                       const void* v, const void* bias,
                                       void* o, int B, int H, int L, int D,
                                       int P, int dtype, int device,
                                       void* stream) {
  if (B < 1 || H < 1 || L < 1 || L >= kMaxPairs || (L & (L - 1)) != 0 ||
      (D != kD && D != kD32) || P < 2 || H % P != 0 || P * L > kMaxPairs) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return static_cast<int>(err);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  switch (dtype) {
    case 0:
      err = D == kD ? launch<float>(q, k, v, bias, o, B, H, L, P, device, s)
                    : launch_d32<float>(q, k, v, bias, o, B, H, L, P, device, s);
      break;
    case 1:
      err = D == kD ? launch<__nv_bfloat16>(q, k, v, bias, o, B, H, L, P, device, s)
                    : launch_d32<__nv_bfloat16>(q, k, v, bias, o, B, H, L, P, device, s);
      break;
    default:
      err = cudaErrorInvalidValue;
  }
  return static_cast<int>(err);
}

// The dynamic shared memory, in bytes, that one block of a call asks for:
// the first kernel's at D = 4, the D = 32 kernel's at D = 32; -1 for what
// ecg_attention_dense_fwd refuses. For logging; launches nothing.
extern "C" int ecg_attention_dense_smem_bytes(int L, int D, int P, int dtype,
                                              int with_bias) {
  if (L < 1 || L >= kMaxPairs || (L & (L - 1)) != 0 || P < 2 || P * L > kMaxPairs ||
      (dtype != 0 && dtype != 1)) {
    return -1;
  }
  if (D == kD32) return smem_bytes_d32(L, P, with_bias != 0);
  if (D != kD) return -1;
  return dtype == 0 ? smem_bytes<float>(L, P, with_bias != 0)
                    : smem_bytes<__nv_bfloat16>(L, P, with_bias != 0);
}

extern "C" const char* ecg_cuda_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}
