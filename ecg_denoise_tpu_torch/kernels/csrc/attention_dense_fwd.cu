// Dense-packed attention forward (B5) — RA-LENet's short-sequence attention
// stages on Hopper (sm_90a), the eval forward with ECG_ATTN_DENSE=1; and, at
// head_dim 8 to 64, Transformer1d's (the mma template below), and past 64
// with wide heads (the wide kernel at the end of this file), behind the
// same C entry point.
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
#include <type_traits>

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
// head_dim 8, 16, 32 and 64: one template on D, on Hopper's tensor cores.
// Transformer1d's lane-packable stages at its defaults on 256 samples are
// (L, H) = (64, 16), P = 2, and (32, 32), P = 4, at D = 32: 6 and 2 of the
// 12 attention calls of one forward. The wrapper (kernels/attention_dense.py)
// zero-pads any other D <= 64 to the next instantiated one. The D = 4 kernel
// above is left as it is, bit for bit.
//
// Computes the same function: softmax(q.k^T + bias).v over contiguous (B,
// H, L, D) operands, q pre-scaled, bias (1, H, L, L) or absent, f32 or
// bf16, no lse, at every power-of-two L < 128 the route packs (L = 1 ...
// 64). Every head subtracts its own row max, where the TPU kernel subtracts
// one max over the packed row of P heads (see above).
//
// What bounds it. Per (b, h) the work is 4*L*L*D flops (q.k and p.v)
// against 4*L*D operand elements. At (L, H) = (64, 16), B = 256, f32, q, k,
// v and o are 134 MB, 40.1 us at 3.35 TB/s, against 2.15 GFLOP, 13 us at
// three TF32 passes (3xTF32) and 495 TFLOP/s: the bytes bound it, and the
// design is about keeping device memory busy. wgmma is not needed: at
// 3xTF32 the products take about a third of the bytes' time, and mma.sync's
// small tiles fit a unit of 64 rows of one head or a few.
//
// Design:
// * Units. A unit is 64 consecutive rows of one batch element's head group
//   (the P heads the TPU packs into one 128-lane row; a group of 128 rows
//   is two units). Its rows of q, K and V are contiguous in the (B, H, L,
//   D) layout (24 KB at D = 32, f32), and its boundaries are head
//   boundaries (L divides 64). A block is 4 warps, a warp one 16-row
//   m-tile.
// * A persistent grid: one wave of blocks (the occupancy calculator times
//   the SM count), each walking units blockIdx.x, + gridDim.x, ... With a
//   bias the grid is a multiple of the (group, chunk) pairs, so that a
//   block keeps one group's rows while it walks the batch and stages their
//   (64 x L) bias tile into shared memory once, as f32.
// * A ring of two buffers of q, K and V, filled by cp.async (16-byte
//   copies; rows padded to D + 4 floats or D + 8 bf16 values, so that the
//   fragment loads and ldmatrix's 8 rows fall in 32 banks; rows past the
//   unit zero-filled): the next unit's rows are in flight while this one
//   computes, four blocks an SM at D = 32 (96 KB of loads in flight an SM
//   at f32).
// * A warp's keys: at L >= 16 its rows are one head's and its keys that
//   head's L; at L < 16 the m-tile holds 16 / L heads and its 16 keys are
//   theirs, a query's keys of another head masked to -inf (the TPU's
//   block-diagonal idea): a query never sees another head's keys. The
//   kernel is templated on that span, max(L, 16), so that every loop over
//   its n-tiles unrolls whole.
// * One pass, no online softmax: a row has at most 64 keys, so S = q.k^T
//   is held whole in C fragments (at most 8 n-tiles of 4 floats). Bias;
//   the row max across the quad by two shuffles; one exp of values <= 0;
//   the row sum of the f32 exps (as B1 and attention_reference: not of the
//   bf16-rounded values, which JAX's ones row sums); p.v; the output times
//   the sum's reciprocal, rounded once to the operand dtype.
// * Products on mma.sync, with B1's fragment code (attention_fwd.cu). f32:
//   m16n8k8 TF32 at 3xTF32, the tensor core's f32 sums not rounding to
//   nearest, so each k-step's three products of q.k^T are summed in a
//   fresh fragment and added on the CUDA cores, and p.v's products over
//   the row's keys (B1's key tile of 64) in one fresh fragment; P goes from
//   the C fragment to the A fragment by B1's key permutation. bf16:
//   m16n8k16 with P rounded to bf16 before p.v, as JAX's kernel rounds en
//   (attention_pallas.py:466), B1's template and attention_reference; the
//   C pairs of two n-tiles are the A pairs of one 16-key k-step, and V's
//   B fragments come by ldmatrix.trans.
// * No atomics: a call gives bit-identical results every time.
//
// Measured (chip_smoke.py phase 25, NVIDIA H100 80GB HBM3, 700.00 W power
// limit; CUDA graph replays at B = 256, no bias, in turns with B1 without
// lse and this kernel's previous design, a thread a (head, query row)):
// f32 58.3 us at (L, H) = (64, 16) (B1 87.6, previous 167.2) and 51.5 at
// (32, 32) (66.6, 123.4), against a byte bound of 40.1; bf16 30.7 and
// 28.7 (33.2, 30.3; 144.8, 102.5) against 20.0; at (64, 16) f32, D = 8
// 21.9 us, D = 16 33.6, D = 64 120.5 (B1 32.2, 50.8, 206.4).
// probes/dense_bound.py times it with its loads removed and with its
// products removed: at (64, 16) f32 52.2 and 47.7 us, a copy's rate 47.4;
// the instructions and the bytes hold it together there, the bytes alone
// at (32, 32) and at bf16. Its f32 instructions were cut to get there:
// loops unrolled on the key span, the split into TF32 halves in two
// integer instructions and a subtraction, one reciprocal a row, 32-bit
// unit arithmetic. Tried and dropped, each level or slower: three or four
// ring stages, 128-row units of 8 warps, p.v in two interleaved fragments,
// q.k^T's k-steps in one fragment (over the bar with unscaled q at D =
// 64), the f32 output staged through shared memory, one unit a block
// (faster at bf16, slower at f32 D = 16-64).

constexpr int kDenseRows = 64;                        // a unit's rows
constexpr int kDenseThreads = 32 * kDenseRows / 16;   // a warp an m-tile
constexpr int kDenseStages = 2;                       // the ring of q, K and V buffers

// A staged row's stride in elements: D + 4 floats, D + 8 bf16 values.
template <typename T, int D>
__host__ __device__ constexpr int dense_stride() { return sizeof(T) == 4 ? D + 4 : D + 8; }

// One buffer of the ring: q, K and V of one unit.
template <typename T, int D>
__host__ __device__ constexpr int dense_stage_elems() {
  return 3 * kDenseRows * dense_stride<T, D>();
}

// The bias tile's row stride in floats: even, and at L >= 16 the float2
// reads of a half warp fall in distinct banks.
__host__ __device__ inline int dense_bias_stride(int L) { return L + 8; }

// Dynamic shared memory, in bytes: the ring, then the bias tile.
template <typename T, int D>
__host__ __device__ int dense_smem_bytes(int L, bool with_bias) {
  return kDenseStages * dense_stage_elems<T, D>() * static_cast<int>(sizeof(T)) +
         (with_bias ? kDenseRows * dense_bias_stride(L) * 4 : 0);
}

// mma_tf32, mma_bf16, mma_3xtf32, bf16x2, ldmatrix_x4_trans, cp_async16 and
// store2 are copies of the helpers of the same names in attention_fwd.cu
// (each library is built from one source); split_tf32 is cheaper than B1's.

// x = hi + lo: hi is x rounded to TF32 (half away from zero, by adding half
// a TF32 ulp to the bits and clearing the 13 dropped ones), lo = x - hi
// exactly, |lo| <= 2^-11 |x|, passed whole: the tensor core reads its TF32
// bits and drops the rest, an error of at most 2^-21 |x|. Two instructions
// and a subtraction, where rounding lo too (B1's split_tf32, cvt.rna twice)
// takes twice as many and changed no reading of the 1e-5 bar (PERF.md).
__device__ __forceinline__ void split_tf32(float x, uint32_t& hi, uint32_t& lo) {
  hi = (__float_as_uint(x) + 0x1000u) & 0xffffe000u;
  lo = __float_as_uint(x - __uint_as_float(hi));
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

// c += a.b over one 8-deep k-step at 3xTF32, the small terms first.
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

// The units of one call, the same on host and device. A head group has
// P * L <= 128 rows: one unit, or two (shift 1). Unit u is chunk
// u & ((1 << shift) - 1) of head group u >> shift (batch element, then
// group). `total` fits an int: the wrapper refuses operands of 2**31
// elements or more.
struct DenseUnits {
  int rows;   // a head group's rows: P * L
  int shift;  // log2 of a head group's units
  int pairs;  // (group, chunk) pairs: groups << shift
  long long total;
  __host__ __device__ DenseUnits(int B, int H, int L, int P) {
    rows = P * L;
    shift = rows > kDenseRows ? 1 : 0;
    pairs = H / P << shift;
    total = static_cast<long long>(B) * pairs;
  }
};

// Start the cp.async copies of a unit's q, K and V rows [0, n16) into
// buffer `buf` (q, then K, then V, each kRows rows of stride kS); rows at
// and past `n` are zero-filled.
template <typename T, int D>
__device__ __forceinline__ void stage_unit(T* buf, const T* __restrict__ q,
                                           const T* __restrict__ k, const T* __restrict__ v,
                                           size_t row0, int n, int n16) {
  constexpr int kPer = 16 / sizeof(T);  // values a copy
  constexpr int kChunks = D / kPer;     // copies a row
  constexpr int kS = dense_stride<T, D>();
  constexpr int kPlane = kDenseRows * kS;
  for (int i = threadIdx.x; i < n16 * kChunks; i += kDenseThreads) {
    const int row = i / kChunks, c = i - row * kChunks;
    const bool in = row < n;
    const size_t at = in ? (row0 + row) * D + c * kPer : 0;
    T* dst = buf + row * kS + c * kPer;
    cp_async16(dst, q + at, in);
    cp_async16(dst + kPlane, k + at, in);
    cp_async16(dst + 2 * kPlane, v + at, in);
  }
}

template <typename T, int D, bool kBias, int kSpan>
__global__ void __launch_bounds__(kDenseThreads, 4)
attention_dense_fwd_mma_kernel(const T* __restrict__ q, const T* __restrict__ k,
                               const T* __restrict__ v, const T* __restrict__ bias,
                               T* __restrict__ o, int B, int H, int L, int P) {
  constexpr bool kF32 = sizeof(T) == 4;
  constexpr int kRows = kDenseRows;
  constexpr int kStages = kDenseStages;
  constexpr int kS = dense_stride<T, D>();
  constexpr int kPlane = kRows * kS;
  constexpr int kStage = dense_stage_elems<T, D>();
  constexpr int kNT = kSpan / 8;  // n-tiles of S
  extern __shared__ __align__(16) unsigned char smem[];
  T* ring = reinterpret_cast<T*>(smem);  // [stage][q, K, V][kRows][kS]
  float* btile = reinterpret_cast<float*>(ring + kStages * kStage);
  const DenseUnits units(B, H, L, P);
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int g = lane >> 2, tq = lane & 3;
  const int first = blockIdx.x, step = gridDim.x;
  const int total = static_cast<int>(units.total);
  const int n_mine = first < total ? (total - 1 - first) / step + 1 : 0;
  const int bs = dense_bias_stride(L);

  // This warp's m-tile is the unit's rows 16 * warp ..; its key span is its
  // head's L keys at L >= 16, else the tile's own 16 rows' keys: kSpan =
  // max(L, 16), a template parameter, so that every loop over the span's
  // n-tiles unrolls whole and its products interleave.
  const int key0 = (16 * warp / kSpan) * kSpan;
  const bool one_head = kSpan > 16 || L == 16;  // the tile's rows are one head's
  const int r0 = 16 * warp + g, r1 = r0 + 8;  // this lane's two rows of the unit

  // Unit `it` of this block: its first row in the (B*H*L) rows, and its
  // row count.
  auto unit_at = [&](int it, size_t& row0, int& n) {
    const int u = first + it * step;
    const int c = u & ((1 << units.shift) - 1);
    row0 = static_cast<size_t>(u >> units.shift) * units.rows + c * kRows;
    n = min(kRows, units.rows - c * kRows);
  };
  auto stage = [&](int it) {
    if (it < n_mine) {
      size_t row0;
      int n;
      unit_at(it, row0, n);
      stage_unit<T, D>(ring + (it % kStages) * kStage, q, k, v, row0, n, (n + 15) & ~15);
    }
    asm volatile("cp.async.commit_group;\n" ::);
  };

#pragma unroll
  for (int s = 0; s < kStages - 1; ++s) stage(s);
  if constexpr (kBias) {
    // The block's (group, chunk), the same for every unit it walks (the
    // grid is a multiple of units.pairs): its rows of the bias, as f32.
    if (n_mine > 0) {
      const int pair = first % units.pairs;
      const int grp = pair >> units.shift, c = pair & ((1 << units.shift) - 1);
      const int n = min(kRows, units.rows - c * kRows);
      const T* src = bias + (static_cast<size_t>(grp) * units.rows + c * kRows) * L;
      for (int i = threadIdx.x; i < n * L; i += kDenseThreads) {
        const int row = i / L, m = i - row * L;
        btile[row * bs + m] = to_float(src[i]);
      }
    }
  }

  for (int it = 0; it < n_mine; ++it) {
    asm volatile("cp.async.wait_group %0;\n" ::"n"(kStages - 2));
    // Unit it is in for every thread, and every thread is done with the
    // buffer the next copies overwrite (unit it - 1's).
    __syncthreads();
    stage(it + kStages - 1);
    size_t row0;
    int n;
    unit_at(it, row0, n);
    if (16 * warp >= n) continue;
    const T* qs = ring + (it % kStages) * kStage;
    const T* ks = qs + kPlane + key0 * kS;
    const T* vs = ks + kPlane;

    // S = q.k^T over the span, a 16 x span strip in C fragments.
    float s[kNT][4];
#pragma unroll
    for (int j = 0; j < kNT; ++j) s[j][0] = s[j][1] = s[j][2] = s[j][3] = 0.f;
    if constexpr (kF32) {
#pragma unroll
      for (int kk = 0; kk < D / 8; ++kk) {
        const float* qp = reinterpret_cast<const float*>(qs) + r0 * kS + 8 * kk + tq;
        uint32_t ah[4], al[4];
        split_tf32(qp[0], ah[0], al[0]);
        split_tf32(qp[8 * kS], ah[1], al[1]);
        split_tf32(qp[4], ah[2], al[2]);
        split_tf32(qp[8 * kS + 4], ah[3], al[3]);
#pragma unroll
        for (int j = 0; j < kNT; ++j) {
          const float* kr = reinterpret_cast<const float*>(ks) + (8 * j + g) * kS + 8 * kk + tq;
          float t[4] = {0.f, 0.f, 0.f, 0.f};  // this k-step's products, summed apart
          mma_3xtf32(t, ah, al, kr[0], kr[4]);
#pragma unroll
          for (int i = 0; i < 4; ++i) s[j][i] += t[i];
        }
      }
    } else {
#pragma unroll
      for (int kk = 0; kk < D / 16; ++kk) {
        const uint32_t* qp = reinterpret_cast<const uint32_t*>(qs + r0 * kS + 16 * kk) + tq;
        const uint32_t a[4] = {qp[0], qp[4 * kS], qp[4], qp[4 * kS + 4]};  // 8 rows: 4 kS words
#pragma unroll
        for (int j = 0; j < kNT; ++j) {
          const uint32_t* kr =
              reinterpret_cast<const uint32_t*>(ks + (8 * j + g) * kS + 16 * kk) + tq;
          mma_bf16(s[j], a, kr[0], kr[4]);
        }
      }
    }

    // The bias; at L < 16 another head's keys to -inf. Span key m = 8j +
    // 2tq is c0's and c2's, m + 1 c1's and c3's.
#pragma unroll
    for (int j = 0; j < kNT; ++j) {
      const int m = 8 * j + 2 * tq;
      if (one_head) {  // the span is the rows' head: m is the bias column
        if constexpr (kBias) {
          const float2 b0 = *reinterpret_cast<const float2*>(btile + r0 * bs + m);
          const float2 b1 = *reinterpret_cast<const float2*>(btile + r1 * bs + m);
          s[j][0] += b0.x;
          s[j][1] += b0.y;
          s[j][2] += b1.x;
          s[j][3] += b1.y;
        }
      } else {  // the tile's heads: row g's is g / L, key m's m / L
#pragma unroll
        for (int e = 0; e < 2; ++e) {
          const int mk = m + e;
          const bool own0 = mk / L == g / L, own1 = mk / L == (g + 8) / L;
          if constexpr (kBias) {
            if (own0 && r0 < n) s[j][e] += btile[r0 * bs + mk % L];
            if (own1 && r1 < n) s[j][2 + e] += btile[r1 * bs + mk % L];
          }
          if (!own0) s[j][e] = __int_as_float(0xff800000);
          if (!own1) s[j][2 + e] = __int_as_float(0xff800000);
        }
      }
    }

    // One softmax pass over the whole row: the max across the quad, one exp
    // of values <= 0, the sums of the f32 exps.
    float mx0 = __int_as_float(0xff800000), mx1 = mx0;
#pragma unroll
    for (int j = 0; j < kNT; ++j) {
      mx0 = fmaxf(mx0, fmaxf(s[j][0], s[j][1]));
      mx1 = fmaxf(mx1, fmaxf(s[j][2], s[j][3]));
    }
#pragma unroll
    for (int x = 1; x <= 2; x <<= 1) {
      mx0 = fmaxf(mx0, __shfl_xor_sync(0xffffffffu, mx0, x));
      mx1 = fmaxf(mx1, __shfl_xor_sync(0xffffffffu, mx1, x));
    }
    float sum0 = 0.f, sum1 = 0.f;
#pragma unroll
    for (int j = 0; j < kNT; ++j) {
      s[j][0] = __expf(s[j][0] - mx0);
      s[j][1] = __expf(s[j][1] - mx0);
      s[j][2] = __expf(s[j][2] - mx1);
      s[j][3] = __expf(s[j][3] - mx1);
      sum0 += s[j][0] + s[j][1];
      sum1 += s[j][2] + s[j][3];
    }
#pragma unroll
    for (int x = 1; x <= 2; x <<= 1) {
      sum0 += __shfl_xor_sync(0xffffffffu, sum0, x);
      sum1 += __shfl_xor_sync(0xffffffffu, sum1, x);
    }

    // O = P.V in one fresh fragment over the span's keys.
    float acc[D / 8][4];
#pragma unroll
    for (int d = 0; d < D / 8; ++d) acc[d][0] = acc[d][1] = acc[d][2] = acc[d][3] = 0.f;
    if constexpr (kF32) {
      // k-step j: A column tq is key 8j + 2tq (c0, c2), column tq + 4 key
      // 8j + 2tq + 1 (c1, c3); V's rows in the same order.
#pragma unroll
      for (int j = 0; j < kNT; ++j) {
        uint32_t ph[4], pl[4];
        split_tf32(s[j][0], ph[0], pl[0]);
        split_tf32(s[j][2], ph[1], pl[1]);
        split_tf32(s[j][1], ph[2], pl[2]);
        split_tf32(s[j][3], ph[3], pl[3]);
        const float* vr = reinterpret_cast<const float*>(vs) + (8 * j + 2 * tq) * kS + g;
#pragma unroll
        for (int d = 0; d < D / 8; ++d) mma_3xtf32(acc[d], ph, pl, vr[8 * d], vr[kS + 8 * d]);
      }
    } else {
      // k-step jj: keys 16jj .. 16jj + 15, the C pairs of n-tiles 2jj and
      // 2jj + 1 rounded to bf16; V's B fragments by ldmatrix.trans, two
      // 8-dim n-tiles a call.
#pragma unroll
      for (int jj = 0; jj < kNT / 2; ++jj) {
        const uint32_t pa[4] = {bf16x2(s[2 * jj][0], s[2 * jj][1]),
                                bf16x2(s[2 * jj][2], s[2 * jj][3]),
                                bf16x2(s[2 * jj + 1][0], s[2 * jj + 1][1]),
                                bf16x2(s[2 * jj + 1][2], s[2 * jj + 1][3])};
        const T* vrow = vs + (16 * jj + (lane & 15)) * kS + (lane >> 4) * 8;
#pragma unroll
        for (int d = 0; d < D / 16; ++d) {
          uint32_t b[4];
          ldmatrix_x4_trans(b, vrow + 16 * d);
          mma_bf16(acc[2 * d], pa, b[0], b[1]);
          mma_bf16(acc[2 * d + 1], pa, b[2], b[3]);
        }
      }
    }

    // Times the row sum's reciprocal, rounded once; rows past the unit
    // dropped. f32 from the fragments: a lane's float2 and its quad's fill
    // 32-byte sectors. bf16 through this warp's own q rows of the buffer
    // (read whole above; no other warp reads them, and the buffer is
    // refilled only after the next barrier) to 16-byte stores of whole
    // rows, where the fragments' 4-byte stores fill half sectors.
    const float inv0 = 1.f / sum0, inv1 = 1.f / sum1;
    if constexpr (kF32) {
      T* o0 = o + (row0 + r0) * D + 2 * tq;
      T* o1 = o0 + 8 * D;
#pragma unroll
      for (int d = 0; d < D / 8; ++d) {
        if (r0 < n) store2(o0 + 8 * d, acc[d][0] * inv0, acc[d][1] * inv0);
        if (r1 < n) store2(o1 + 8 * d, acc[d][2] * inv1, acc[d][3] * inv1);
      }
    } else {
      T* ot = ring + (it % kStages) * kStage + 16 * warp * kS;
      __syncwarp();  // every lane is done reading the warp's q rows
#pragma unroll
      for (int d = 0; d < D / 8; ++d) {
        store2(ot + g * kS + 8 * d + 2 * tq, acc[d][0] * inv0, acc[d][1] * inv0);
        store2(ot + (g + 8) * kS + 8 * d + 2 * tq, acc[d][2] * inv1, acc[d][3] * inv1);
      }
      __syncwarp();
      constexpr int kPer = 8, kChunks = D / kPer;  // a row's 16-byte chunks
#pragma unroll
      for (int i = lane; i < 16 * kChunks; i += 32) {
        const int r = i / kChunks, c = i - r * kChunks;
        if (16 * warp + r < n) {
          *reinterpret_cast<uint4*>(o + (row0 + 16 * warp + r) * D + c * kPer) =
              *reinterpret_cast<const uint4*>(ot + r * kS + c * kPer);
        }
      }
    }
  }
}

// Calls f(kBias, kSpan), each a std::integral_constant, for a call at (L,
// with_bias): kSpan = max(L, 16), the template's and the wide kernel's.
template <typename F>
cudaError_t span_dispatch(int L, bool with_bias, F&& f) {
  auto at_bias = [&](auto b) -> cudaError_t {
    if (L <= 16) return f(b, std::integral_constant<int, 16>{});
    if (L == 32) return f(b, std::integral_constant<int, 32>{});
    return f(b, std::integral_constant<int, 64>{});
  };
  return with_bias ? at_bias(std::true_type{}) : at_bias(std::false_type{});
}

// Calls f(D, kBias, kSpan), each a std::integral_constant, at the template's
// instantiation for a call at (D, L, with_bias): D = 8 at f32 only (bf16's
// mma is 16 deep), 16, 32 or 64.
template <typename T, typename F>
cudaError_t dense_dispatch(int D, int L, bool with_bias, F&& f) {
  auto at_d = [&](auto d) -> cudaError_t {
    return span_dispatch(L, with_bias, [&](auto b, auto span) { return f(d, b, span); });
  };
  switch (D) {
    case 8:
      if constexpr (sizeof(T) == 4) return at_d(std::integral_constant<int, 8>{});
      return cudaErrorInvalidValue;
    case 16: return at_d(std::integral_constant<int, 16>{});
    case 32: return at_d(std::integral_constant<int, 32>{});
    case 64: return at_d(std::integral_constant<int, 64>{});
    default: return cudaErrorInvalidValue;
  }
}

// The grid of one call of `kernel` (the template or the wide kernel, `smem`
// bytes of dynamic shared memory a block): about one wave (the blocks an SM
// holds at that, times the SMs), at most one block a unit; with a bias a
// multiple of the (group, chunk) pairs, so that a block keeps one.
template <typename K>
cudaError_t wave_grid(K kernel, int smem, bool with_bias, int B, int H, int L, int P,
                      int device, int& grid) {
  int sms = 0, per_sm = 0;
  cudaError_t err = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, device);
  if (err != cudaSuccess) return err;
  err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(&per_sm, kernel, kDenseThreads, smem);
  if (err != cudaSuccess) return err;
  const DenseUnits units(B, H, L, P);
  if (units.total > 0x7fffffffLL) return cudaErrorInvalidValue;
  long long blocks = static_cast<long long>(per_sm > 0 ? per_sm : 1) * sms;
  if (blocks > units.total) blocks = units.total;
  if (with_bias) blocks = blocks < units.pairs ? units.pairs : blocks / units.pairs * units.pairs;
  if (blocks > 0x7fffffffLL) return cudaErrorInvalidValue;
  grid = static_cast<int>(blocks);
  return cudaSuccess;
}

template <typename T, int D, bool kBias, int kSpan>
cudaError_t dense_grid(int B, int H, int L, int P, int device, int& grid) {
  // Above 48 KB a block's dynamic shared memory must be allowed once per
  // instantiation, before the occupancy calculator reads it: the most any
  // call takes, the bias tile at L = 64.
  static const cudaError_t allowed = cudaFuncSetAttribute(
      attention_dense_fwd_mma_kernel<T, D, kBias, kSpan>,
      cudaFuncAttributeMaxDynamicSharedMemorySize, dense_smem_bytes<T, D>(64, kBias));
  if (allowed != cudaSuccess) return allowed;
  return wave_grid(attention_dense_fwd_mma_kernel<T, D, kBias, kSpan>,
                   dense_smem_bytes<T, D>(L, kBias), kBias, B, H, L, P, device, grid);
}

template <typename T>
cudaError_t launch_dense_mma(const void* q, const void* k, const void* v, const void* bias,
                             void* o, int B, int H, int L, int D, int P, int device,
                             cudaStream_t stream) {
  return dense_dispatch<T>(D, L, bias != nullptr, [&](auto d, auto b, auto span) {
    constexpr int kDd = decltype(d)::value;
    constexpr bool kBias = decltype(b)::value;
    constexpr int kSpan = decltype(span)::value;
    int grid = 0;
    const cudaError_t err = dense_grid<T, kDd, kBias, kSpan>(B, H, L, P, device, grid);
    if (err != cudaSuccess) return err;
    attention_dense_fwd_mma_kernel<T, kDd, kBias, kSpan>
        <<<grid, kDenseThreads, dense_smem_bytes<T, kDd>(L, kBias), stream>>>(
            static_cast<const T*>(q), static_cast<const T*>(k), static_cast<const T*>(v),
            static_cast<const T*>(bias), static_cast<T*>(o), B, H, L, P);
    return cudaGetLastError();
  });
}

// The template's launch at this call shape (launches nothing): its blocks,
// threads a block and ring stages into out[0..2].
template <typename T>
cudaError_t dense_mma_shape(int B, int H, int L, int D, int P, bool with_bias, int device,
                            int* out) {
  return dense_dispatch<T>(D, L, with_bias, [&](auto d, auto b, auto span) {
    constexpr int kDd = decltype(d)::value;
    out[1] = kDenseThreads;
    out[2] = kDenseStages;
    return dense_grid<T, kDd, decltype(b)::value, decltype(span)::value>(B, H, L, P, device,
                                                                         out[0]);
  });
}

// ---------------------------------------------------------------------------
// head_dim past 64: one kernel for every D that is a multiple of 64 (the
// wrapper zero-pads any other D > 64 up to the next one). Transformer1d at
// its published widths with num_heads (1, 1, 2, 4) packs its last two
// stages at D = 256: (L, H) = (64, 2), P = 2, and (32, 4), P = 4, 8 of the
// 12 calls of a dense forward. The template above is left as it is.
//
// What bounds it: the template's work and bytes, 4*L*L*D flops a (b, h)
// against 4*L*D operand elements; at (64, 2), B = 256, D = 256, f32, q, k,
// v and o are 134 MB, 40 us at 3.35 TB/s, against 8.6 GFLOP of 3xTF32
// products, 17 us at 495 TFLOP/s. But the template's ring of q, K and V at
// D + 4 floats a row is 2*3*64*(D + 4)*4 bytes, 399,360 at D = 256, past the
// 232,448 a block may have, and its output accumulators take D / 2
// registers a thread. So nothing here grows with D:
// * The template's units (64 rows of one batch element's head group), its
//   persistent grid of one wave, its bias tile staged once a block, and its
//   warps (a 16-row m-tile each, its key span max(L, 16)).
// * D is cut into 64-wide chunks, and a unit walks 2 * chunks stages of a
//   ring of two buffers of two 64 x 68 f32 (64 x 72 bf16) tiles: chunk c
//   of q and K (c < chunks), then chunk c - chunks of V. The next stage's
//   copies (cp.async; the next unit's first chunk after a unit's last) are
//   in flight while one computes.
// * S = q.k^T over the span is summed over the chunks in C fragments
//   (at most 8 n-tiles), each f32 k-step's three products in a fresh
//   fragment; after the last chunk, the template's one softmax pass (the
//   bias, other heads' keys at -inf at L < 16, each head its own max).
//   The exps stay in registers, and each V chunk gives its 64 dims of the
//   output: P.V in one fresh fragment, times the row sum's reciprocal,
//   rounded once and stored. q.k^T runs once; nothing is recomputed.
// No atomics: a call gives bit-identical results every time.

constexpr int kWideD = 64;  // dims of a chunk of D

// One buffer of the ring: two 64-row tiles (q and K, or V in the first).
template <typename T>
__host__ __device__ constexpr int wide_stage_elems() {
  return 2 * kDenseRows * dense_stride<T, kWideD>();
}

template <typename T>
__host__ __device__ int wide_smem_bytes(int L, bool with_bias) {
  return kDenseStages * wide_stage_elems<T>() * static_cast<int>(sizeof(T)) +
         (with_bias ? kDenseRows * dense_bias_stride(L) * 4 : 0);
}

// Start the copies of a unit's rows [0, n16), dims col0 .. col0 + 63, of x
// into the tile `dst`; rows at and past `n` are zero-filled.
template <typename T>
__device__ __forceinline__ void stage_wide(T* dst, const T* __restrict__ x, size_t row0, int n,
                                           int n16, int D, int col0) {
  constexpr int kPer = 16 / sizeof(T);    // values a copy
  constexpr int kChunks = kWideD / kPer;  // copies a row
  constexpr int kS = dense_stride<T, kWideD>();
  for (int i = threadIdx.x; i < n16 * kChunks; i += kDenseThreads) {
    const int row = i / kChunks, c = i - row * kChunks;
    const bool in = row < n;
    const size_t at = in ? (row0 + row) * D + col0 + c * kPer : 0;
    cp_async16(dst + row * kS + c * kPer, x + at, in);
  }
}

template <typename T, bool kBias, int kSpan>
__global__ void __launch_bounds__(kDenseThreads)
attention_dense_fwd_wide_kernel(const T* __restrict__ q, const T* __restrict__ k,
                                const T* __restrict__ v, const T* __restrict__ bias,
                                T* __restrict__ o, int B, int H, int L, int D, int P) {
  constexpr bool kF32 = sizeof(T) == 4;
  constexpr int kRows = kDenseRows;
  constexpr int kS = dense_stride<T, kWideD>();
  constexpr int kPlane = kRows * kS;
  constexpr int kStage = wide_stage_elems<T>();
  constexpr int kNT = kSpan / 8;  // n-tiles of S
  extern __shared__ __align__(16) unsigned char smem[];
  T* ring = reinterpret_cast<T*>(smem);  // [stage][2 tiles][kRows][kS]
  float* btile = reinterpret_cast<float*>(ring + kDenseStages * kStage);
  const DenseUnits units(B, H, L, P);
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int g = lane >> 2, tq = lane & 3;
  const int first = blockIdx.x, step = gridDim.x;
  const int total = static_cast<int>(units.total);
  const int n_mine = first < total ? (total - 1 - first) / step + 1 : 0;
  const int bs = dense_bias_stride(L);
  const int chunks = D / kWideD;
  const int per = 2 * chunks;  // stages a unit
  const int n_stages = n_mine * per;

  // As the template: this warp's m-tile, its key span, its two rows.
  const int key0 = (16 * warp / kSpan) * kSpan;
  const bool one_head = kSpan > 16 || L == 16;
  const int r0 = 16 * warp + g, r1 = r0 + 8;

  auto unit_at = [&](int it, size_t& row0, int& n) {
    const int u = first + it * step;
    const int c = u & ((1 << units.shift) - 1);
    row0 = static_cast<size_t>(u >> units.shift) * units.rows + c * kRows;
    n = min(kRows, units.rows - c * kRows);
  };
  // Stage st: unit st / per, step c = st % per: chunk c of q and K, or
  // chunk c - chunks of V.
  auto stage = [&](int st) {
    const int it = st / per, c = st - it * per;
    size_t row0;
    int n;
    unit_at(it, row0, n);
    T* buf = ring + (st % kDenseStages) * kStage;
    const int n16 = (n + 15) & ~15;
    if (c < chunks) {
      stage_wide<T>(buf, q, row0, n, n16, D, c * kWideD);
      stage_wide<T>(buf + kPlane, k, row0, n, n16, D, c * kWideD);
    } else {
      stage_wide<T>(buf, v, row0, n, n16, D, (c - chunks) * kWideD);
    }
    asm volatile("cp.async.commit_group;\n" ::);
  };

  if (n_stages > 0) stage(0);
  if constexpr (kBias) {
    // The block's (group, chunk), the same for every unit it walks.
    if (n_mine > 0) {
      const int pair = first % units.pairs;
      const int grp = pair >> units.shift, c = pair & ((1 << units.shift) - 1);
      const int n = min(kRows, units.rows - c * kRows);
      const T* src = bias + (static_cast<size_t>(grp) * units.rows + c * kRows) * L;
      for (int i = threadIdx.x; i < n * L; i += kDenseThreads) {
        const int row = i / L, m = i - row * L;
        btile[row * bs + m] = to_float(src[i]);
      }
    }
  }

  float s[kNT][4];
  float inv0 = 0.f, inv1 = 0.f;
  for (int st = 0; st < n_stages; ++st) {
    asm volatile("cp.async.wait_group 0;\n" ::);
    // Stage st is in for every thread, and every thread is done with the
    // buffer the next copies overwrite (stage st - 1's); the bias tile too.
    __syncthreads();
    if (st + 1 < n_stages) stage(st + 1);
    const int it = st / per, c = st - it * per;
    size_t row0;
    int n;
    unit_at(it, row0, n);
    if (16 * warp >= n) continue;
    const T* buf = ring + (st % kDenseStages) * kStage;

    if (c < chunks) {
      if (c == 0) {
#pragma unroll
        for (int j = 0; j < kNT; ++j) s[j][0] = s[j][1] = s[j][2] = s[j][3] = 0.f;
      }
      const T* qs = buf;
      const T* ks = buf + kPlane + key0 * kS;
      // S += q.k^T over this chunk's 64 dims.
      if constexpr (kF32) {
#pragma unroll
        for (int kk = 0; kk < kWideD / 8; ++kk) {
          const float* qp = reinterpret_cast<const float*>(qs) + r0 * kS + 8 * kk + tq;
          uint32_t ah[4], al[4];
          split_tf32(qp[0], ah[0], al[0]);
          split_tf32(qp[8 * kS], ah[1], al[1]);
          split_tf32(qp[4], ah[2], al[2]);
          split_tf32(qp[8 * kS + 4], ah[3], al[3]);
#pragma unroll
          for (int j = 0; j < kNT; ++j) {
            const float* kr = reinterpret_cast<const float*>(ks) + (8 * j + g) * kS + 8 * kk + tq;
            float t[4] = {0.f, 0.f, 0.f, 0.f};  // this k-step's products, summed apart
            mma_3xtf32(t, ah, al, kr[0], kr[4]);
#pragma unroll
            for (int i = 0; i < 4; ++i) s[j][i] += t[i];
          }
        }
      } else {
#pragma unroll
        for (int kk = 0; kk < kWideD / 16; ++kk) {
          const uint32_t* qp = reinterpret_cast<const uint32_t*>(qs + r0 * kS + 16 * kk) + tq;
          const uint32_t a[4] = {qp[0], qp[4 * kS], qp[4], qp[4 * kS + 4]};  // 8 rows: 4 kS words
#pragma unroll
          for (int j = 0; j < kNT; ++j) {
            const uint32_t* kr =
                reinterpret_cast<const uint32_t*>(ks + (8 * j + g) * kS + 16 * kk) + tq;
            mma_bf16(s[j], a, kr[0], kr[4]);
          }
        }
      }
      if (c + 1 < chunks) continue;

      // The bias; at L < 16 another head's keys to -inf (as the template).
#pragma unroll
      for (int j = 0; j < kNT; ++j) {
        const int m = 8 * j + 2 * tq;
        if (one_head) {
          if constexpr (kBias) {
            const float2 b0 = *reinterpret_cast<const float2*>(btile + r0 * bs + m);
            const float2 b1 = *reinterpret_cast<const float2*>(btile + r1 * bs + m);
            s[j][0] += b0.x;
            s[j][1] += b0.y;
            s[j][2] += b1.x;
            s[j][3] += b1.y;
          }
        } else {
#pragma unroll
          for (int e = 0; e < 2; ++e) {
            const int mk = m + e;
            const bool own0 = mk / L == g / L, own1 = mk / L == (g + 8) / L;
            if constexpr (kBias) {
              if (own0 && r0 < n) s[j][e] += btile[r0 * bs + mk % L];
              if (own1 && r1 < n) s[j][2 + e] += btile[r1 * bs + mk % L];
            }
            if (!own0) s[j][e] = __int_as_float(0xff800000);
            if (!own1) s[j][2 + e] = __int_as_float(0xff800000);
          }
        }
      }
      // One softmax pass over the whole row; the exps stay in s.
      float mx0 = __int_as_float(0xff800000), mx1 = mx0;
#pragma unroll
      for (int j = 0; j < kNT; ++j) {
        mx0 = fmaxf(mx0, fmaxf(s[j][0], s[j][1]));
        mx1 = fmaxf(mx1, fmaxf(s[j][2], s[j][3]));
      }
#pragma unroll
      for (int x = 1; x <= 2; x <<= 1) {
        mx0 = fmaxf(mx0, __shfl_xor_sync(0xffffffffu, mx0, x));
        mx1 = fmaxf(mx1, __shfl_xor_sync(0xffffffffu, mx1, x));
      }
      float sum0 = 0.f, sum1 = 0.f;
#pragma unroll
      for (int j = 0; j < kNT; ++j) {
        s[j][0] = __expf(s[j][0] - mx0);
        s[j][1] = __expf(s[j][1] - mx0);
        s[j][2] = __expf(s[j][2] - mx1);
        s[j][3] = __expf(s[j][3] - mx1);
        sum0 += s[j][0] + s[j][1];
        sum1 += s[j][2] + s[j][3];
      }
#pragma unroll
      for (int x = 1; x <= 2; x <<= 1) {
        sum0 += __shfl_xor_sync(0xffffffffu, sum0, x);
        sum1 += __shfl_xor_sync(0xffffffffu, sum1, x);
      }
      inv0 = 1.f / sum0;
      inv1 = 1.f / sum1;
      continue;
    }

    // V chunk c - chunks: its 64 dims of the output, P.V in a fresh fragment.
    const T* vs = buf + key0 * kS;
    float acc[kWideD / 8][4];
#pragma unroll
    for (int d = 0; d < kWideD / 8; ++d) acc[d][0] = acc[d][1] = acc[d][2] = acc[d][3] = 0.f;
    if constexpr (kF32) {
#pragma unroll
      for (int j = 0; j < kNT; ++j) {
        uint32_t ph[4], pl[4];
        split_tf32(s[j][0], ph[0], pl[0]);
        split_tf32(s[j][2], ph[1], pl[1]);
        split_tf32(s[j][1], ph[2], pl[2]);
        split_tf32(s[j][3], ph[3], pl[3]);
        const float* vr = reinterpret_cast<const float*>(vs) + (8 * j + 2 * tq) * kS + g;
#pragma unroll
        for (int d = 0; d < kWideD / 8; ++d) {
          mma_3xtf32(acc[d], ph, pl, vr[8 * d], vr[kS + 8 * d]);
        }
      }
    } else {
#pragma unroll
      for (int jj = 0; jj < kNT / 2; ++jj) {
        const uint32_t pa[4] = {bf16x2(s[2 * jj][0], s[2 * jj][1]),
                                bf16x2(s[2 * jj][2], s[2 * jj][3]),
                                bf16x2(s[2 * jj + 1][0], s[2 * jj + 1][1]),
                                bf16x2(s[2 * jj + 1][2], s[2 * jj + 1][3])};
        const T* vrow = vs + (16 * jj + (lane & 15)) * kS + (lane >> 4) * 8;
#pragma unroll
        for (int d = 0; d < kWideD / 16; ++d) {
          uint32_t b[4];
          ldmatrix_x4_trans(b, vrow + 16 * d);
          mma_bf16(acc[2 * d], pa, b[0], b[1]);
          mma_bf16(acc[2 * d + 1], pa, b[2], b[3]);
        }
      }
    }
    T* o0 = o + (row0 + r0) * D + (c - chunks) * kWideD + 2 * tq;
    T* o1 = o0 + 8 * static_cast<size_t>(D);
#pragma unroll
    for (int d = 0; d < kWideD / 8; ++d) {
      if (r0 < n) store2(o0 + 8 * d, acc[d][0] * inv0, acc[d][1] * inv0);
      if (r1 < n) store2(o1 + 8 * d, acc[d][2] * inv1, acc[d][3] * inv1);
    }
  }
}

// The wide kernel's grid (`wave_grid`), its shared memory allowed once per
// instantiation as the template's (`dense_grid`).
template <typename T, bool kBias, int kSpan>
cudaError_t wide_grid(int B, int H, int L, int P, int device, int& grid) {
  static const cudaError_t allowed = cudaFuncSetAttribute(
      attention_dense_fwd_wide_kernel<T, kBias, kSpan>,
      cudaFuncAttributeMaxDynamicSharedMemorySize, wide_smem_bytes<T>(64, kBias));
  if (allowed != cudaSuccess) return allowed;
  return wave_grid(attention_dense_fwd_wide_kernel<T, kBias, kSpan>,
                   wide_smem_bytes<T>(L, kBias), kBias, B, H, L, P, device, grid);
}

template <typename T>
cudaError_t launch_dense_wide(const void* q, const void* k, const void* v, const void* bias,
                              void* o, int B, int H, int L, int D, int P, int device,
                              cudaStream_t stream) {
  return span_dispatch(L, bias != nullptr, [&](auto b, auto span) {
    constexpr bool kBias = decltype(b)::value;
    constexpr int kSpan = decltype(span)::value;
    int grid = 0;
    const cudaError_t err = wide_grid<T, kBias, kSpan>(B, H, L, P, device, grid);
    if (err != cudaSuccess) return err;
    attention_dense_fwd_wide_kernel<T, kBias, kSpan>
        <<<grid, kDenseThreads, wide_smem_bytes<T>(L, kBias), stream>>>(
            static_cast<const T*>(q), static_cast<const T*>(k), static_cast<const T*>(v),
            static_cast<const T*>(bias), static_cast<T*>(o), B, H, L, D, P);
    return cudaGetLastError();
  });
}

template <typename T>
cudaError_t dense_wide_shape(int B, int H, int L, int P, bool with_bias, int device, int* out) {
  return span_dispatch(L, with_bias, [&](auto b, auto span) {
    out[1] = kDenseThreads;
    out[2] = kDenseStages;
    return wide_grid<T, decltype(b)::value, decltype(span)::value>(B, H, L, P, device, out[0]);
  });
}

// A multiple of 64 past 64: the wide kernel's D.
inline bool dense_wide_takes(int D) { return D > kWideD && D % kWideD == 0; }

template <typename T>
int dense_mma_smem(int L, int D, bool with_bias) {
  switch (D) {
    case 8: return dense_smem_bytes<T, 8>(L, with_bias);
    case 16: return dense_smem_bytes<T, 16>(L, with_bias);
    case 32: return dense_smem_bytes<T, 32>(L, with_bias);
    case 64: return dense_smem_bytes<T, 64>(L, with_bias);
    default: return wide_smem_bytes<T>(L, with_bias);  // dense_call_ok took D
  }
}

// Whether the template or the wide kernel is built for (D, dtype).
inline bool dense_mma_takes(int D, int dtype) {
  return (D == 8 && dtype == 0) || D == 16 || D == 32 || D == 64 || dense_wide_takes(D);
}

// The shape checks of every entry point: L < 128 a power of two, P > 1
// dividing H, P*L <= 128, D = 4, a template D or a wide one, dtype 0 or 1.
inline bool dense_call_ok(int H, int L, int D, int P, int dtype) {
  return H >= 1 && L >= 1 && L < kMaxPairs && (L & (L - 1)) == 0 && P >= 2 && H % P == 0 &&
         P * L <= kMaxPairs && (dtype == 0 || dtype == 1) &&
         (D == kD || dense_mma_takes(D, dtype));
}

}  // namespace

// Plain C interface for ctypes. D: 4 (the first kernel), 8, 16, 32, 64
// (the mma template; bf16 from 16) or a multiple of 64 past 64 (the wide
// kernel). dtype: 0 = float32, 1 = bfloat16.
// `bias` may be null. P is the route's pack factor (dense_pack_factor in
// attention_dense.py): the call is refused unless L < 128 is a power of
// two, P > 1 divides H and P*L <= 128. Launches on `stream` of card
// `device`, does not synchronise and allocates nothing. Returns the launch's
// cudaError_t (0 = success).
extern "C" int ecg_attention_dense_fwd(const void* q, const void* k,
                                       const void* v, const void* bias,
                                       void* o, int B, int H, int L, int D,
                                       int P, int dtype, int device,
                                       void* stream) {
  if (B < 1 || !dense_call_ok(H, L, D, P, dtype)) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return static_cast<int>(err);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (dtype == 0) {
    err = D == kD ? launch<float>(q, k, v, bias, o, B, H, L, P, device, s)
          : dense_wide_takes(D)
              ? launch_dense_wide<float>(q, k, v, bias, o, B, H, L, D, P, device, s)
              : launch_dense_mma<float>(q, k, v, bias, o, B, H, L, D, P, device, s);
  } else {
    err = D == kD ? launch<__nv_bfloat16>(q, k, v, bias, o, B, H, L, P, device, s)
          : dense_wide_takes(D)
              ? launch_dense_wide<__nv_bfloat16>(q, k, v, bias, o, B, H, L, D, P, device, s)
              : launch_dense_mma<__nv_bfloat16>(q, k, v, bias, o, B, H, L, D, P, device, s);
  }
  return static_cast<int>(err);
}

// The dynamic shared memory, in bytes, that one block of a call asks for:
// the first kernel's at D = 4, the template's at D = 8-64, the wide
// kernel's past 64; -1 for what
// ecg_attention_dense_fwd refuses. For logging; launches nothing.
extern "C" int ecg_attention_dense_smem_bytes(int L, int D, int P, int dtype,
                                              int with_bias) {
  if (!dense_call_ok(P, L, D, P, dtype)) return -1;
  if (D == kD) {
    return dtype == 0 ? smem_bytes<float>(L, P, with_bias != 0)
                      : smem_bytes<__nv_bfloat16>(L, P, with_bias != 0);
  }
  return dtype == 0 ? dense_mma_smem<float>(L, D, with_bias != 0)
                    : dense_mma_smem<__nv_bfloat16>(L, D, with_bias != 0);
}

// The template's (or the wide kernel's) launch at this call shape, for
// logging (launches nothing): its blocks, threads a block and ring stages
// through `out` (three ints). Returns the cudaError_t; D = 4 and what
// ecg_attention_dense_fwd refuses are cudaErrorInvalidValue.
extern "C" int ecg_attention_dense_launch_shape(int B, int H, int L, int D, int P, int dtype,
                                                int with_bias, int device, int* out) {
  if (B < 1 || D == kD || !dense_call_ok(H, L, D, P, dtype)) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return static_cast<int>(err);
  if (dense_wide_takes(D)) {
    err = dtype == 0 ? dense_wide_shape<float>(B, H, L, P, with_bias != 0, device, out)
                     : dense_wide_shape<__nv_bfloat16>(B, H, L, P, with_bias != 0, device, out);
  } else {
    err = dtype == 0 ? dense_mma_shape<float>(B, H, L, D, P, with_bias != 0, device, out)
                     : dense_mma_shape<__nv_bfloat16>(B, H, L, D, P, with_bias != 0, device, out);
  }
  return static_cast<int>(err);
}

extern "C" const char* ecg_cuda_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}
