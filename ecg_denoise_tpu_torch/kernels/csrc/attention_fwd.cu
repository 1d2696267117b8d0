// Fused biased attention, forward — RA-LENet's attention on Hopper (sm_90a).
//
// Replaces the TPU kernel ecg_denoise_tpu/kernels/attention_pallas.py
// _fwd_kernel (:253), launched through _fwd_call (:684) from
// fused_attention (:1265) -> _fused_single -> _fwd (:618) -> _fwd_raw.
//
// Computes, for every (b, h, l):
//   out[b,h,l,:] = sum_m p[l,m] * v[b,h,m,:]
//   p[l,:]       = softmax_m(q[b,h,l,:] . k[b,h,m,:] + bias[0,h,l,m])
// q arrives pre-scaled. Operands are contiguous (B, H, L, D) with D = 4 and
// L <= 256 (D = 8, 16, 32, 64: the mma template of attention_fwd_mma.cuh,
// with the same contract but any L; D a multiple of 64 past 64: the wide
// kernel there, any L); bias is a contiguous (1, H, L, L)
// array shared by the batch, or absent. float32 and bfloat16 operands;
// logits, the row max, exp, the sums and the weighted sum are float32, and
// the output is rounded once to the operand dtype. (The TPU kernel rounds
// the unnormalised probabilities to bf16 before its pv matmul; the D = 4
// kernel stays in f32 there, the mma template rounds them as the TPU does.)
//
// Training: when the caller passes `lse`, each row also writes its
// log-sum-exp, rowmax + log(rowsum), as one float32 per (b, h, l). The
// backward kernel (attention_bwd.cu) recomputes the probabilities from it
// as exp(logit - lse). Without `lse` the kernel is the serving kernel.
//
// What bounds it. Per (b, h) the work is 2*(2*L*L*D + L*L) flops and L*L
// exps against (4*L*D + L*L) operand elements; with D = 4 there is nothing
// for the tensor cores (a head_dim of 4 is below every MMA shape) and the
// call is bound by CUDA-core f32 arithmetic at L >= 128 and by HBM below.
// The first version of this kernel was bound by neither: each thread read
// its own bias row straight from global memory, so a warp's 4-byte loads
// touched 32 rows (32 L2 sectors for 128 useful bytes), twice per row and
// again for every batch element: about 8.6 GB of L2 traffic per call at
// (L, H, B) = (256, 2, 1024), 89 % of its time.
//
// Design: the bias is staged once per block and reused across a group of
// batch elements.
// * Grid. A block owns one head h, a tile of up to 32 query rows of that
//   head, and a group of nb batch elements: nb = 16 at L >= 32, and
//   16 * (32 / L) at L < 32, where a warp holds 32 / L groups of rows side
//   by side; the last group is ragged. Global bias traffic per call is
//   (B / nb) * H * L * L * elt: 33.5 MB at (256, 2, 1024) in float32,
//   against about 8.6 GB of sectors before. Every bias byte is read from
//   global memory once per block of nb >= 16 elements.
// * Staging the bias. The block copies its (rows x L) bias tile into
//   shared memory once, converted to f32, with coalesced 16-byte loads
//   (4-byte loads where L or the pointer does not allow 16). Both softmax
//   passes of every element then read it from shared memory.
// * Bank conflicts. Lane r of a warp owns query row r and reads
//   tile[r * stride + m] at the same m as its neighbours. With stride = L
//   (256) all 32 lanes would hit one bank; a pad of 4 floats leaves
//   r * 4 mod 32 in 8 banks, a 4-way conflict. The tile's row stride is
//   L | 1, odd, so r * stride mod 32 is a permutation of the 32 banks:
//   conflict-free for any L. (An odd stride breaks the rows' 16-byte
//   alignment, so the tile is stored from registers, not by cp.async; it
//   is written once per block.)
// * Latency. Each thread carries its row for kPer = 4 elements: one shared
//   bias value feeds 4 logits, and 4 independent max, sum and FMA chains
//   interleave. The first redesign (one element a thread, every key of 4
//   elements resident, 96 KB a block) ran two blocks, eight warps an SM and
//   took 0.227 ms at (256, 2, 1024) (PERF.md); this one holds three
//   blocks of four warps (65 KB each at L = 256), each warp 4 rows deep.
// * K and V. A warp's lanes read one element's key at a time, a broadcast.
//   K and V reach shared memory as f32 in chunks of 32 keys for all nb
//   elements (16 KB), double-buffered with cp.async: the next chunk is in
//   flight while this one is used. The first pass streams K alone, the
//   second K and V. bf16 rows land raw and are converted to f32 once, in
//   shared memory, before use.
// * Arithmetic. Each thread makes the two passes of the first version over
//   its L keys, in the same order with the same operations (the row max,
//   then exp, the sum and the V-weighted sum, all f32, no online
//   rescaling), so the outputs are the first version's bit for bit. No
//   atomics, no TF32, no cross-block reduction.
// Bound at (256, 2, 1024) f32: 0.036 ms by the f32 operations (2.42 GFLOP
// at 67 TFLOP/s); its bytes, q, k, v, o and the bias once, 34.1 MB, take
// 0.010 ms at 3.35 TB/s. The exps, the bias adds and the shared-memory
// loads are not in that count: the kernel issues about 25 instructions per
// (row, key) pair, so about 0.11 ms is what this design can reach there.

#include <cuda_bf16.h>
#include <cuda_runtime.h>

#include <cstdint>

#include "attention_fwd_mma.cuh"

namespace {

constexpr int kD = 4;
constexpr int kThreads = 128;
constexpr int kWarps = kThreads / 32;
constexpr int kMaxL = 256;
constexpr int kPer = 4;     // batch elements a thread carries
constexpr int kChunk = 32;  // keys of K and V staged at a time: a lane a key
static_assert(kChunk <= 32, "the staging loops give each lane one key of a chunk");

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
  int rows;    // query rows a warp covers: min(L, 32)
  int slots;   // groups of kPer elements side by side in one warp: 32 / rows
  int elems;   // batch elements of a block: kWarps * slots * kPer
  int chunk;   // keys of one staged chunk: min(L, 32)
  int chunks;  // chunks of a pass
  int tiles;   // row tiles of a head
  int stride;  // the bias tile's row stride in floats: L | 1, odd
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

// Shared memory, in bytes: two chunk buffers of f32 K and V (f32), or two
// of raw bf16 rows and one of f32 K and V (bf16); then the bias tile.
template <typename T>
__host__ __device__ int kv_bytes(int L) {
  const Tiling t(L);
  const int rows = t.elems * t.chunk;  // K (or V) rows of one chunk
  return sizeof(T) == 4 ? 2 * 2 * rows * 16 : 2 * 2 * rows * 8 + 2 * rows * 16;
}

template <typename T>
__host__ __device__ int smem_bytes(int L, bool with_bias) {
  const Tiling t(L);
  return kv_bytes<T>(L) + (with_bias ? t.rows * t.stride * 4 : 0);
}

template <typename T, bool kBias>
__global__ void __launch_bounds__(kThreads)
attention_fwd_kernel(const T* __restrict__ q, const T* __restrict__ k,
                     const T* __restrict__ v, const T* __restrict__ bias,
                     T* __restrict__ o, float* __restrict__ lse, int B, int H,
                     int L, bool bias_vec) {
  extern __shared__ __align__(16) unsigned char smem[];
  const Tiling t(L);
  const int tile = blockIdx.x % t.tiles;
  const int h = (blockIdx.x / t.tiles) % H;
  const int b0 = (blockIdx.x / (t.tiles * H)) * t.elems;
  const int row0 = tile * 32;
  const int n_rows = min(t.rows, L - row0);  // rows of this tile
  const int n_elems = min(t.elems, B - b0);   // elements of this block
  const int buf_rows = t.elems * t.chunk;     // K (or V) rows of one chunk

  // Chunk s of the 2 * chunks stages (pass 1: K; pass 2: K and V): f32 in
  // kvf + (s & 1) * 2 * buf_rows (f32 operands), or raw in raw's buffer
  // s & 1 and converted into kvf (bf16). A buffer holds the chunk's K rows
  // [element][key], then its V rows.
  float4* kvf = reinterpret_cast<float4*>(smem);
  unsigned char* raw = smem + (sizeof(T) == 4 ? 0 : 2 * buf_rows * 16);
  float* tile_bias = reinterpret_cast<float*>(smem + kv_bytes<T>(L));
  constexpr int kRowBytes = kD * sizeof(T);
  const int n_stages = 2 * t.chunks;

  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  auto stage = [&](int s) {  // issue stage s's K (and V) rows by cp.async
    const int m0 = (s % t.chunks) * t.chunk;
    const int cn = min(t.chunk, L - m0);
    const bool with_v = s >= t.chunks;
    unsigned char* dst = sizeof(T) == 4
        ? reinterpret_cast<unsigned char*>(kvf + (s & 1) * 2 * buf_rows)
        : raw + (s & 1) * 2 * buf_rows * kRowBytes;
    if (lane < cn) {  // a warp an element, a lane a key
      for (int e = warp; e < n_elems; e += kWarps) {
        const size_t row = (static_cast<size_t>(b0 + e) * H + h) * L + m0 + lane;
        const int at = e * t.chunk + lane;
        cp_async_row(dst + at * kRowBytes, k + row * kD);
        if (with_v) cp_async_row(dst + (buf_rows + at) * kRowBytes, v + row * kD);
      }
    }
    cp_async_commit();
  };

  stage(0);
  if (kBias) {  // the (n_rows x L) tile, once per block, as f32
    const T* src = bias + (static_cast<size_t>(h) * L + row0) * L;
    // One flat loop over the tile, unrolled so that each thread's loads are
    // in flight together (a loop a row left them one after another).
    const int n = n_rows * L;
    if (bias_vec) {  // 16-byte loads: L * elt and the tile start are 16-aligned
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
  float4 qr[kPer];
  float mx[kPer], sum[kPer];
  float4 acc[kPer];
#pragma unroll
  for (int j = 0; j < kPer; ++j) {
    qr[j] = make_float4(0.f, 0.f, 0.f, 0.f);
    if (row_ok && e0 + j < n_elems) {
      qr[j] = load4(q + ((static_cast<size_t>(b0 + e0 + j) * H + h) * L + l) * kD);
    }
    mx[j] = __int_as_float(0xff800000);  // -inf
    sum[j] = 0.f;
    acc[j] = make_float4(0.f, 0.f, 0.f, 0.f);
  }

  for (int s = 0; s < n_stages; ++s) {
    cp_async_wait_all();
    // Stage s is in for every thread, and every thread is done with the
    // buffers stage s + 1 overwrites (read in stage s - 1).
    __syncthreads();
    if (s + 1 < n_stages) stage(s + 1);
    const int m0 = (s % t.chunks) * t.chunk;
    const int cn = min(t.chunk, L - m0);
    const bool pass2 = s >= t.chunks;
    const float4* kb = kvf;
    if constexpr (sizeof(T) == 4) {
      kb += (s & 1) * 2 * buf_rows;
    } else {  // bf16: convert the chunk's rows once
      const unsigned char* src = raw + (s & 1) * 2 * buf_rows * kRowBytes;
      for (int e = warp; lane < cn && e < n_elems; e += kWarps) {
        const int at = e * t.chunk + lane;
        kvf[at] = load4(reinterpret_cast<const T*>(src + at * kRowBytes));
        if (pass2) {
          kvf[buf_rows + at] =
              load4(reinterpret_cast<const T*>(src + (buf_rows + at) * kRowBytes));
        }
      }
      __syncthreads();
    }
    if (!row_ok) continue;
    const float4* vb = kb + buf_rows;
    if (!pass2) {  // the row max
#pragma unroll 2
      for (int m = 0; m < cn; ++m) {
        const float bm = kBias ? brow[m0 + m] : 0.f;
#pragma unroll
        for (int j = 0; j < kPer; ++j) {
          float x = dot4(qr[j], kb[(e0 + j) * t.chunk + m]);
          if (kBias) x += bm;
          mx[j] = fmaxf(mx[j], x);
        }
      }
    } else {  // exp, the sum and the V-weighted sum, keys in order
#pragma unroll 2
      for (int m = 0; m < cn; ++m) {
        const float bm = kBias ? brow[m0 + m] : 0.f;
#pragma unroll
        for (int j = 0; j < kPer; ++j) {
          const int at = (e0 + j) * t.chunk + m;
          float x = dot4(qr[j], kb[at]);
          if (kBias) x += bm;
          const float ex = __expf(x - mx[j]);
          const float4 vv = vb[at];
          sum[j] += ex;
          acc[j].x = fmaf(ex, vv.x, acc[j].x);
          acc[j].y = fmaf(ex, vv.y, acc[j].y);
          acc[j].z = fmaf(ex, vv.z, acc[j].z);
          acc[j].w = fmaf(ex, vv.w, acc[j].w);
        }
      }
    }
  }

  if (!row_ok) return;
#pragma unroll
  for (int j = 0; j < kPer; ++j) {
    if (e0 + j >= n_elems) break;
    const size_t row = (static_cast<size_t>(b0 + e0 + j) * H + h) * L + l;
    const float s = sum[j];
    store4(o + row * kD,
           make_float4(acc[j].x / s, acc[j].y / s, acc[j].z / s, acc[j].w / s));
    if (lse != nullptr) lse[row] = mx[j] + logf(s);
  }
}

template <typename T, bool kBias>
cudaError_t launch_one(const T* q, const T* k, const T* v, const T* bias, T* o,
                       float* lse, int B, int H, int L, cudaStream_t stream) {
  // Above 48 KB a block's dynamic shared memory must be allowed once per
  // instantiation; the most any L <= kMaxL takes.
  static const cudaError_t allowed = cudaFuncSetAttribute(
      attention_fwd_kernel<T, kBias>, cudaFuncAttributeMaxDynamicSharedMemorySize,
      smem_bytes<T>(kMaxL, kBias));
  if (allowed != cudaSuccess) return allowed;
  const Tiling t(L);
  const long long blocks = static_cast<long long>((B + t.elems - 1) / t.elems) * H * t.tiles;
  if (blocks > 0x7fffffffLL) return cudaErrorInvalidValue;
  const bool bias_vec = kBias && (L * sizeof(T)) % 16 == 0 &&
                        reinterpret_cast<uintptr_t>(bias) % 16 == 0;
  attention_fwd_kernel<T, kBias><<<static_cast<int>(blocks), kThreads,
                                   smem_bytes<T>(L, kBias), stream>>>(
      q, k, v, bias, o, lse, B, H, L, bias_vec);
  return cudaGetLastError();
}

template <typename T>
cudaError_t launch(const void* q, const void* k, const void* v,
                   const void* bias, void* o, float* lse, int B, int H,
                   int L, cudaStream_t stream) {
  const T* qt = static_cast<const T*>(q);
  const T* kt = static_cast<const T*>(k);
  const T* vt = static_cast<const T*>(v);
  const T* bt = static_cast<const T*>(bias);
  T* ot = static_cast<T*>(o);
  if (bias != nullptr) return launch_one<T, true>(qt, kt, vt, bt, ot, lse, B, H, L, stream);
  return launch_one<T, false>(qt, kt, vt, bt, ot, lse, B, H, L, stream);
}

}  // namespace

// Plain C interface for ctypes. D: 4 (the kernel above, L <= kMaxL) or 8,
// 16, 32, 64 (the mma template, any L whose grid fits an int; bf16 from
// 16), or a multiple of 64 past 64 (the wide kernel, any L).
// dtype: 0 = float32, 1 = bfloat16. `bias` may be null; `lse` is null, or
// a float32 (B, H, L) output for the backward. Launches on `stream` of card
// `device`, does not synchronise and allocates nothing. Returns the launch's
// cudaError_t (0 = success).
extern "C" int ecg_attention_fwd(const void* q, const void* k, const void* v,
                                 const void* bias, void* o, void* lse,
                                 int B, int H, int L, int D, int dtype,
                                 int device, void* stream) {
  if (B < 1 || H < 1 || L < 1 || (D == kD && L > kMaxL)) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return static_cast<int>(err);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  float* lse_f = static_cast<float*>(lse);
  switch (dtype) {
    case 0:
      err = D == kD ? launch<float>(q, k, v, bias, o, lse_f, B, H, L, s)
            : D <= mma_fwd::kWideD
                ? mma_fwd::launch_mma<float>(q, k, v, bias, o, lse_f, B, H, L, D, s)
                : mma_fwd::launch_wide<float, false>(q, k, v, bias, o, lse_f, B, H, L, D,
                                                     nullptr, 0, s);
      break;
    case 1:
      err = D == kD ? launch<__nv_bfloat16>(q, k, v, bias, o, lse_f, B, H, L, s)
            : D <= mma_fwd::kWideD
                ? mma_fwd::launch_mma<__nv_bfloat16>(q, k, v, bias, o, lse_f, B, H, L, D, s)
                : mma_fwd::launch_wide<__nv_bfloat16, false>(q, k, v, bias, o, lse_f, B, H, L,
                                                             D, nullptr, 0, s);
      break;
    default:
      err = cudaErrorInvalidValue;
  }
  return static_cast<int>(err);
}

// The wide kernel's cluster at head dim D (a multiple of 64 past 64):
// out[0] its size in blocks, out[1] the clusters card `device` holds at once
// (cudaOccupancyMaxActiveClusters). dtype as above; with_bias: the
// instantiation with a bias. Returns a cudaError_t (0 = success).
extern "C" int ecg_wide_clusters(int D, int dtype, int with_bias, int device, int* out) {
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return static_cast<int>(err);
  switch (dtype) {
    case 0: err = mma_fwd::wide_clusters<float, false>(D, with_bias != 0, out + 1, out); break;
    case 1:
      err = mma_fwd::wide_clusters<__nv_bfloat16, false>(D, with_bias != 0, out + 1, out);
      break;
    default: err = cudaErrorInvalidValue;
  }
  return static_cast<int>(err);
}

extern "C" const char* ecg_cuda_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}
