// The per-window mask of R-peak attention (B3, B4), for their D = 4
// kernels (attention_rpos_fwd.cu, attention_rpos_bwd.cu), B3's window
// kernel (attention_rpos_fwd_mma.cuh) and the window mode of the wide
// kernels and B4's passes (attention_fwd_mma.cuh, attention_bwd_mma.cuh).
//
// Batch element b's bias is toep[h, l, m] * in_b[l] * in_b[m] with
// in_b[i] = (off_b <= i < off_b + W), compared in float32 as the JAX
// package compares (ecg_denoise_tpu/kernels/attention_pallas.py
// _fwd_rpos_kernel, :827). For an integer i, i >= off iff i >= ceil(off)
// and i < x iff i < ceil(x), so the window is the integer range [lo, hi),
// cut to [0, L): two compares per (row, key), no mask array. An offset
// that is NaN or infinite gives an empty window, as JAX's compares do.

#pragma once

#include <cuda_runtime.h>

namespace {

struct Window {
  int lo, hi;  // [lo, hi) within [0, L)
  __device__ __forceinline__ bool has(int i) const { return i >= lo && i < hi; }
  // Whether the window holds a row of [r0, r0 + nr) and a key of [m0, m0 + nm).
  __device__ __forceinline__ bool meets(int r0, int nr, int m0, int nm) const {
    return lo < hi && lo < r0 + nr && hi > r0 && lo < m0 + nm && hi > m0;
  }
};

// Whether position i takes a bias: inside the window w in the window mode
// (kWin), else inside [0, L).
template <bool kWin>
__device__ __forceinline__ bool in_bias(Window w, int i, int L) {
  return kWin ? w.has(i) : i < L;
}

// Each warp's window in the templates' window mode, in shared memory (a
// block has kWarps warps): lane 0 sets its warp's entry once, before the
// kernel's first barrier, and the warp reads it where a bias is added,
// after one. So no register holds the window across a tile loop: the
// backward passes run at the register limit, where a window held in
// registers spilled.
template <int kWarps>
__device__ __forceinline__ Window* warp_windows() {
  __shared__ Window windows[kWarps];
  return windows;
}

// The window a warp's bias is cut to: its entry of `warp_windows` in the
// window mode (kWin), else all of [0, L). With kReload the entry is read
// where it is used (a volatile read, which the compiler neither merges nor
// hoists), so that it is live across one bias add only; else the compiler
// may keep it across a tile. The f32 passes take kReload and the bf16 ones
// do not: of the two, each the one under which the wide dk/dv pass spills
// no more than B2's (`chip_smoke.log_rpos_resources`, PERF.md).
template <bool kWin, int kWarps, bool kReload>
__device__ __forceinline__ Window bias_window(int warp, int L) {
  if constexpr (kWin && kReload) {
    const volatile Window& w = warp_windows<kWarps>()[warp];
    return Window{w.lo, w.hi};
  } else if constexpr (kWin) {
    return warp_windows<kWarps>()[warp];
  } else {
    return Window{0, L};
  }
}

__device__ __forceinline__ Window window_of(float off, int W, int L) {
  const float fl = static_cast<float>(L);
  Window w;
  w.lo = static_cast<int>(ceilf(fminf(fmaxf(off, 0.f), fl)));
  w.hi = static_cast<int>(ceilf(fminf(fmaxf(off + static_cast<float>(W), 0.f), fl)));
  if (w.hi < w.lo) w.hi = w.lo;
  return w;
}

}  // namespace
