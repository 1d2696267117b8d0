"""Fused attention with a per-window R-peak bias (JAX counterpart:
kernels/attention_pallas.py `fused_attention_rpos`, `_rpos_single`,
`_rpos_fwd`, `_rpos_bwd`).

`fused_attention_rpos(q, k, v, toep, W, offsets)` computes, for every
window b of the batch,

    softmax(q·kᵀ + toep ⊙ (in_b in_bᵀ))·v,  in_b[l] = [off_b <= l < off_b + W],

over (B, H, L, D) operands with q pre-scaled, at any head dim D and
length L, as JAX's kernels take them. `toep` is the (1, H, L, L) Toeplitz
expansion of the rel-pos table in the operands' dtype, `offsets` the (B,)
float32 window starts (r_pos − W//2, whole numbers, possibly negative or
past L − W: the window is cut at the edges) and `W` the window width. The
(B, H, L, L) bias is built only by the plain versions, never on the card.

It dispatches on the tensors' device, as `fused_attention` does, with no
switch and no fallback:

* a CUDA tensor goes to the hand-written Hopper kernels or the call
  raises. With no gradient needed, to the forward kernel
  `csrc/attention_rpos_fwd.cu` alone (the port of the TPU kernel
  `_fwd_rpos_kernel`); with one, to `_FusedAttentionRpos`, a
  `torch.autograd.Function` whose forward is that kernel with its
  log-sum-exp residual and whose backward is `csrc/attention_rpos_bwd.cu`
  (the port of `_bwd_rpos_kernel`). Each source picks its kernels by the
  head dim its wrapper passes, and the wrapper zero-pads q, k, v (and o,
  g) along D up to it and slices the results back (`forward_at`,
  `backward_at`), at `rpos_head_dim`'s. The forward: D = 4 as it is at any
  L, on the D = 4 kernel to 256 keys (RA-LENet's path, whose keys fit a
  block's shared memory) and on B3's window kernel past them
  (`csrc/attention_rpos_fwd_mma.cuh`: the products of padded zeros were
  half its work at D = 8); D = 8, 16, 32 or 64 (bf16 from 16) on the
  window kernel too, other D <= 64 padded up; past 64 the wide kernel in
  its window mode at the next multiple of 64. The backward the same way:
  D = 4 as it is, on its D = 4 kernel to 256 keys and on B4's window
  kernel past them (`csrc/attention_rpos_bwd_mma.cuh`), D = 8, 16, 32 or
  64 (bf16 from 16) on the window kernel too, past 64 B2's wide passes in
  their window mode. Past the D = 4 kernel the backward's dq pass leaves
  each head's ds inside its element's window in a float32 (B, H, W', W')
  scratch, W' = min(W, L), and a second kernel sums it over the batch
  into dtoep (`window_ds`, `dtoep_from_window_ds`: their plain versions).
  The offsets get no gradient (JAX gives them a zero cotangent); the
  table's gradient comes from autograd's gather backward outside the
  kernels, from dtoep;
* a CPU tensor goes to `attention_rpos_reference`, the plain PyTorch
  version, and autograd runs through it.

`attention_rpos_reference(..., return_lse=True)` and
`attention_rpos_backward_reference` are the plain versions of the two
kernels. `fused_attention_rpos.launches` counts forward-kernel launches and
`fused_attention_rpos.bwd_launches` backward launches (plain ints).
"""

from __future__ import annotations

import ctypes
import functools

import torch

from ecg_denoise_tpu_torch.kernels.attention import (
    DTYPE_CODES,
    HEAD_DIM,
    MAX_LEN,
    attention_reference,
    backward_at,
    bind,
    check_launchable,
    check_operands,
    flash_backward_terms,
    forward_at,
    kernel_head_dim,
    ptr,
    raise_on,
)


def window_mask(offsets: torch.Tensor, W: int, L: int) -> torch.Tensor:
    """(B, L) bool: in_b[l] = off_b <= l < off_b + W, compared in float32
    as the JAX package compares."""
    pos = torch.arange(L, dtype=torch.float32, device=offsets.device)
    off = offsets.float()[:, None]
    return (pos >= off) & (pos < off + W)


def materialize_rpos_bias(toep: torch.Tensor, W: int,
                          offsets: torch.Tensor) -> torch.Tensor:
    """The (B, H, L, L) bias toep ⊙ (in_b in_bᵀ), in toep's dtype (JAX's
    `RPosBias.materialize`)."""
    m = window_mask(offsets, W, toep.shape[-1]).to(toep.dtype)
    return toep * m[:, None, :, None] * m[:, None, None, :]


def attention_rpos_reference(q, k, v, toep, W: int, offsets, *,
                             return_lse: bool = False):
    """Plain PyTorch version of the forward kernel: `attention_reference`
    with the materialised per-window bias (and, with `return_lse`, the
    float32 (B, H, L) row log-sum-exp)."""
    return attention_reference(q, k, v, materialize_rpos_bias(toep, W, offsets),
                               return_lse=return_lse)


def attention_rpos_backward_reference(q, k, v, toep, W: int, offsets, o, lse, g):
    """Plain PyTorch version of the backward kernel, in the flash form
    (`flash_backward_terms`) on the materialised bias, with
    dtoep = Σ_b ds ⊙ (in_b in_bᵀ) summed in float32 and cast to toep's
    dtype; dq, dk and dv are rounded once to the operand dtype."""
    m = window_mask(offsets, W, toep.shape[-1]).float()
    mm = m[:, None, :, None] * m[:, None, None, :]
    bias = materialize_rpos_bias(toep, W, offsets)
    dq, dk, dv, ds = flash_backward_terms(q, k, v, bias, o, lse, g)
    dtoep = (ds * mm).sum(0, keepdim=True).to(toep.dtype)
    return dq.to(q.dtype), dk.to(k.dtype), dv.to(v.dtype), dtoep


def window_bounds(offsets: torch.Tensor, W: int, L: int):
    """Each element's window as (first position, length), int64 (B,): the
    run of `window_mask`, cut to [0, L) (length 0 where it is empty)."""
    m = window_mask(offsets, W, L)
    return m.to(torch.int64).argmax(1), m.sum(1)


def window_ds(ds: torch.Tensor, offsets: torch.Tensor, W: int) -> torch.Tensor:
    """Plain version of what the card's dq pass leaves in its scratch past
    the D = 4 kernels: from ds (B, H, L, L) the float32 (B, H, W', W'),
    W' = min(W, L), entry (i, j) of element b the ds at (s_b + i, s_b + j)
    for i, j below its window's length n_b, s_b its first position. The
    kernel leaves the rest unwritten; here it is 0."""
    B, H, L, _ = ds.shape
    Wp = min(W, L)
    lo, n = window_bounds(offsets, W, L)
    i = torch.arange(Wp, device=ds.device)
    idx = (lo[:, None] + i).clamp(max=L - 1)  # (B, W')
    inside = i[None, :] < n[:, None]
    got = ds.float()[torch.arange(B, device=ds.device)[:, None, None], :,
                     idx[:, :, None], idx[:, None, :]]  # (B, W', W', H)
    got = got.permute(0, 3, 1, 2)
    return got * (inside[:, None, :, None] & inside[:, None, None, :])


def dtoep_from_window_ds(ds_win: torch.Tensor, offsets: torch.Tensor, W: int,
                         L: int) -> torch.Tensor:
    """Plain version of the dtoep sum past the D = 4 kernels: the float32
    (1, H, L, L) dtoep[h, l, m] = Σ_b ds_win[b, h, l - s_b, m - s_b] over
    the elements whose window holds l and m, b ascending (the kernel's
    order: one f32 sum per (h, l, m))."""
    B, H = ds_win.shape[:2]
    lo, n = window_bounds(offsets, W, L)
    out = torch.zeros(1, H, L, L, dtype=torch.float32, device=ds_win.device)
    for b, (s, w) in enumerate(zip(lo.tolist(), n.tolist())):
        out[0, :, s:s + w, s:s + w] += ds_win[b, :, :w, :w]
    return out


def _check(q, k, v, toep, W, offsets) -> None:
    if toep is None:
        raise ValueError("toep is required")
    check_operands(q, k, v, toep)
    B = q.shape[0]
    if not isinstance(W, int) or W < 1:
        raise ValueError(f"W must be a positive int, got {W!r}")
    if tuple(offsets.shape) != (B,) or offsets.dtype != torch.float32:
        raise ValueError(f"offsets must be ({B},) float32, got "
                         f"{tuple(offsets.shape)} {offsets.dtype}")
    if offsets.device != q.device:
        raise ValueError("offsets must be on the operands' device")


@functools.cache
def _library():
    """The forward kernel's library, built at first use."""
    return bind("attention_rpos_fwd", "ecg_attention_rpos_fwd", 7, 7)


@functools.cache
def _bwd_library():
    """The backward kernel's library, built at first use."""
    lib = bind("attention_rpos_bwd", "ecg_attention_rpos_bwd", 14, 7)
    f = lib.ecg_attention_rpos_dtoep_sum
    f.argtypes = [ctypes.c_void_p] * 3 + [ctypes.c_int] * 5 + [ctypes.c_void_p]
    f.restype = ctypes.c_int
    return lib


def rpos_head_dim(D: int, L: int, dtype: torch.dtype) -> int:
    """The head dim B3 and B4 run a (D, L) call at on the card: D = 4 as it
    is at any L (the D = 4 kernels to 256 keys, the window kernels past
    them), else `kernel_head_dim`'s."""
    return D if D == HEAD_DIM else kernel_head_dim(D, L, dtype)


def _launch(q, k, v, toep, W, offsets, *, with_lse: bool = False):
    """The forward kernel: o, plus the float32 (B, H, L) lse if asked; at
    the head dim `rpos_head_dim` picks, q, k and v padded to it."""
    B, H, L, D = q.shape
    return forward_at(rpos_head_dim(D, L, q.dtype), _launch_kernel, q, k, v, toep,
                      W=W, offsets=offsets, with_lse=with_lse)


def _launch_kernel(q, k, v, toep, *, W, offsets, with_lse: bool):
    check_launchable(q, k, v, bias=toep)
    if not offsets.is_contiguous():
        raise ValueError("offsets must be contiguous")
    lib = _library()
    B, H, L, D = q.shape
    o = torch.empty_like(q)
    lse = (torch.empty(B, H, L, dtype=torch.float32, device=q.device)
           if with_lse else None)
    stream = torch.cuda.current_stream(q.device).cuda_stream
    err = lib.ecg_attention_rpos_fwd(
        ptr(q), ptr(k), ptr(v), ptr(toep), ptr(offsets), ptr(o), ptr(lse),
        B, H, L, D, W, DTYPE_CODES[q.dtype], q.device.index, stream)
    raise_on(lib, err, "attention r-pos forward")
    fused_attention_rpos.launches += 1
    return (o, lse) if with_lse else o


def _launch_bwd(q, k, v, toep, W, offsets, o, lse, g):
    """The backward kernel: (dq, dk, dv, dtoep), dtoep in toep's dtype; at
    the head dim `rpos_head_dim` picks, q, k, v, o and g padded to it."""
    if g.shape != q.shape or g.dtype != q.dtype:
        raise ValueError(f"gradient {tuple(g.shape)} {g.dtype} does not match "
                         f"the output {tuple(q.shape)} {q.dtype}")
    g = g.contiguous()  # MSAttention's transpose(1, 2).reshape is strided
    B, H, L, D = q.shape
    return backward_at(rpos_head_dim(D, L, q.dtype), _launch_bwd_kernel, q, k, v, toep,
                       o, lse, g, W=W, offsets=offsets)


def _launch_bwd_kernel(q, k, v, toep, o, lse, g, *, W, offsets):
    """The backward at the kernel's head dim: (dq, dk, dv, dtoep), dtoep
    summed in float32 and cast once to toep's dtype. Past the D = 4
    kernel the passes fill the ds scratch and `_dtoep_sum` forms dtoep."""
    check_launchable(q, k, v, o, g, bias=toep)
    B, H, L, D = q.shape
    ds = (None if D == HEAD_DIM and L <= MAX_LEN else
          torch.empty(B, H, min(W, L), min(W, L), dtype=torch.float32, device=q.device))
    dq, dk, dv, dtoep = _bwd_passes(q, k, v, toep, o, lse, g, W, offsets, ds)
    if ds is not None:
        _dtoep_sum(ds, offsets, W, dtoep)
    fused_attention_rpos.bwd_launches += 1
    return dq, dk, dv, dtoep.to(toep.dtype)  # summed in float32, cast once


def _bwd_passes(q, k, v, toep, o, lse, g, W, offsets, ds):
    """The backward kernel's passes: dq, dk, dv, and on the D = 4 kernel
    dtoep (float32; else left unwritten: the passes fill `ds`)."""
    lib = _bwd_library()
    B, H, L, D = q.shape
    dq, dk, dv = (torch.empty_like(q) for _ in range(3))
    c = torch.empty(B, H, L, dtype=torch.float32, device=q.device)
    dtoep = torch.empty(1, H, L, L, dtype=torch.float32, device=q.device)
    stream = torch.cuda.current_stream(q.device).cuda_stream
    err = lib.ecg_attention_rpos_bwd(
        ptr(q), ptr(k), ptr(v), ptr(toep), ptr(offsets), ptr(g), ptr(o),
        ptr(lse), ptr(c), ptr(dq), ptr(dk), ptr(dv), ptr(dtoep), ptr(ds),
        B, H, L, D, W, DTYPE_CODES[q.dtype], q.device.index, stream)
    raise_on(lib, err, "attention r-pos backward")
    return dq, dk, dv, dtoep


def _dtoep_sum(ds, offsets, W, dtoep):
    """The second kernel past the D = 4 kernel: dtoep (float32 (1, H, L,
    L), written in place) from the scratch the dq pass filled."""
    lib = _bwd_library()
    B, H = ds.shape[:2]
    L = dtoep.shape[-1]
    err = lib.ecg_attention_rpos_dtoep_sum(
        ptr(ds), ptr(offsets), ptr(dtoep), B, H, L, W, ds.device.index,
        torch.cuda.current_stream(ds.device).cuda_stream)
    raise_on(lib, err, "attention r-pos dtoep sum")


class _FusedAttentionRpos(torch.autograd.Function):
    """The forward kernel with its lse residual, and the backward kernel
    (JAX counterpart: the custom VJP `_rpos_single`)."""

    @staticmethod
    def forward(ctx, q, k, v, toep, W, offsets):
        o, lse = _launch(q, k, v, toep, W, offsets, with_lse=True)
        ctx.save_for_backward(q, k, v, toep, offsets, o, lse)
        ctx.W = W
        return o

    @staticmethod
    def backward(ctx, g):
        q, k, v, toep, offsets, o, lse = ctx.saved_tensors
        dq, dk, dv, dtoep = _launch_bwd(q, k, v, toep, ctx.W, offsets, o, lse, g)
        return dq, dk, dv, dtoep, None, None


def fused_attention_rpos(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                         toep: torch.Tensor, W: int,
                         offsets: torch.Tensor) -> torch.Tensor:
    """Per-window R-peak biased attention; the kernels on the card, the
    plain version on the CPU (see the module docstring)."""
    _check(q, k, v, toep, W, offsets)
    if q.device.type == "cuda":
        if torch.is_grad_enabled() and any(
                t.requires_grad for t in (q, k, v, toep)):
            return _FusedAttentionRpos.apply(q, k, v, toep, W, offsets)
        return _launch(q, k, v, toep, W, offsets)
    if q.device.type == "cpu":
        return attention_rpos_reference(q, k, v, toep, W, offsets)
    raise ValueError(f"no attention path for device {q.device}")


fused_attention_rpos.launches = 0
fused_attention_rpos.bwd_launches = 0
