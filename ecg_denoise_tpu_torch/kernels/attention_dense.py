"""Dense-packed attention forward, B5 (JAX counterpart:
kernels/attention_pallas.py `_fwd_dense`, `_dense_wanted`, `_pack_factor`).

`fused_attention_dense(q, k, v, bias)` computes `fused_attention`'s
function, softmax(q @ k^T + bias) @ v over (B, H, L, D) operands with q
pre-scaled and bias (1, H, L, L) or None, as an eval forward: no
log-sum-exp is written and no gradient flows. It takes only the stages the
TPU packs, L < 128 a power of two with `dense_pack_factor(H, L)` > 1, and
dispatches on the tensors' device with no switch and no fallback:

* a CUDA tensor goes to the hand-written Hopper kernel
  `csrc/attention_dense_fwd.cu` (the port of the TPU kernel
  `_fwd_dense_kernel`) or the call raises. It runs at the head dim
  `kernel_head_dim` picks, as B1 does: D = 4 (RA-LENet's heads) on the D
  = 4 kernel, any other D <= 64 on the mma template at D = 8, 16, 32 or
  64 (bf16 from 16), any D > 64 on the wide kernel at the next multiple of
  64, q, k and v zero-padded along D to it and the output sliced back
  (`forward_at`: exact);
* a CPU tensor goes to `attention_dense_reference`, the plain version, at
  any D.

`fused_attention` routes a no-grad call on the card here when
`dense_route` says so: `dense_wanted()` (ECG_ATTN_DENSE=1, read at every
call, as JAX reads it at every trace) and the stage packs, as JAX's `_fwd`
(attention_pallas.py:621) packs, at any D; otherwise it keeps B1.

`attention_dense_reference` is written in the TPU kernel's own form, so
that the CPU tests hold its layout against JAX's kernel: q packed to
(B, H/P, L, P·D), a block-diagonal K of (P·D, P·L) giving each query one
dense (L, P·L) row of logits, and a ones-augmented block-diagonal V whose
pv product carries each head's sum beside its weighted sum. It parts from
the TPU kernel in one place, on purpose: each head subtracts its own row
max where the TPU subtracts one max over the packed row (see ROADMAP
section C). All float32; the output is rounded once.

`fused_attention_dense.launches` counts kernel launches (a plain int).
"""

from __future__ import annotations

import ctypes
import functools
import os
from typing import Optional

import torch

from ecg_denoise_tpu_torch.kernels.attention import (
    DTYPE_CODES,
    bind,
    check_launchable,
    check_operands,
    forward_at,
    kernel_head_dim,
    ptr,
    raise_on,
)

LANES = 128  # the width of the TPU's dense row, P·L


def dense_pack_factor(H: int, L: int) -> int:
    """How many heads the TPU packs into one 128-lane row at this stage
    (JAX's `_pack_factor` without its ECG_ATTN_PACK switch): 1 unless L <
    128 is a power of two; else min(128 / L, H), halved until it divides H."""
    if L >= LANES or L & (L - 1):
        return 1
    P = min(LANES // L, H)
    while P > 1 and H % P:
        P //= 2
    return P


def dense_wanted() -> bool:
    """ECG_ATTN_DENSE=1 routes packable stages of a no-grad call on the
    card through B5 (JAX's `_dense_wanted`), read at call time."""
    return os.environ.get("ECG_ATTN_DENSE", "0") == "1"


def dense_route(shape) -> bool:
    """Whether `fused_attention` sends a no-grad call of this (B, H, L, D)
    shape on the card to B5: ECG_ATTN_DENSE=1 and a lane-packable stage
    (the calls JAX's `_fwd`, attention_pallas.py:621, packs), at any D."""
    _, H, L, _ = shape
    return dense_wanted() and dense_pack_factor(H, L) > 1


def attention_dense_reference(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                              bias: Optional[torch.Tensor] = None) -> torch.Tensor:
    """Plain PyTorch version of B5, in the TPU kernel's dense form with
    each head's own row max; float32 throughout, the output rounded once."""
    B, H, L, D = q.shape
    P = dense_pack_factor(H, L)
    G = H // P
    eye = torch.eye(P, dtype=torch.float32, device=q.device)
    # q (B, G, L, P·D): lane p·D + d holds q[p, l, d].
    qp = q.float().reshape(B, G, P, L, D).transpose(2, 3).reshape(B, G, L, P * D)
    # BD_K[(p', d), (p, m)] = k[p, m, d]·[p == p'].
    kt = k.float().reshape(B, G, P, L, D).transpose(3, 4)  # [p, d, m]
    bdk = torch.einsum("xp,bgpdm->bgxdpm", eye, kt).reshape(B, G, P * D, P * L)
    logits = qp @ bdk  # (B, G, L, P·L), lane p·L + m
    if bias is not None:
        logits = logits + bias.float().reshape(1, G, P, L, L).transpose(2, 3).reshape(
            1, G, L, P * L)
    per_head = logits.reshape(B, G, L, P, L)
    e = torch.exp(per_head - per_head.amax(-1, keepdim=True)).reshape(B, G, L, P * L)
    # BD_V[(p', j), (p, m)] = [v; 1][p, m, j]·[p == p']: row (p, D) sums head p.
    vx = torch.cat([v.float().reshape(B, G, P, L, D),
                    torch.ones(B, G, P, L, 1, device=v.device)], dim=-1)
    bdv = torch.einsum("xp,bgpmj->bgxjpm", eye, vx).reshape(B, G, P * (D + 1), P * L)
    of = (e @ bdv.transpose(-1, -2)).reshape(B, G, L, P, D + 1)
    out = of[..., :D] / of[..., D:]
    return out.transpose(2, 3).reshape(B, H, L, D).to(q.dtype)


@functools.cache
def _library():
    """The kernel's library, built at first use."""
    return bind("attention_dense_fwd", "ecg_attention_dense_fwd", 5, 7)


def smem_bytes(L: int, D: int, P: int, dtype: torch.dtype, with_bias: bool) -> int:
    """The dynamic shared memory one block of B5 asks for at this call
    shape, as the library computes it (builds the library; for logging)."""
    lib = _library()
    f = lib.ecg_attention_dense_smem_bytes
    f.argtypes = [ctypes.c_int] * 5
    f.restype = ctypes.c_int
    n = f(L, D, P, DTYPE_CODES[dtype], int(with_bias))
    if n < 0:
        raise ValueError(f"B5 takes no call at L={L} D={D} P={P}")
    return n


def launch_shape(B: int, H: int, L: int, D: int, dtype: torch.dtype, with_bias: bool) -> dict:
    """The mma template's launch at this call shape (D = 8-64), or the
    wide kernel's (a multiple of 64 past 64), as the library computes it:
    blocks, threads a block and ring stages (builds the library; for
    logging; launches nothing)."""
    lib = _library()
    f = lib.ecg_attention_dense_launch_shape
    f.argtypes = [ctypes.c_int] * 8 + [ctypes.c_void_p]
    f.restype = ctypes.c_int
    out = (ctypes.c_int * 3)()
    raise_on(lib, f(B, H, L, D, dense_pack_factor(H, L), DTYPE_CODES[dtype], int(with_bias),
                    torch.cuda.current_device(), ctypes.addressof(out)),
             "dense attention launch shape")
    return dict(zip(("blocks", "threads", "stages"), out))


def _launch(q, k, v, bias, P: int):
    """B5 at the head dim `kernel_head_dim` picks, q, k and v padded to it."""
    B, H, L, D = q.shape
    return forward_at(kernel_head_dim(D, L, q.dtype), _launch_kernel, q, k, v, bias, P=P)


def _launch_kernel(q, k, v, bias, *, P: int):
    check_launchable(q, k, v, bias=bias)
    lib = _library()
    B, H, L, D = q.shape
    o = torch.empty_like(q)
    stream = torch.cuda.current_stream(q.device).cuda_stream
    err = lib.ecg_attention_dense_fwd(ptr(q), ptr(k), ptr(v), ptr(bias), ptr(o),
                                      B, H, L, D, P, DTYPE_CODES[q.dtype],
                                      q.device.index, stream)
    raise_on(lib, err, "dense attention forward")
    fused_attention_dense.launches += 1
    return o


def fused_attention_dense(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                          bias: Optional[torch.Tensor] = None) -> torch.Tensor:
    """B5 on the card, the plain version on the CPU (see the module
    docstring); raises on a stage the TPU does not pack and, on the card,
    on operands that need a gradient (B5 has no backward)."""
    check_operands(q, k, v, bias)
    H, L = q.shape[1], q.shape[2]
    P = dense_pack_factor(H, L)
    if P < 2:
        raise ValueError(f"the dense forward takes lane-packable stages only "
                         f"(L < {LANES} a power of two, pack factor > 1); got "
                         f"H={H}, L={L}")
    if q.device.type == "cuda":
        if torch.is_grad_enabled() and any(
                t is not None and t.requires_grad for t in (q, k, v, bias)):
            raise ValueError("the dense forward is an eval forward with no "
                             "backward; call fused_attention for gradients")
        return _launch(q, k, v, bias, P)
    if q.device.type == "cpu":
        return attention_dense_reference(q, k, v, bias)
    raise ValueError(f"no attention path for device {q.device}")


fused_attention_dense.launches = 0
