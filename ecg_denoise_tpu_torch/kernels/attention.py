"""Fused biased attention (JAX counterpart: kernels/attention_pallas.py).

`fused_attention(q, k, v, bias)` computes softmax(q @ k^T + bias) @ v over
(B, H, L, D) operands, with the contract of the JAX package's
`fused_attention`: q arrives pre-scaled, bias is (1, H, L, L) or None, and
the output has the operands' dtype. Like JAX's kernels it takes any head
dim D and any length L on the CPU, and so do the card's kernels, each
built for some (`kernel_head_dim`): D = 4 at L <= 256 takes the D = 4
kernels (they hold a row's logits in registers; RA-LENet, the only model
with 4-wide heads, is built for 256 samples), any other D <= 64 the mma
template at D = 8, 16, 32 or 64 (bf16 from 16), and any D > 64 the wide
kernels at the next multiple of 64 (they cut D into 64-wide chunks; a
block owns 64 dims of the output). q, k and v are zero-padded along D to
the kernel's and the results sliced back (`forward_at`, `backward_at`):
exact, since zero dims change no logit, output or gradient.

It dispatches on the tensors' device, with no switch and no fallback:

* a CUDA tensor goes to the hand-written Hopper kernels or the call
  raises. When no gradient is needed, to the forward kernel
  `csrc/attention_fwd.cu` alone (the port of the TPU kernel `_fwd_kernel`)
  or, with `ECG_ATTN_DENSE=1` in the environment (read at every call) and
  a lane-packable stage (L < 128 a power of two,
  `dense_pack_factor` > 1), to the dense forward
  `csrc/attention_dense_fwd.cu` (the port of `_fwd_dense_kernel`, B5; see
  `attention_dense.py`), at any D, as JAX's `_fwd`
  (attention_pallas.py:621) packs any. When one is needed,
  to `_FusedAttention`, a `torch.autograd.Function`
  whose forward is that kernel with its log-sum-exp residual and whose
  backward is `csrc/attention_bwd.cu` (the port of `_bwd_kernel`). Each
  source holds the D = 4 kernels and, beside them, the mma template and
  the wide kernels; its C entry point picks by D;
* a CPU tensor goes to `attention_reference`, the plain PyTorch version of
  the same function (the math of the JAX package's XLA path,
  ops/attention.py:115-122), and autograd runs through it.

`attention_reference(..., return_lse=True)` and
`attention_backward_reference` are the plain versions of the two kernels,
which the CPU tests run and the card's checks compare the kernels against;
nothing on the card's main path calls them.

`fused_attention.launches` counts forward-kernel launches and
`fused_attention.bwd_launches` backward launches, one per backward of one
attention call (plain ints; set them to 0 before a run to show which
kernels that run went through).
"""

from __future__ import annotations

import ctypes
import functools
from typing import Optional

import torch

HEAD_DIM = 4  # RA-LENet's: the head dim of the D = 4 kernels of B1-B5
MAX_LEN = 256  # the D = 4 kernels' longest L; the mma template takes any L
# The head dims of B1's and B2's mma template (bf16 from 16, the depth of
# its mma); the wrapper pads any other D <= 64 up to the next one.
MMA_HEAD_DIMS = (8, 16, 32, 64)
# Past MMA_HEAD_DIMS[-1] the wide kernels take every multiple of this (the
# width of their chunks of D); the wrapper pads any other D up to the next.
WIDE_CHUNK = 64
DTYPE_CODES = {torch.float32: 0, torch.bfloat16: 1}


def attention_reference(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                        bias: Optional[torch.Tensor] = None, *,
                        return_lse: bool = False):
    """Plain PyTorch softmax(q @ k^T + bias) @ v.

    Logits and softmax in float32; the probabilities are rounded to v's
    dtype before the pv product, which accumulates in float32 — as the JAX
    package's XLA path does. With `return_lse`, also the float32 (B, H, L)
    log-sum-exp of the logits' rows, the forward kernel's residual.
    """
    logits = torch.einsum("bhld,bhmd->bhlm", q.float(), k.float())
    if bias is not None:
        logits = logits + bias.float()
    probs = torch.softmax(logits, dim=-1).to(v.dtype)
    out = torch.einsum("bhlm,bhmd->bhld", probs.float(), v.float()).to(v.dtype)
    if return_lse:
        return out, torch.logsumexp(logits, dim=-1)
    return out


def flash_backward_terms(q, k, v, bias, o, lse, g):
    """The float32 flash backward from the forward output `o`, its float32
    log-sum-exp `lse` and the output gradient `g`:

        p = exp(q·kᵀ + bias − lse),  c = Σ_d g·o,  ds = p ⊙ (g·vᵀ − c),
        dq = ds·k,  dk = dsᵀ·q,  dv = pᵀ·g.

    Returns (dq, dk, dv, ds), all float32; bias is None or broadcasts
    against the (B, H, L, L) logits.
    """
    qf, kf, vf, gf, of = (t.float() for t in (q, k, v, g, o))
    logits = torch.einsum("bhld,bhmd->bhlm", qf, kf)
    if bias is not None:
        logits = logits + bias.float()
    p = torch.exp(logits - lse[..., None])
    c = (gf * of).sum(-1, keepdim=True)
    ds = p * (torch.einsum("bhld,bhmd->bhlm", gf, vf) - c)
    dq = torch.einsum("bhlm,bhmd->bhld", ds, kf)
    dk = torch.einsum("bhlm,bhld->bhmd", ds, qf)
    dv = torch.einsum("bhlm,bhld->bhmd", p, gf)
    return dq, dk, dv, ds


def attention_backward_reference(q, k, v, bias, o, lse, g):
    """Plain PyTorch backward of `fused_attention`, in the flash form the
    backward kernel computes (`flash_backward_terms`), with
    dbias = Σ_b ds. dq, dk and dv are rounded once to the operand dtype,
    and dbias (None without a bias) is summed in float32 and cast to the
    bias dtype.
    """
    dq, dk, dv, ds = flash_backward_terms(q, k, v, bias, o, lse, g)
    dbias = None if bias is None else ds.sum(0, keepdim=True).to(bias.dtype)
    return dq.to(q.dtype), dk.to(k.dtype), dv.to(v.dtype), dbias


def check_operands(q, k, v, bias) -> None:
    """Raise on operands outside the contract on every device: one (B, H,
    L, D) shape, float32 or bfloat16, a (1, H, L, L) bias of their dtype,
    one device."""
    if q.dim() != 4 or k.shape != q.shape or v.shape != q.shape:
        raise ValueError(f"q, k, v must share one (B, H, L, D) shape, got "
                         f"{tuple(q.shape)}, {tuple(k.shape)}, {tuple(v.shape)}")
    B, H, L, D = q.shape
    if q.dtype not in DTYPE_CODES or k.dtype != q.dtype or v.dtype != q.dtype:
        raise TypeError(f"q, k, v must all be float32 or bfloat16, got "
                        f"{q.dtype}, {k.dtype}, {v.dtype}")
    tensors = (q, k, v)
    if bias is not None:
        if tuple(bias.shape) != (1, H, L, L):
            raise ValueError(f"bias must be (1, {H}, {L}, {L}), got "
                             f"{tuple(bias.shape)}")
        if bias.dtype != q.dtype:
            raise TypeError(f"bias dtype {bias.dtype} != operand dtype {q.dtype}")
        tensors += (bias,)
    if any(t.device != q.device for t in tensors):
        raise ValueError("q, k, v and bias must be on one device")


def kernel_head_dim(D: int, L: int, dtype: torch.dtype) -> int:
    """The head dim B1, B2 and B5 run a (D, L) call at on the card (B3 and
    B4 too but at D = 4, `attention_rpos.rpos_head_dim`): D = 4 at L <= MAX_LEN on the D = 4 kernels, else
    the smallest of MMA_HEAD_DIMS (16 and up at bfloat16) that holds D, and
    past the largest the next multiple of WIDE_CHUNK (the wide kernels)."""
    if D == HEAD_DIM and L <= MAX_LEN:
        return D
    for d in MMA_HEAD_DIMS:
        if d >= D and (d >= 16 or dtype != torch.bfloat16):
            return d
    return -(-D // WIDE_CHUNK) * WIDE_CHUNK


def _pad(t: torch.Tensor, D: int) -> torch.Tensor:
    """t zero-padded along its last dim to D."""
    return torch.nn.functional.pad(t, (0, D - t.shape[-1]))


def _narrow(t: torch.Tensor, D: int) -> torch.Tensor:
    return t[..., :D].contiguous()


def forward_at(D_kernel: int, forward, q, k, v, bias, **kw):
    """`forward(q, k, v, bias, **kw)` (o, or (o, lse)) run at head dim
    D_kernel: q, k and v zero-padded along D, o sliced back. Exact: q
    arrives scaled, and zero dims change no logit and add nothing to o."""
    D = q.shape[-1]
    if D_kernel == D:
        return forward(q, k, v, bias, **kw)
    out = forward(*(_pad(t, D_kernel) for t in (q, k, v)), bias, **kw)
    if isinstance(out, tuple):
        return (_narrow(out[0], D), *out[1:])
    return _narrow(out, D)


def backward_at(D_kernel: int, backward, q, k, v, bias, o, lse, g, **kw):
    """`backward(q, k, v, bias, o, lse, g, **kw)` ((dq, dk, dv, dbias)) run
    at head dim D_kernel: q, k, v, o and g zero-padded along D, dq, dk and
    dv sliced back. Exact: g.o, the logits, p and ds are unchanged, and
    the padded dims' gradients are dropped."""
    D = q.shape[-1]
    if D_kernel == D:
        return backward(q, k, v, bias, o, lse, g, **kw)
    q, k, v, o, g = (_pad(t, D_kernel) for t in (q, k, v, o, g))
    dq, dk, dv, dbias = backward(q, k, v, bias, o, lse, g, **kw)
    return _narrow(dq, D), _narrow(dk, D), _narrow(dv, D), dbias


def bind(name: str, fn: str, n_pointers: int, n_ints: int = 6,
         csrc=None) -> ctypes.CDLL:
    """The built library `name` with `fn`'s C signature declared:
    `n_pointers` pointers, `n_ints` ints (for the attention kernels B, H,
    L, D, [W or P,] dtype, device), then the stream. `csrc`: another
    directory of sources (`build.load`), else the package's."""
    from ecg_denoise_tpu_torch.kernels.build import CSRC, load

    lib = load(name, csrc or CSRC)
    f = getattr(lib, fn)
    f.argtypes = ([ctypes.c_void_p] * n_pointers + [ctypes.c_int] * n_ints
                  + [ctypes.c_void_p])
    f.restype = ctypes.c_int
    lib.ecg_cuda_error_string.argtypes = [ctypes.c_int]
    lib.ecg_cuda_error_string.restype = ctypes.c_char_p
    return lib


@functools.cache
def _library() -> ctypes.CDLL:
    """The forward kernel's library, built at first use."""
    return bind("attention_fwd", "ecg_attention_fwd", 6)


@functools.cache
def _bwd_library() -> ctypes.CDLL:
    """The backward kernel's library, built at first use."""
    return bind("attention_bwd", "ecg_attention_bwd", 12)


def ptr(t: Optional[torch.Tensor]):
    return None if t is None else t.data_ptr()


def check_launchable(*tensors, bias=None) -> None:
    """Raise on what the kernels do not take: strided operands, more than
    2**31 elements, rows not aligned for the kernels' vector loads (a row
    of 4 values at D = 4, 16 bytes at the mma template's D)."""
    if not all(t.is_contiguous() for t in tensors) or (
            bias is not None and not bias.is_contiguous()):
        raise ValueError("the attention kernels need contiguous operands")
    row_bytes = min(16, tensors[0].shape[-1] * tensors[0].element_size())
    if tensors[0].numel() >= 2**31 or any(t.data_ptr() % row_bytes for t in tensors):
        raise ValueError(f"operands must hold < 2**31 elements and be "
                         f"{row_bytes}-byte aligned")


def raise_on(lib, err: int, what: str) -> None:
    if err:
        raise RuntimeError(f"{what} kernel launch failed: "
                           + lib.ecg_cuda_error_string(err).decode())


def _launch(q, k, v, bias, *, with_lse: bool = False):
    """The forward kernel: o, plus the float32 (B, H, L) lse if asked; at
    the head dim `kernel_head_dim` picks, q, k and v padded to it."""
    B, H, L, D = q.shape
    return forward_at(kernel_head_dim(D, L, q.dtype), _launch_kernel, q, k, v, bias,
                      with_lse=with_lse)


def _launch_kernel(q, k, v, bias, *, with_lse: bool):
    check_launchable(q, k, v, bias=bias)
    lib = _library()
    B, H, L, D = q.shape
    o = torch.empty_like(q)
    lse = (torch.empty(B, H, L, dtype=torch.float32, device=q.device)
           if with_lse else None)
    stream = torch.cuda.current_stream(q.device).cuda_stream
    err = lib.ecg_attention_fwd(ptr(q), ptr(k), ptr(v), ptr(bias), ptr(o),
                                ptr(lse), B, H, L, D, DTYPE_CODES[q.dtype],
                                q.device.index, stream)
    raise_on(lib, err, "attention forward")
    fused_attention.launches += 1
    return (o, lse) if with_lse else o


def _launch_bwd(q, k, v, bias, o, lse, g, *, want_dbias: bool):
    """The backward kernel: (dq, dk, dv, dbias), dbias None unless asked;
    at the forward's head dim, q, k, v, o and g padded to it."""
    if g.shape != q.shape or g.dtype != q.dtype:
        raise ValueError(f"gradient {tuple(g.shape)} {g.dtype} does not match "
                         f"the output {tuple(q.shape)} {q.dtype}")
    # MSAttention's transpose(1, 2).reshape hands back a strided gradient.
    g = g.contiguous()
    B, H, L, D = q.shape
    return backward_at(kernel_head_dim(D, L, q.dtype), _launch_bwd_kernel, q, k, v, bias,
                       o, lse, g, want_dbias=want_dbias)


def _launch_bwd_kernel(q, k, v, bias, o, lse, g, *, want_dbias: bool):
    check_launchable(q, k, v, o, g, bias=bias)
    lib = _bwd_library()
    B, H, L, D = q.shape
    dq, dk, dv = (torch.empty_like(q) for _ in range(3))
    c = torch.empty(B, H, L, dtype=torch.float32, device=q.device)
    dbias = (torch.empty(1, H, L, L, dtype=torch.float32, device=q.device)
             if want_dbias and bias is not None else None)
    stream = torch.cuda.current_stream(q.device).cuda_stream
    err = lib.ecg_attention_bwd(ptr(q), ptr(k), ptr(v), ptr(bias), ptr(g),
                                ptr(o), ptr(lse), ptr(c), ptr(dq), ptr(dk),
                                ptr(dv), ptr(dbias), B, H, L, D,
                                DTYPE_CODES[q.dtype], q.device.index, stream)
    raise_on(lib, err, "attention backward")
    fused_attention.bwd_launches += 1
    if dbias is not None:
        dbias = dbias.to(bias.dtype)  # summed in float32, cast once
    return dq, dk, dv, dbias


class _FusedAttention(torch.autograd.Function):
    """The forward kernel with its lse residual, and the backward kernel
    (JAX counterpart: the custom VJP `_fused_single`)."""

    @staticmethod
    def forward(ctx, q, k, v, bias):
        o, lse = _launch(q, k, v, bias, with_lse=True)
        ctx.save_for_backward(q, k, v, bias, o, lse)
        return o

    @staticmethod
    def backward(ctx, g):
        q, k, v, bias, o, lse = ctx.saved_tensors
        # A bias gradient only when the bias asks for one (JAX's want_dbias).
        return _launch_bwd(q, k, v, bias, o, lse, g,
                           want_dbias=ctx.needs_input_grad[3])


def fused_attention(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                    bias: Optional[torch.Tensor] = None) -> torch.Tensor:
    """softmax(q @ k^T + bias) @ v; the kernels on the card, the plain
    version on the CPU (see the module docstring)."""
    check_operands(q, k, v, bias)
    if q.device.type == "cuda":
        if torch.is_grad_enabled() and any(
                t is not None and t.requires_grad for t in (q, k, v, bias)):
            return _FusedAttention.apply(q, k, v, bias)
        # Imported here: attention_dense builds on this module's helpers.
        from ecg_denoise_tpu_torch.kernels.attention_dense import (
            dense_route,
            fused_attention_dense,
        )

        if dense_route(q.shape):
            return fused_attention_dense(q, k, v, bias)
        return _launch(q, k, v, bias)
    if q.device.type == "cpu":
        return attention_reference(q, k, v, bias)
    raise ValueError(f"no attention path for device {q.device}")


fused_attention.launches = 0
fused_attention.bwd_launches = 0
