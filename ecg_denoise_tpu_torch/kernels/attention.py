"""Fused biased attention (JAX counterpart: kernels/attention_pallas.py).

`fused_attention(q, k, v, bias)` computes softmax(q @ k^T + bias) @ v over
(B, H, L, D) operands, with the contract of the JAX package's
`fused_attention`: q arrives pre-scaled, bias is (1, H, L, L) or None,
head_dim D is 4 and L <= 256, and the output has the operands' dtype.

It dispatches on the tensors' device, with no switch and no fallback:

* a CUDA tensor goes to the hand-written Hopper kernel
  `csrc/attention_fwd.cu` (the port of the TPU kernel `_fwd_kernel`), or
  the call raises;
* a CPU tensor goes to `attention_reference`, the plain PyTorch version of
  the same function (the math of the JAX package's XLA path,
  ops/attention.py:115-122), which the CPU tests run and the card's checks
  compare the kernel against.

`fused_attention.launches` counts kernel launches (a plain int; set it to 0
before a run to show which kernels that run went through).

The kernel is forward-only: its backward (the TPU's `_bwd_kernel`) comes
with the training slice, so a CUDA call that would need a gradient raises.
"""

from __future__ import annotations

import ctypes
import functools
from typing import Optional

import torch

HEAD_DIM = 4
MAX_LEN = 256
_DTYPE_CODES = {torch.float32: 0, torch.bfloat16: 1}


def attention_reference(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                        bias: Optional[torch.Tensor] = None) -> torch.Tensor:
    """Plain PyTorch softmax(q @ k^T + bias) @ v.

    Logits and softmax in float32; the probabilities are rounded to v's
    dtype before the pv product, which accumulates in float32 — as the JAX
    package's XLA path does.
    """
    logits = torch.einsum("bhld,bhmd->bhlm", q.float(), k.float())
    if bias is not None:
        logits = logits + bias.float()
    probs = torch.softmax(logits, dim=-1).to(v.dtype)
    out = torch.einsum("bhlm,bhmd->bhld", probs.float(), v.float())
    return out.to(v.dtype)


def _check(q, k, v, bias) -> None:
    if q.dim() != 4 or k.shape != q.shape or v.shape != q.shape:
        raise ValueError(f"q, k, v must share one (B, H, L, D) shape, got "
                         f"{tuple(q.shape)}, {tuple(k.shape)}, {tuple(v.shape)}")
    B, H, L, D = q.shape
    if D != HEAD_DIM:
        raise ValueError(f"head_dim must be {HEAD_DIM}, got {D}")
    if L > MAX_LEN:
        raise ValueError(f"sequence length must be <= {MAX_LEN}, got {L}")
    if q.dtype not in _DTYPE_CODES or k.dtype != q.dtype or v.dtype != q.dtype:
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


@functools.cache
def _library() -> ctypes.CDLL:
    """The built kernel library with its C signatures declared."""
    from ecg_denoise_tpu_torch.kernels.build import load

    lib = load("attention_fwd")
    lib.ecg_attention_fwd.argtypes = ([ctypes.c_void_p] * 5 + [ctypes.c_int] * 6
                                      + [ctypes.c_void_p])
    lib.ecg_attention_fwd.restype = ctypes.c_int
    lib.ecg_cuda_error_string.argtypes = [ctypes.c_int]
    lib.ecg_cuda_error_string.restype = ctypes.c_char_p
    return lib


def _launch(q, k, v, bias) -> torch.Tensor:
    if torch.is_grad_enabled() and any(
            t is not None and t.requires_grad for t in (q, k, v, bias)):
        raise NotImplementedError(
            "the attention kernel is forward-only until the backward kernel "
            "lands; run inference under torch.no_grad()")
    tensors = (q, k, v) if bias is None else (q, k, v, bias)
    if not all(t.is_contiguous() for t in tensors):
        raise ValueError("the attention kernel needs contiguous operands")
    row_bytes = HEAD_DIM * q.element_size()  # the kernel's vector loads
    if q.numel() >= 2**31 or any(t.data_ptr() % row_bytes for t in (q, k, v)):
        raise ValueError(f"operands must hold < 2**31 elements and be "
                         f"{row_bytes}-byte aligned")
    lib = _library()
    fn = lib.ecg_attention_fwd
    B, H, L, D = q.shape
    o = torch.empty_like(q)
    stream = torch.cuda.current_stream(q.device).cuda_stream
    err = fn(q.data_ptr(), k.data_ptr(), v.data_ptr(),
             None if bias is None else bias.data_ptr(), o.data_ptr(),
             B, H, L, D, _DTYPE_CODES[q.dtype], q.device.index, stream)
    if err:
        raise RuntimeError("attention kernel launch failed: "
                           + lib.ecg_cuda_error_string(err).decode())
    fused_attention.launches += 1
    return o


def fused_attention(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                    bias: Optional[torch.Tensor] = None) -> torch.Tensor:
    """softmax(q @ k^T + bias) @ v; the kernel on the card, the plain
    version on the CPU (see the module docstring)."""
    _check(q, k, v, bias)
    if q.device.type == "cuda":
        return _launch(q, k, v, bias)
    if q.device.type == "cpu":
        return attention_reference(q, k, v, bias)
    raise ValueError(f"no attention path for device {q.device}")


fused_attention.launches = 0
