"""Batched db8 wavelet denoising on the card (JAX counterpart:
kernels/dwt_tpu.py; reference local_utils/denoisefunc.py:7-33).

The reference's DWT baseline loops rows through pywt on the host, one
python call per 256-sample row (reference dwt_dn.py:59-68). Here the whole
batch is denoised on its device: each level's analysis is a stride-2
`conv1d` over (rows, L), each synthesis a `conv1d` over the zero-stuffed
coefficients, the thresholds per-row reductions, and nothing leaves the
device. Numerically the host path (`baselines/dwt.py`) to float32
precision.

This is plain PyTorch, as `dwt_tpu.py` is plain XLA: no function there
reaches `pallas_call`, so there is no TPU kernel to write again by hand.
`conv1d` correlates, as `lax.conv_general_dilated` does, so the filters
are reversed where the JAX code reverses them; on the card the
convolutions run in full float32, not TF32 (`full_float32`), as the JAX
code asks for `Precision.HIGHEST`.
"""

from __future__ import annotations

from functools import lru_cache

import torch
import torch.nn.functional as F

from ecg_denoise_tpu_torch import full_float32
from ecg_denoise_tpu_torch.baselines.dwt import daubechies_filters, dwt_max_level


@lru_cache(maxsize=8)
def _filters(n_moments: int, device: torch.device):
    """(dec_lo, dec_hi, rec_lo, rec_hi), each reversed, as (1, 1, F)
    float32 correlation weights on `device`."""
    return tuple(torch.tensor(f[::-1].copy(), dtype=torch.float32,
                              device=device).reshape(1, 1, -1)
                 for f in daubechies_filters(n_moments))


def _corr(x: torch.Tensor, filt: torch.Tensor, stride: int = 1) -> torch.Tensor:
    """Valid correlation of (rows, L) with a (1, 1, F) filter."""
    return F.conv1d(x[:, None, :], filt, stride=stride)[:, 0, :]


def _symmetric_pad(x: torch.Tensor, p: int) -> torch.Tensor:
    """numpy's `pad(mode="symmetric")` by p on both sides of the last axis
    (the edge sample repeated), for rows of at least p samples."""
    return torch.cat([x[:, :p].flip(1), x, x[:, -p:].flip(1)], dim=1)


def _dwt_level(x: torch.Tensor, dec_lo: torch.Tensor, dec_hi: torch.Tensor):
    F_ = dec_lo.shape[-1]
    ext = _symmetric_pad(x, F_ - 1)[:, 1:]
    return _corr(ext, dec_lo, stride=2), _corr(ext, dec_hi, stride=2)


def _idwt_level(cA: torch.Tensor, cD: torch.Tensor, rec_lo: torch.Tensor,
                rec_hi: torch.Tensor) -> torch.Tensor:
    L = cA.shape[1]
    upA = cA.new_zeros(cA.shape[0], 2 * L - 1)
    upA[:, ::2] = cA
    upD = cD.new_zeros(cD.shape[0], 2 * L - 1)
    upD[:, ::2] = cD
    return _corr(F.pad(upA, (1, 1)), rec_lo) + _corr(F.pad(upD, (1, 1)), rec_hi)


def _soft(x: torch.Tensor, thr: torch.Tensor) -> torch.Tensor:
    mag = x.abs()
    return torch.where(mag > 0, x / mag, 0.0) * torch.clamp(mag - thr, min=0.0)


def wavelet_denoise_device(x: torch.Tensor, threshold: float = 0.04,
                           n_moments: int = 8) -> torch.Tensor:
    """Batched wavelet denoise of (..., L) on x's device — every leading
    dim is a row; float32 out. Each detail band is soft-thresholded at
    `threshold * max(band)` per row (max, not max|band|: the reference's
    quirk)."""
    if x.is_cuda:
        full_float32()
    lead, sig_len = x.shape[:-1], x.shape[-1]
    dec_lo, dec_hi, rec_lo, rec_hi = _filters(n_moments, x.device)
    level = dwt_max_level(sig_len, dec_lo.shape[-1])
    a = x.reshape(-1, sig_len).to(torch.float32)
    with torch.no_grad():
        details = []
        for _ in range(level):
            a, d = _dwt_level(a, dec_lo, dec_hi)
            thr = threshold * d.amax(dim=-1, keepdim=True)
            details.append(_soft(d, thr))
        for d in reversed(details):
            if a.shape[1] == d.shape[1] + 1:
                a = a[:, :-1]
            a = _idwt_level(a, d, rec_lo, rec_hi)
    return a[:, :sig_len].reshape(*lead, sig_len)
