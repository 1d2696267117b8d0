"""Denoising quality metrics, per sample (JAX counterpart:
metrics/denoise.py; reference local_utils/evaluate.py:10-51).

Inputs are batched signals (B, C, L) — everything after the batch dim is
flattened — and outputs are per-sample (B,) tensors, computed on the
inputs' device so the training step needs no host transfer for them.
"""

from __future__ import annotations

import torch


def _flatten_batch(y: torch.Tensor) -> torch.Tensor:
    return y.reshape(y.shape[0], -1)


def RMSE(y: torch.Tensor, y_pred: torch.Tensor) -> torch.Tensor:
    """Per-sample root-mean-squared error over all non-batch dims."""
    y, y_pred = _flatten_batch(y), _flatten_batch(y_pred)
    return torch.sqrt(torch.mean((y - y_pred) ** 2, dim=-1))


def SNR(y: torch.Tensor, y_pred: torch.Tensor) -> torch.Tensor:
    """Per-sample output SNR in dB: 10·log10(E[y²] / E[(y − y_pred)²])."""
    y, y_pred = _flatten_batch(y), _flatten_batch(y_pred)
    signal = torch.mean(y ** 2, dim=-1)
    err = torch.mean((y - y_pred) ** 2, dim=-1)
    return 10.0 * torch.log10(signal / err)


def snr_improvement(y: torch.Tensor, y_noisy: torch.Tensor,
                    y_pred: torch.Tensor) -> torch.Tensor:
    """SNR(y, y_pred) − SNR(y, y_noisy), per sample (dB)."""
    return SNR(y, y_pred) - SNR(y, y_noisy)


def PRD(y: torch.Tensor, y_pred: torch.Tensor) -> torch.Tensor:
    """Percentage RMS difference: 100·sqrt(Σ(y − y_pred)² / Σy²)."""
    y, y_pred = _flatten_batch(y), _flatten_batch(y_pred)
    num = torch.sum((y - y_pred) ** 2, dim=-1)
    den = torch.sum(y ** 2, dim=-1)
    return 100.0 * torch.sqrt(num / den)


def second_order_difference_loss(x: torch.Tensor) -> torch.Tensor:
    """Smoothness regulariser: mean |x[t+1] − 2·x[t] + x[t−1]| over time
    (reference local_utils/local_utils.py:717-732)."""
    d2 = x[..., 2:] - 2.0 * x[..., 1:-1] + x[..., :-2]
    return torch.mean(torch.abs(d2))
