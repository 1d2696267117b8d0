"""SNR-targeted noise mixing (JAX counterpart: data/noise.py; reference
local_utils/local_utils.py:86-114 `Gnoisegen`, :176-192
`single_snr_noise_add`, :194-215 `batch_ecg_noise_add_snr`).

The numpy part, which builds the offline caches, is a copy of the JAX
package's. `snr_noise_add` is the torch counterpart of its on-device mixer
`jax_snr_noise_add`: it runs on the windows' device and draws each
window's noise offset from an explicit `torch.Generator`;
`snr_noise_add_at` is the mixing itself, at given offsets.

Faithfulness notes (documented deviations from reference bugs):
* Reference `Gnoisegen` divides both signal and noise power by `len(x)` of a
  possibly-2D array — the lengths cancel in the scale ratio, so the clean
  energy-ratio formula used here is *mathematically identical*.
* Reference `batch_ecg_noise_add_snr` calls `single_snr_noise_add(data, snr,
  noise)` with swapped args (local_utils.py:210) — a latent bug on a path no
  entry script exercises. We implement the evidently intended behavior
  (noise scaled to hit the target SNR) and do not reproduce the bug.
"""

from __future__ import annotations

import numpy as np
import torch


def _noise_scale(signal_energy, noise_energy, snr_db):
    """Scale s.t. mean(signal^2) / mean((s*noise)^2) == 10^(snr/10)."""
    target_noise_energy = signal_energy / (10.0 ** (snr_db / 10.0))
    return np.sqrt(target_noise_energy / noise_energy)


def gnoisegen(x: np.ndarray, y: np.ndarray, snr: float):
    """Scale noise `y` so `x + noise` has the target SNR (dB).

    Returns (noisy, scaled_noise). Matches reference Gnoisegen
    (local_utils.py:86-114) up to the len() quirk that cancels out.
    """
    signal_energy = np.mean(x.astype(np.float64) ** 2)
    noise_energy = np.mean(y.astype(np.float64) ** 2)
    scale = _noise_scale(signal_energy, noise_energy, snr)
    noise = scale * y
    return x + noise, noise


def single_snr_noise_add(data: np.ndarray, noise: np.ndarray, snr: float) -> np.ndarray:
    """Add `noise` to `data`, scaled to a target SNR in dB.

    Matches reference single_snr_noise_add (local_utils.py:176-192).
    """
    signal_energy = np.mean(np.abs(data.astype(np.float64)) ** 2)
    noise_energy = np.mean(np.abs(noise.astype(np.float64)) ** 2)
    scale = _noise_scale(signal_energy, noise_energy, snr)
    return data + scale * noise


def batch_snr_noise_add(
    data: np.ndarray,
    noise_record: np.ndarray,
    snr: float,
    rng: np.random.Generator,
) -> np.ndarray:
    """Per-window SNR-targeted mixing with random noise offsets.

    data: (B, L, C) clean windows; noise_record: (N, C) long noise record.
    Each window gets an independent random slice of the noise record,
    scaled to the target SNR of *that window* (matching the per-sample
    semantics of reference batch_ecg_noise_add_snr, local_utils.py:194-215,
    with the swapped-arg bug fixed — see module docstring).
    """
    B, L, _ = data.shape
    max_start = noise_record.shape[0] - L - 1
    out = np.empty_like(data, dtype=np.float64)
    for i in range(B):
        start = rng.integers(0, max_start)
        out[i] = single_snr_noise_add(data[i], noise_record[start : start + L], snr)
    return out.astype(data.dtype)


# ---------------------------------------------------------------------------
# On-device mixing, for augmentation inside the training epoch.
# ---------------------------------------------------------------------------


def snr_noise_add_at(data: torch.Tensor, noise_record: torch.Tensor,
                     snr, starts: torch.Tensor) -> torch.Tensor:
    """Each (C, L) window of `data` (B, C, L) plus the slice of
    `noise_record` (N, C) that starts at its entry of `starts` (B,),
    transposed to (C, L), cast to the window's dtype and scaled so that
    the window's mean energy over the noise's is 10^(snr/10): both means
    over the whole (C, L) window, as `jax_snr_noise_add` takes them."""
    L = data.shape[-1]
    rows = starts.to(data.device)[:, None] + torch.arange(L, device=data.device)
    noise = noise_record[rows].transpose(1, 2).to(data.dtype)  # (B, C, L)
    sig_e = torch.mean(data ** 2, dim=(1, 2), keepdim=True)
    noi_e = torch.mean(noise ** 2, dim=(1, 2), keepdim=True)
    scale = torch.sqrt(sig_e / (10.0 ** (snr / 10.0)) / noi_e)
    return data + scale * noise


def snr_noise_add(data: torch.Tensor, noise_record: torch.Tensor, snr,
                  generator: torch.Generator) -> torch.Tensor:
    """`snr_noise_add_at` at offsets drawn from `generator` (on `data`'s
    device), each in [0, N - L - 1), the half-open range of
    `jax_snr_noise_add`'s randint."""
    B, _, L = data.shape
    starts = torch.randint(0, noise_record.shape[0] - L - 1, (B,),
                           generator=generator, device=data.device)
    return snr_noise_add_at(data, noise_record, snr, starts)
