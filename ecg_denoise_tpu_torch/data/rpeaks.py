"""R-peak detection for the R-wave attention bias (JAX counterpart:
data/rpeaks.py).

The reference's RelativePositionEmbedding takes an R-peak position to
centre its window on (reference model/transformer.py:540-543), but no
entry script of the reference supplies one. `detect_r_peaks` does, for a
batch of windows at once, with the JAX package's matched filter, step for
step:

* the lead mean, in float32;
* drift removal: minus an edge-padded moving average of max(int(fs/5), 5)
  taps (72 at 360 Hz);
* a Mexican-hat matched filter (sigma 0.012·fs, half-width int(4·sigma),
  unit norm) on the edge-padded result, squared;
* an edge guard of min(16, L//8) samples at each end, where padding
  inflates the response under noise;
* the position of the first maximum.

Batched plain PyTorch (`F.conv1d` is a correlation, like JAX's
`conv_general_dilated`); it runs on the windows' device.
"""

from __future__ import annotations

import torch
import torch.nn.functional as F


def _correlate(x: torch.Tensor, taps: torch.Tensor, pad: tuple) -> torch.Tensor:
    """(B, L) rows, edge-padded by `pad`, correlated with `taps`."""
    xp = F.pad(x[:, None], pad, mode="replicate")
    return F.conv1d(xp, taps.reshape(1, 1, -1))[:, 0]


def detect_r_peaks(windows: torch.Tensor, fs: float = 360.0) -> torch.Tensor:
    """(B, C, L) windows -> (B,) int64 positions of the dominant R peak."""
    x = windows.float().mean(dim=1)  # (B, L)
    w = max(int(fs / 5.0), 5)
    box = torch.ones(w, device=x.device) / w
    xc = x - _correlate(x, box, (w // 2, w - 1 - w // 2))
    s = 0.012 * fs  # QRS half-width in samples
    half = int(4 * s)
    t = torch.arange(-half, half + 1, dtype=torch.float32, device=x.device)
    ts = t / torch.full_like(t, s)  # a float32 division, as in JAX
    hat = (1 - ts ** 2) * torch.exp(-0.5 * ts ** 2)
    hat = hat / torch.linalg.vector_norm(hat)
    energy = _correlate(xc, hat, (half, half)) ** 2
    L = x.shape[-1]
    guard = min(16, L // 8)
    energy[:, :guard] = 0.0
    energy[:, L - guard:] = 0.0
    return torch.argmax(energy, dim=-1)  # the first maximum, as jnp.argmax
