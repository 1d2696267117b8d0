"""FFT magnitude-threshold denoising baseline (JAX counterpart:
baselines/fft.py, copied; numpy only).

Reimplements the reference `fft_denoise` (reference:
local_utils/denoisefunc.py:36-66). The reference version never imports
fft/ifft (a latent NameError on every call path — test_cls.py:245-248 would
crash); this implementation is the evidently intended behavior, vectorised
over the batch instead of a python loop.
"""

from __future__ import annotations

import numpy as np


def fft_denoise(ecg_datas, threshold: float = 0.04) -> np.ndarray:
    """Zero FFT coefficients with magnitude < threshold * max magnitude.

    Accepts a list of 1-D arrays or an ndarray whose last axis is time;
    thresholds each 1-D signal independently (per-row max, matching the
    reference's per-signal loop).
    """
    x = np.asarray(ecg_datas, dtype=np.float64)
    X = np.fft.fft(x, axis=-1)
    mag = np.abs(X)
    cutoff = threshold * mag.max(axis=-1, keepdims=True)
    X = np.where(mag < cutoff, 0.0, X)
    return np.fft.ifft(X, axis=-1).real
