"""Classical DWT denoising baseline (db8, soft threshold) — dependency-free
(JAX counterpart: baselines/dwt.py, copied because the port imports nothing
of that package; numpy only).

Reimplements the reference's `wavelet_denoise` (reference:
local_utils/denoisefunc.py:7-33): db8 wavelet decomposition to the maximum
level, soft-threshold every detail band at 0.04 * max(band), reconstruct.
`pywt` is not available in this environment, so the Daubechies filters are
generated numerically (spectral factorization of the Daubechies half-band
polynomial — the same construction pywt's tables come from) and
wavedec/waverec follow pywt's 'symmetric' mode conventions exactly
(extension by dec_len-1, downsample offset 1, waverec approx-truncation).

Faithfulness notes:
* The reference thresholds at `0.04 * max(coeffs[i])` — max, NOT max(abs).
  Reproduced exactly (including the negative-threshold edge case, via
  pywt's soft-threshold formula).
* The reference's companion `fft_denoise` has a missing-import bug; see
  baselines/fft.py.
"""

from __future__ import annotations

from functools import lru_cache

import numpy as np


@lru_cache(maxsize=None)
def daubechies_filters(n_moments: int):
    """Generate Daubechies (extremal-phase) filters with N vanishing moments.

    Returns (dec_lo, dec_hi, rec_lo, rec_hi), each length 2N, matching
    pywt's dbN filter bank (pywt conventions: dec_lo = rec_lo[::-1],
    rec_hi = qmf(rec_lo), dec_hi = rec_hi[::-1]).

    Construction: roots of the binomial half-band polynomial
    P(y) = sum_k C(N-1+k, k) y^k mapped to z-plane via 4y = 2 - z - 1/z,
    keeping roots inside the unit circle (minimum phase), times (1+z)^N.
    """
    N = n_moments
    # P(y) coefficients, ascending powers.
    p = np.ones(N)
    for k in range(1, N):
        p[k] = p[k - 1] * (N - 1 + k) / k  # C(N-1+k, k)
    yroots = np.roots(p[::-1])  # np.roots wants descending powers

    zroots = []
    for y in yroots:
        # z^2 - (2 - 4y) z + 1 = 0
        b = 2.0 - 4.0 * y
        disc = np.sqrt(b * b - 4.0 + 0j)
        z1, z2 = (b + disc) / 2.0, (b - disc) / 2.0
        zroots.append(z1 if abs(z1) < 1.0 else z2)

    # h(z) = (1+z)^N * prod (z - z_r), normalized to sum = sqrt(2).
    h = np.array([1.0 + 0j])
    for _ in range(N):
        h = np.convolve(h, [1.0, 1.0])
    for zr in zroots:
        h = np.convolve(h, [1.0, -zr])
    h = np.real(h)
    h *= np.sqrt(2.0) / h.sum()

    rec_lo = h
    dec_lo = rec_lo[::-1].copy()
    L = len(rec_lo)
    rec_hi = np.array([(-1) ** k * rec_lo[L - 1 - k] for k in range(L)])
    dec_hi = rec_hi[::-1].copy()
    return dec_lo, dec_hi, rec_lo, rec_hi


def dwt_max_level(data_len: int, filter_len: int) -> int:
    """pywt.dwt_max_level: floor(log2(data_len / (filter_len - 1)))."""
    if data_len < filter_len - 1:
        return 0
    return int(np.log2(data_len / (filter_len - 1.0)))


def _dwt_single(x: np.ndarray, dec_lo: np.ndarray, dec_hi: np.ndarray):
    """One analysis step, pywt 'symmetric' mode: returns (cA, cD)."""
    F = len(dec_lo)
    ext = np.pad(x, F - 1, mode="symmetric")
    cA = np.convolve(ext, dec_lo, mode="valid")[1::2]
    cD = np.convolve(ext, dec_hi, mode="valid")[1::2]
    return cA, cD


def _idwt_single(cA: np.ndarray, cD: np.ndarray, rec_lo: np.ndarray, rec_hi: np.ndarray):
    """One synthesis step; output length 2*len(cA) - F + 2 (pywt symmetric)."""
    F = len(rec_lo)
    upA = np.zeros(2 * len(cA) - 1)
    upA[::2] = cA
    upD = np.zeros(2 * len(cD) - 1)
    upD[::2] = cD
    y = np.convolve(upA, rec_lo) + np.convolve(upD, rec_hi)
    crop = F - 2
    return y[crop : len(y) - crop] if crop > 0 else y


def wavedec(x: np.ndarray, n_moments: int = 8, level: int | None = None):
    """Multi-level analysis; returns [cA_n, cD_n, ..., cD_1] like pywt.wavedec."""
    dec_lo, dec_hi, _, _ = daubechies_filters(n_moments)
    if level is None:
        level = dwt_max_level(len(x), len(dec_lo))
    coeffs = []
    a = np.asarray(x, dtype=np.float64)
    for _ in range(level):
        a, d = _dwt_single(a, dec_lo, dec_hi)
        coeffs.append(d)
    coeffs.append(a)
    return coeffs[::-1]


def waverec(coeffs, n_moments: int = 8) -> np.ndarray:
    """Multi-level synthesis matching pywt.waverec (with approx truncation)."""
    _, _, rec_lo, rec_hi = daubechies_filters(n_moments)
    a = coeffs[0]
    for d in coeffs[1:]:
        if len(a) == len(d) + 1:
            a = a[:-1]
        a = _idwt_single(a, d, rec_lo, rec_hi)
    return a


def _soft_threshold(data: np.ndarray, value: float) -> np.ndarray:
    """pywt.threshold(..., mode='soft'): sign(x) * max(|x| - value, 0)."""
    mag = np.abs(data)
    with np.errstate(divide="ignore", invalid="ignore"):
        out = np.where(mag > 0, data / mag, 0.0) * np.maximum(mag - value, 0.0)
    return out


def wavelet_denoise(ecg_data: np.ndarray, threshold: float = 0.04, n_moments: int = 8) -> np.ndarray:
    """db8 soft-threshold denoiser, matching reference denoisefunc.py:7-33.

    2-D input: rows are independent 1-D signals. 3-D input: recurse over the
    leading dim. Threshold per detail band = `threshold * max(band)` (max,
    not max-abs — reference quirk preserved).
    """
    ecg_data = np.asarray(ecg_data)
    if ecg_data.ndim == 2:
        out = []
        for row in ecg_data:
            coeffs = wavedec(row, n_moments)
            for i in range(1, len(coeffs)):
                coeffs[i] = _soft_threshold(coeffs[i], threshold * np.max(coeffs[i]))
            out.append(waverec(coeffs, n_moments))
        return np.array(out)
    elif ecg_data.ndim == 3:
        return np.array([wavelet_denoise(d, threshold, n_moments) for d in ecg_data])
    raise ValueError("expected 2-D or 3-D input")
