"""Streaming window iterators over long records (JAX counterpart:
data/iterators.py, copied; numpy only).

Equivalents of the reference's record iterators
(reference local_utils/local_utils.py):

* `window_batches`            — `batch_data_iter` (:47-65): paired
  (noisy_record, clean_record) cut into (batch, C, 256) window batches.
* `arrhythmia_window_batches` — `batch_arrythdata_iter` (:68-85): clean
  record + separate noise record mixed per batch at a random alpha.
* `norm_snr_window_batches`   — `batch_norm_snr_iter` (:116-130): per-batch
  z-normalised stretches corrupted at a target SNR.
* `random_alpha_noise_add`    — `ecg_noise_add` (:19-38): a random-type,
  random-offset noise slice scaled by alpha.

Design difference from the reference: iterators yield numpy batches shaped
(batch, C, window) ready for one device_put; nothing is torch-wrapped, and
the duplicated copies in the reference (:158-174, :221-253) collapse into
these single definitions.
"""

from __future__ import annotations

from typing import Iterator, Mapping, Optional

import numpy as np

from ecg_denoise_tpu_torch.data.noise import gnoisegen

WINDOW = 256


def _window(record: np.ndarray, start: int, n: int, window: int) -> np.ndarray:
    """(T, C) record -> (n, C, window) consecutive windows from `start`."""
    seg = record[start : start + n * window]
    return seg.reshape(n, window, -1).transpose(0, 2, 1)


def window_batches(
    noisy_record: np.ndarray,
    clean_record: np.ndarray,
    batch_size: int = 32,
    window: int = WINDOW,
) -> Iterator[tuple]:
    """Yield ((B, C, W) noisy, (B, C, W) clean) aligned window batches."""
    t = min(noisy_record.shape[0], clean_record.shape[0])
    step = batch_size * window
    for i in range(0, t - step + 1, step):
        yield (
            _window(noisy_record, i, batch_size, window).astype(np.float32),
            _window(clean_record, i, batch_size, window).astype(np.float32),
        )


def random_alpha_noise_add(
    data: np.ndarray,
    noises: Mapping[str, np.ndarray],
    alpha: float,
    rng: np.random.Generator,
) -> np.ndarray:
    """Add a random-type, random-offset noise slice scaled by alpha.

    data: (..., C, W) windows; noises: {'bw'|'ma'|'em': (T, C) records}.
    """
    kind = rng.choice(list(noises))
    rec = noises[kind]
    w = data.shape[-1]
    o = int(rng.integers(0, rec.shape[0] - w - 1))
    return data + alpha * rec[o : o + w].T.astype(data.dtype)


def arrhythmia_window_batches(
    clean_record: np.ndarray,
    noises: Mapping[str, np.ndarray],
    batch_size: int = 32,
    window: int = WINDOW,
    alpha_range: tuple = (0.2, 2.0),
    seed: int = 0,
    normalize: bool = False,
) -> Iterator[tuple]:
    """Yield (noisy, clean) batches with per-batch random-alpha corruption.

    normalize=True gives the `batch_norm_arrythdata_iter` variant (:268-282):
    per-window z-norm before mixing.
    """
    rng = np.random.default_rng(seed)
    t = clean_record.shape[0]
    step = batch_size * window
    for i in range(0, t - step + 1, step):
        clean = _window(clean_record, i, batch_size, window).astype(np.float32)
        if normalize:
            m = clean.mean(axis=-1, keepdims=True)
            s = clean.std(axis=-1, keepdims=True)
            clean = (clean - m) / np.where(s > 0, s, 1.0)
        alpha = float(rng.uniform(*alpha_range))
        yield random_alpha_noise_add(clean, noises, alpha, rng), clean


def norm_snr_window_batches(
    clean_record: np.ndarray,
    noise_record: np.ndarray,
    snr_db: float,
    batch_size: int = 32,
    window: int = WINDOW,
    seed: int = 0,
) -> Iterator[tuple]:
    """Yield (noisy, clean): z-normed stretches corrupted at a target SNR."""
    rng = np.random.default_rng(seed)
    t = clean_record.shape[0]
    step = batch_size * window
    max_start = noise_record.shape[0] - step - 1
    if max_start <= 0:
        raise ValueError(
            f"noise record too short: {noise_record.shape[0]} samples < one "
            f"stretch of batch_size*window+2 = {step + 2} — pass a longer "
            "record or a smaller batch_size/window"
        )
    for i in range(0, t - step + 1, step):
        stretch = clean_record[i : i + step].astype(np.float64)
        m = stretch.mean(axis=0, keepdims=True)
        s = stretch.std(axis=0, keepdims=True)
        stretch = (stretch - m) / np.where(s > 0, s, 1.0)
        o = int(rng.integers(0, max_start))
        noisy = gnoisegen(stretch, noise_record[o : o + step], snr_db)[0]
        yield (
            _window(noisy, 0, batch_size, window).astype(np.float32),
            _window(stretch, 0, batch_size, window).astype(np.float32),
        )
