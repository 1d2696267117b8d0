"""dict_data cache builder — reconstructs the reference's missing build step
(JAX counterpart: data/cache.py, copied; numpy only, so the same arguments
give the JAX package's files byte for byte).

The reference ships only the cache *loader* (reference:
local_utils/data_utils.py:88-117): pre-built `.npy` files laid out as

    data/dict_data/{m4,m2,0,p2,p4}/{bw,ma,em,emb}.npy   (noisy windows)
    data/dict_data/ecg.npy                              (clean windows)

with (N, 2, 256) float windows, index-aligned across files. The builder
script is absent from the repo (data/ is gitignored), so this module
reconstructs it from the reference's mixing iterators (reference:
local_utils/local_utils.py:116-130 `batch_norm_snr_iter`): records are cut
into stretches of 256*batch_size samples, z-normalised per channel over the
stretch (np_norm, local_utils.py:261-266), corrupted with an SNR-targeted
random slice of the noise record (Gnoisegen, :86-114), then windowed at
stride 256. 'emb' mixes all three NSTDB noise types (bw+ma+em summed, then
scaled to the target SNR) per the noise_type list semantics (main.py:27).

Sources: real PhysioNet files via `wfdb_io` when present, else the synthetic
generator (`synth`), keeping the whole framework runnable offline.
"""

from __future__ import annotations

import os

import numpy as np

from ecg_denoise_tpu_torch import NOISE_TYPES  # single source
from ecg_denoise_tpu_torch.data import synth, wfdb_io
from ecg_denoise_tpu_torch.data.dataset import INTENSITY_DIRS
from ecg_denoise_tpu_torch.data.noise import gnoisegen

WINDOW = 256
STRETCH_WINDOWS = 32  # batch_size in the reference iterator (256*32 stretches)


def _znorm(x: np.ndarray) -> np.ndarray:
    """Per-channel z-norm over axis 0 (reference np_norm, local_utils.py:261-266)."""
    m = x.mean(axis=0, keepdims=True)
    x = x - m
    return x / x.std(axis=0, keepdims=True)


def load_source_records(data_root: str | None, n_synth_records: int, seed: int,
                        n_channels: int = 2, pvc_prob: float = 0.0):
    """Return (list of ecg records (T,2), dict of noise records (T,2)).

    Prefers real PhysioNet directories (mit-bih-arrhythmia / noise-stress-test
    at the reference's expected paths under `data_root`); falls back to
    synthetic records.
    """
    ecgs, noises = [], {}
    if data_root and n_channels == 2:
        arr_dir = os.path.join(data_root, "mit-bih-arrhythmia-database-1.0.0")
        nst_dir = os.path.join(data_root, "mit-bih-noise-stress-test-database-1.0.0")
        if os.path.isdir(arr_dir) and os.path.isdir(nst_dir):
            for rid in wfdb_io.MITBIH_RECORDS:
                p = os.path.join(arr_dir, str(rid))
                if os.path.exists(p + ".hea"):
                    ecgs.append(wfdb_io.rdrecord_digital(p).astype(np.float64))
            for kind in wfdb_io.NSTDB_NOISE_RECORDS:
                p = os.path.join(nst_dir, kind)
                if os.path.exists(p + ".hea"):
                    noises[kind] = wfdb_io.rdrecord_digital(p).astype(np.float64)
    if not ecgs or len(noises) < 3:
        ecgs = [
            # Multi-lead records use the FIXED anatomical lead profile —
            # per-record random lead signs make the 12->2 transfer adapter
            # unlearnable (synth._LEAD_SIGNS rationale).
            synth.synth_ecg_record(seed + i, n_channels=n_channels,
                                   pvc_prob=pvc_prob,
                                   fixed_leads=(n_channels > 2))
            for i in range(n_synth_records)
        ]
        noises = {
            k: synth.synth_noise_record(k, seed + 1000, n_channels=n_channels)
            for k in ("bw", "ma", "em")
        }
    return ecgs, noises


def build_dict_data(
    out_dir: str,
    data_root: str | None = None,
    n_synth_records: int = 8,
    seed: int = 2023,
    intensities=(-4, -2, 0, 2, 4),
    n_channels: int = 2,
    pvc_prob: float = 0.15,
) -> dict:
    """Build the dict_data cache. Returns {'n_windows': N, 'out_dir': ...}.

    n_channels=12 builds the 12-lead (LUDB-like) ExternalData cache the
    transfer-learning path consumes (reference Transfer_learning.py:47).

    pvc_prob: fraction of synthetic beats given ventricular (PVC)
    morphology, mirroring real MIT-BIH records' natural ectopy — the
    denoiser corpus must cover the V beats the downstream benchmark
    classifies (no effect when real records are used).
    """
    rng = np.random.default_rng(seed)
    ecgs, noises = load_source_records(data_root, n_synth_records, seed,
                                       n_channels, pvc_prob=pvc_prob)

    stretch = WINDOW * STRETCH_WINDOWS
    clean_stretches = []
    for sig in ecgs:
        t = sig.shape[0]
        for i in range(0, t - stretch + 1, stretch):
            clean_stretches.append(_znorm(sig[i : i + stretch]))
    clean = np.stack(clean_stretches)  # (S, stretch, 2)
    S = clean.shape[0]

    def windows(x):  # (S, stretch, C) -> (S*STRETCH_WINDOWS, C, WINDOW)
        s, t, c = x.shape
        return (
            x.reshape(s, t // WINDOW, WINDOW, c)
            .transpose(0, 1, 3, 2)
            .reshape(-1, c, WINDOW)
            .astype(np.float32)
        )

    os.makedirs(out_dir, exist_ok=True)
    np.save(os.path.join(out_dir, "ecg.npy"), windows(clean))

    max_start = min(n.shape[0] for n in noises.values()) - stretch - 1
    for intensity in intensities:
        d = os.path.join(out_dir, INTENSITY_DIRS[intensity])
        os.makedirs(d, exist_ok=True)
        for ntype in NOISE_TYPES:
            noisy = np.empty_like(clean)
            for s in range(S):
                if ntype == "emb":
                    mix = sum(
                        noises[k][(o := rng.integers(0, max_start)) : o + stretch]
                        for k in ("bw", "ma", "em")
                    )
                else:
                    o = rng.integers(0, max_start)
                    mix = noises[ntype][o : o + stretch]
                noisy[s] = gnoisegen(clean[s], mix, intensity)[0]
            np.save(os.path.join(d, ntype + ".npy"), windows(noisy))

    return {"n_windows": S * STRETCH_WINDOWS, "out_dir": out_dir}
