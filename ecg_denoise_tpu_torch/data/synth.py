"""Synthetic ECG + noise record generation (JAX counterpart: data/synth.py,
copied because the port imports nothing of that package; numpy only, so a
seed gives the JAX package's records exactly).

The reference trains on MIT-BIH Arrhythmia windows corrupted with MIT-BIH
Noise-Stress-Test records (reference: local_utils/local_utils.py:10-11 paths;
data caches are gitignored and the builder script is absent). PhysioNet data
cannot be downloaded in this environment, so the framework ships a synthetic
generator producing records with the same shapes/conventions:

* ECG records: (650_000, 2) samples at 360 Hz — sum-of-Gaussians PQRST beats
  with RR-interval and amplitude variability per channel.
* Noise records: (650_000, 2) —
    bw: baseline wander (random-phase low-frequency sinusoid mixture),
    ma: muscle artifact (high-frequency filtered white noise, bursty),
    em: electrode motion (random steps + low-freq transients + broadband),
  mirroring the spectral character of the NSTDB bw/ma/em records.

When real PhysioNet files are present, `data.wfdb_io` reads them instead;
the cache builder (`data.cache`) accepts either source.
"""

from __future__ import annotations

import numpy as np

RECORD_LEN = 650_000
FS = 360.0
N_CHANNELS = 2

# (center phase offset in s, width in s, amplitude in mV) for P,Q,R,S,T waves.
_PQRST = [
    (-0.20, 0.025, 0.12),   # P
    (-0.030, 0.010, -0.14), # Q
    (0.000, 0.012, 1.10),   # R
    (0.035, 0.012, -0.25),  # S
    (0.250, 0.050, 0.30),   # T
]

# Ventricular (PVC-like) beat morphology: no P wave, wide bizarre QRS,
# discordant (inverted) T — the textbook V-beat signature the downstream
# N-vs-V classifier (reference train_cls.py / ResNet_cls) discriminates.
_PQRST_V = [
    (-0.010, 0.040, -0.35),  # wide initial deflection
    (0.020, 0.050, 1.40),    # broad dominant R
    (0.090, 0.045, -0.50),   # slurred S
    (0.280, 0.070, -0.45),   # discordant T
]


# Fixed per-lead projection for MULTI-lead (12-lead) records: real ECG
# lead geometry is anatomically FIXED across patients/records (a LUDB lead
# III always has the same polarity convention), so a 12-lead generator must
# NOT redraw channel signs per record — a per-record random sign flip makes
# any shared lead-mixing adapter (the 12->2 frozen-core transfer head,
# reference Transfer_learning.py) mathematically unlearnable. Values chosen
# to span the diversity the old random draw produced, but CONSTANT.
_LEAD_SIGNS = [1.0, 1.0, 0.6, -0.5, 1.0, 0.6, -0.5, 1.0, 0.6, 1.0, -0.5, 0.6]
_LEAD_SCALES = [1.0, 0.9, 1.2, 0.8, 1.1, 0.7, 1.3, 1.0, 0.85, 1.15, 0.75, 1.25]


def synth_ecg_record(seed: int, length: int = RECORD_LEN,
                     n_channels: int = N_CHANNELS,
                     pvc_prob: float = 0.0,
                     fixed_leads: bool = False) -> np.ndarray:
    """Generate a synthetic 2-lead ECG record, shape (length, n_channels).

    pvc_prob > 0 replaces that fraction of beats with ventricular (PVC)
    morphology — real MIT-BIH records contain ectopic beats, and a denoiser
    corpus without them mangles exactly the V beats the downstream N-vs-V
    benchmark classifies (round-2 finding: ralenet reached 18.8 dB on the
    all-sinus corpus yet ~0 dB on V-beat windows). PVC labels and amplitude
    jitters come from a SEPARATE RNG stream so pvc_prob=0.0 reproduces the
    original record byte-for-byte.
    """
    rng = np.random.default_rng(seed)
    t = np.arange(length) / FS
    sig = np.zeros((length, n_channels))

    # Beat times with RR variability around 0.8 s (75 bpm).
    beat_times = []
    tcur = rng.uniform(0.2, 0.8)
    while tcur < t[-1] + 1.0:
        beat_times.append(tcur)
        tcur += rng.normal(0.8, 0.05)
    beat_times = np.asarray(beat_times)

    vrng = np.random.default_rng([seed, 11])
    is_v = (vrng.uniform(size=beat_times.shape) < pvc_prob
            if pvc_prob > 0 else np.zeros(beat_times.shape, bool))

    def add_beats(ch, morph, mask, ch_scale, ch_sign, jit_rng):
        for mu, width, amp in morph:
            amp_jit = amp * ch_scale * ch_sign * jit_rng.uniform(
                0.9, 1.1, size=beat_times.shape
            )
            centers = beat_times + mu
            # Accumulate each beat's Gaussian bump over a local support only.
            half = int(5 * width * FS) + 1
            idx_center = np.round(centers * FS).astype(np.int64)
            for bc, a, use in zip(idx_center, amp_jit, mask):
                if not use:
                    continue
                lo = max(bc - half, 0)
                hi = min(bc + half, length)
                if lo >= hi:
                    continue
                tt = (np.arange(lo, hi) / FS) - (bc / FS)
                sig[lo:hi, ch] += a * np.exp(-0.5 * (tt / width) ** 2)

    for ch in range(n_channels):
        if fixed_leads:
            # Fixed anatomical lead profile (see _LEAD_SIGNS note); the
            # per-record draws are still CONSUMED so the beat-jitter stream
            # stays aligned with the fixed_leads=False layout.
            rng.uniform(0.7, 1.3)
            if ch != 0:
                rng.choice([1.0, 0.6, -0.5])
            ch_scale = _LEAD_SCALES[ch % len(_LEAD_SCALES)]
            ch_sign = _LEAD_SIGNS[ch % len(_LEAD_SIGNS)]
        else:
            ch_scale = rng.uniform(0.7, 1.3)
            ch_sign = 1.0 if ch == 0 else rng.choice([1.0, 0.6, -0.5])
        # N beats draw from the original stream (order preserved: the jitter
        # vector is still drawn for every beat), V beats from vrng.
        add_beats(ch, _PQRST, ~is_v, ch_scale, ch_sign, rng)
        if pvc_prob > 0:
            add_beats(ch, _PQRST_V, is_v, ch_scale, ch_sign, vrng)
    return sig.astype(np.float64)


def synth_ecg_record_annotated(
    seed: int,
    length: int = RECORD_LEN,
    n_channels: int = N_CHANNELS,
    pvc_prob: float = 0.3,
):
    """Synthetic record with PVC (V) beats interspersed among sinus beats.

    Returns (sig (length, C) float64, beat_samples (n,) int64, labels (n,)
    int32 with 0 = N, 1 = V) — the synthetic stand-in for a MIT-BIH record
    plus its .atr beat annotations (reference train_cls.py:17-37 builds the
    N/V beat caches from those annotations). Kept separate from
    `synth_ecg_record` so that function's RNG stream — which the committed
    dict_data caches reproduce — stays byte-stable.
    """
    rng = np.random.default_rng([seed, 7])
    t_end = (length - 1) / FS
    beat_times, labels = [], []
    tcur = rng.uniform(0.2, 0.8)
    while tcur < t_end + 1.0:
        is_v = rng.uniform() < pvc_prob
        beat_times.append(tcur)
        labels.append(1 if is_v else 0)
        # PVCs come early (ectopic) and are followed by a compensatory pause.
        tcur += rng.normal(1.0, 0.06) if is_v else rng.normal(0.8, 0.05)
    beat_times = np.asarray(beat_times)
    labels = np.asarray(labels, np.int32)

    sig = np.zeros((length, n_channels))
    for ch in range(n_channels):
        ch_scale = rng.uniform(0.7, 1.3)
        ch_sign = 1.0 if ch == 0 else rng.choice([1.0, 0.6, -0.5])
        for bt, lab in zip(beat_times, labels):
            morph = _PQRST_V if lab else _PQRST
            for mu, width, amp in morph:
                a = amp * ch_scale * ch_sign * rng.uniform(0.9, 1.1)
                bc = int(round((bt + mu) * FS))
                half = int(5 * width * FS) + 1
                lo, hi = max(bc - half, 0), min(bc + half, length)
                if lo >= hi:
                    continue
                tt = (np.arange(lo, hi) / FS) - (bc / FS)
                sig[lo:hi, ch] += a * np.exp(-0.5 * (tt / width) ** 2)
    beat_samples = np.round(beat_times * FS).astype(np.int64)
    keep = (beat_samples >= 0) & (beat_samples < length)
    return sig.astype(np.float64), beat_samples[keep], labels[keep]


def synth_beat_windows(
    kind: str,
    n: int,
    seed: int,
    n_channels: int = N_CHANNELS,
    window: int = 256,
) -> np.ndarray:
    """Generate n single-beat windows of class 'N' or 'V', shape (n, C, window).

    Each window holds one centred beat (plus partially-visible neighbours at
    +-RR) — the beat-window format of the reference's cls_data caches
    (reference train_cls.py:17-26: {N,V}_{train,test}_data.npy). Neighbours
    are always normal beats (a PVC is an ectopic beat between sinus beats).
    """
    morph = {"N": _PQRST, "V": _PQRST_V}[kind]
    # Deterministic seed derivation: python str hashing is salted per
    # process, so hash((kind, seed)) would make 'seeded' caches differ
    # between runs of the same command.
    rng = np.random.default_rng([seed, *map(ord, kind)])
    t = (np.arange(window) - window // 2) / FS
    out = np.zeros((n, n_channels, window))
    for i in range(n):
        rr = rng.normal(0.8, 0.05)
        for ch in range(n_channels):
            ch_scale = rng.uniform(0.7, 1.3)
            ch_sign = 1.0 if ch == 0 else rng.choice([1.0, 0.6, -0.5])
            sig = np.zeros(window)
            for center, waves in ((0.0, morph), (-rr, _PQRST), (rr, _PQRST)):
                for mu, width, amp in waves:
                    a = amp * ch_scale * ch_sign * rng.uniform(0.9, 1.1)
                    sig += a * np.exp(-0.5 * ((t - center - mu) / width) ** 2)
            out[i, ch] = sig
    return out.astype(np.float32)


def _bandlimited_noise(rng: np.random.Generator, length: int, f_lo: float, f_hi: float) -> np.ndarray:
    """White noise band-passed in the frequency domain (cheap, exact)."""
    x = rng.standard_normal(length)
    X = np.fft.rfft(x)
    freqs = np.fft.rfftfreq(length, d=1.0 / FS)
    mask = (freqs >= f_lo) & (freqs <= f_hi)
    X[~mask] = 0.0
    y = np.fft.irfft(X, n=length)
    s = y.std()
    return y / s if s > 0 else y


def synth_noise_record(kind: str, seed: int, length: int = RECORD_LEN, n_channels: int = N_CHANNELS) -> np.ndarray:
    """Generate a synthetic NSTDB-like noise record, shape (length, n_channels).

    kind: 'bw' | 'ma' | 'em'. Unit variance per channel.
    """
    # Deterministic (unsalted) seed derivation — see synth_beat_windows.
    rng = np.random.default_rng([seed, *map(ord, kind)])
    out = np.zeros((length, n_channels))
    for ch in range(n_channels):
        if kind == "bw":
            # Baseline wander: energy below ~0.7 Hz (respiration-band drifts).
            y = _bandlimited_noise(rng, length, 0.03, 0.7)
        elif kind == "ma":
            # Muscle artifact: broadband 5-120 Hz with burst amplitude modulation.
            y = _bandlimited_noise(rng, length, 5.0, 120.0)
            env = 0.4 + np.clip(_bandlimited_noise(rng, length, 0.02, 0.3), -1.0, 3.0)
            y = y * np.abs(env)
        elif kind == "em":
            # Electrode motion: steps + low-freq transients + some broadband.
            steps = np.zeros(length)
            n_steps = length // 20_000
            pos = rng.integers(0, length, size=n_steps)
            amp = rng.standard_normal(n_steps) * 2.0
            for p, a in zip(pos, amp):
                steps[p:] += a
            steps -= np.linspace(steps[0], steps[-1], length)  # detrend
            y = 0.7 * _bandlimited_noise(rng, length, 0.05, 3.0) + 0.3 * steps / (steps.std() + 1e-9)
        else:
            raise ValueError(f"unknown noise kind {kind!r} (want bw|ma|em)")
        s = y.std()
        out[:, ch] = y / s if s > 0 else y
    return out.astype(np.float64)
