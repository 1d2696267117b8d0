"""Beat-classification (N vs V) cache builder + loader (JAX counterpart:
data/cls_cache.py, copied; numpy only, so the same arguments give the JAX
package's files byte for byte).

The reference's downstream-utility benchmark consumes pre-built caches at
data/cls_data/{N,V}_{train,test}_data.npy plus noised_* variants
(reference train_cls.py:17-37, test_cls.py:32-57), whose builder script is
absent from the repo. This module reconstructs it:

* beat windows are cut from CONTINUOUS annotated records run through the
  same stretch-normalise + stretch-corrupt pipeline as the denoiser corpus
  (see build_cls_data docstring) — synthetic N/V records here
  (synth.synth_ecg_record_annotated); real MIT-BIH .atr annotations via
  wfdb_io when PhysioNet files are present;
* the noised_* variants mix combined bw+ma+em ('emb') noise at −4 dB — the
  condition whose denoiser checkpoints test_cls loads
  (reference test_cls.py:78-104: *_99_emb_intensity-4.pth).

Loader returns whole (data, label) arrays — labels 0 = N, 1 = V, N first
(matching the reference's concatenate order, train_cls.py:20-21) — ready
for a single device_put.
"""

from __future__ import annotations

import os

import numpy as np

from ecg_denoise_tpu_torch.data import synth
from ecg_denoise_tpu_torch.data.noise import gnoisegen

FILES = {
    (False, True): ("N_train_data.npy", "V_train_data.npy"),
    (False, False): ("N_test_data.npy", "V_test_data.npy"),
    (True, True): ("noised_N_train_data.npy", "noised_V_train_data.npy"),
    (True, False): ("noised_N_test_data.npy", "noised_V_test_data.npy"),
}


# Single source: the whole point of this cache is distribution alignment
# with the dict_data pipeline, so its window/stretch geometry must be the
# SAME constants — a silent divergence here regresses the downstream-
# utility benchmark to its round-1 degenerate state.
from ecg_denoise_tpu_torch.data.cache import STRETCH_WINDOWS, WINDOW

STRETCH = WINDOW * STRETCH_WINDOWS  # the dict_data stretch length


def _annotated_records(data_root, seed: int):
    """Yield (sig (T, 2) float64, beat_samples, labels 0=N/1=V).

    Real MIT-BIH records + .atr annotations when present under data_root
    (reference train_cls.py:17-37 derives cls_data from those); otherwise an
    endless stream of synthetic annotated records.
    """
    from ecg_denoise_tpu_torch.data import wfdb_io

    used_real = False
    if data_root:
        arr_dir = os.path.join(data_root, "mit-bih-arrhythmia-database-1.0.0")
        if os.path.isdir(arr_dir):
            for rid in wfdb_io.MITBIH_RECORDS:
                p = os.path.join(arr_dir, str(rid))
                if os.path.exists(p + ".hea") and os.path.exists(p + ".atr"):
                    sig = wfdb_io.rdrecord_digital(p).astype(np.float64)
                    samples, syms = wfdb_io.rdann(p)
                    labels = np.asarray(
                        [0 if s == "N" else 1 if s == "V" else -1 for s in syms],
                        np.int32,
                    )
                    keep = labels >= 0
                    used_real = True
                    yield sig, samples[keep], labels[keep]
    if not used_real:
        i = 0
        while True:
            yield synth.synth_ecg_record_annotated(seed + 500 + i)
            i += 1


def build_cls_data(
    out_dir: str,
    n_train: int = 2048,
    n_test: int = 512,
    seed: int = 2023,
    noise_snr_db: float = -4.0,
    data_root: str | None = None,
) -> dict:
    """Build the cls_data cache, distribution-aligned with dict_data.

    Round-1 built isolated per-window-normalised beats while the denoisers
    train on stretch-normalised continuous rhythm — a distribution gap that
    made the downstream-utility benchmark degenerate (denoised ~= noisy
    accuracy; VERDICT round-1 item 2). Now beat windows are cut from
    continuous annotated records processed EXACTLY like the denoiser
    corpus: 32-window stretches, per-channel z-norm over the stretch
    (reference np_norm, local_utils.py:261-266), whole-stretch 'emb'
    corruption at the target SNR (Gnoisegen, :86-114) — so the noisy beat
    windows are drawn from the same distribution the denoisers were trained
    on, and clean/noisy pairs stay sample-aligned.
    """
    from ecg_denoise_tpu_torch.data.cache import load_source_records

    rng = np.random.default_rng(seed)
    # Real NSTDB noise records when present, else synthetic (same fallback
    # as the dict_data builder).
    _, noises = load_source_records(data_root, n_synth_records=0, seed=seed)
    max_start = min(n.shape[0] for n in noises.values()) - STRETCH - 1

    need = {0: n_train + n_test, 1: n_train + n_test}
    got = {0: [], 1: []}  # label -> list of (clean (C,W), noisy (C,W))
    records = _annotated_records(data_root, seed)
    for sig, beats, labels in records:
        if all(len(got[k]) >= need[k] for k in (0, 1)):
            break
        for s0 in range(0, sig.shape[0] - STRETCH + 1, STRETCH):
            stretch = sig[s0 : s0 + STRETCH]
            m = stretch.mean(axis=0, keepdims=True)
            sd = stretch.std(axis=0, keepdims=True)
            clean = (stretch - m) / np.where(sd > 0, sd, 1.0)
            mix = sum(
                noises[k][(o := rng.integers(0, max_start)) : o + STRETCH]
                for k in ("bw", "ma", "em")
            )
            noisy = gnoisegen(clean, mix, noise_snr_db)[0]
            half = WINDOW // 2
            in_stretch = (beats >= s0 + half) & (beats < s0 + STRETCH - half)
            for r, lab in zip(beats[in_stretch], labels[in_stretch]):
                lo = r - s0 - half
                got[int(lab)].append(
                    (clean[lo : lo + WINDOW].T.astype(np.float32),
                     noisy[lo : lo + WINDOW].T.astype(np.float32))
                )

    short = {k: need[k] - len(got[k]) for k in (0, 1) if len(got[k]) < need[k]}
    if short:
        raise ValueError(
            f"annotated records exhausted before filling the cache: short by "
            f"{short} beat windows — lower n_train/n_test or add records"
        )
    os.makedirs(out_dir, exist_ok=True)
    counts = {}
    for ki in (0, 1):
        perm = rng.permutation(len(got[ki]))
        sel = [got[ki][p] for p in perm[: need[ki]]]
        cl = np.stack([c for c, _ in sel])
        no = np.stack([n for _, n in sel])
        for train, sl in ((True, slice(0, n_train)),
                          (False, slice(n_train, n_train + n_test))):
            cf = FILES[(False, train)][ki]
            nf = FILES[(True, train)][ki]
            np.save(os.path.join(out_dir, cf), cl[sl])
            np.save(os.path.join(out_dir, nf), no[sl])
            counts[cf] = sl.stop - sl.start
    return {"out_dir": out_dir, **counts}


def load_cls_arrays(train: bool = True, noised: bool = False, path: str | None = None):
    """Return (data (N, 2, 256) float32, label (N,) int32), N beats first.

    path: the cache directory (default: ./data/cls_data). As in the port's
    dict_data loader, no directory above the working one is searched: a
    missing cache raises.
    """
    if path is None:
        path = "./data/cls_data"
    if not os.path.isdir(path):
        raise FileNotFoundError(
            "cls_data cache not found; build it with `python -m "
            "ecg_denoise_tpu_torch.cli.build_data --cls`, or pass its path"
        )
    nf, vf = FILES[(noised, train)]
    n_data = np.load(os.path.join(path, nf)).astype(np.float32)
    v_data = np.load(os.path.join(path, vf)).astype(np.float32)
    data = np.concatenate([n_data, v_data], axis=0)
    label = np.concatenate(
        [np.zeros(len(n_data), np.int32), np.ones(len(v_data), np.int32)]
    )
    return data, label
