"""Dataset loading and the deterministic subsample and split (JAX
counterpart: data/dataset.py, copied because the port imports nothing of
that package; reference local_utils/data_utils.py:88-117, main.py:50-60).

numpy and python `random` only, so the same seed gives the JAX package's
indices exactly. `load_split_arrays` returns whole train/test splits as
contiguous float32 arrays, which the training loop puts on the card once.
"""

from __future__ import annotations

import json
import os
import random

import numpy as np

INTENSITY_DIRS = {-4: "m4", -2: "m2", 0: "0", 2: "p2", 4: "p4"}


class EcgDataset:
    """The dict_data cache: `{path}/ecg.npy` (clean windows) and
    `{path}/{intensity dir}/{noise}.npy` (noisy windows), each (N, C, L).

    noise_name: str or list of str in {'bw', 'ma', 'em', 'emb'};
    noise_intensity: int in {-4, -2, 0, 2, 4}; path: the cache directory
    (default: ./data/dict_data/). Unlike the reference, no directory above
    the working one is searched: a missing cache raises.
    """

    def __init__(self, noise_name="bw", noise_intensity=0, path: str | None = None):
        if isinstance(noise_name, str):
            noise_name = [noise_name]
        if noise_intensity not in INTENSITY_DIRS:
            raise ValueError("noise intensity should be in [-4, -2, 0, 2, 4]")
        if path is None:
            path = "./data/dict_data/"
        if not os.path.exists(path):
            raise FileNotFoundError(
                "dict_data cache not found; build it with `python -m "
                "ecg_denoise_tpu_torch.cli.build_data`, or pass --data_path")
        self.data = np.concatenate([
            np.load(os.path.join(path, INTENSITY_DIRS[noise_intensity], n + ".npy"))
            for n in noise_name], axis=0)
        ground = np.load(os.path.join(path, "ecg.npy"))
        # Tile the clean windows to stay index-aligned with the k-fold noisy
        # concatenation.
        if len(noise_name) > 1:
            ground = np.tile(ground, (len(noise_name), 1, 1))
        self.ground_data = ground

    def __len__(self):
        return self.data.shape[0]

    def __getitem__(self, index):
        return self.data[index], self.ground_data[index]


def sample_and_split(n_total: int, n_select: int = 10_000,
                     train_ratio: float = 0.8, seed: int = 2023):
    """The reference's `random.sample(range(N), n_select)` with its seed,
    then a seeded numpy permutation for the train/test split."""
    n_select = min(n_select, n_total)
    rnd = random.Random()
    rnd.seed(seed)
    selected = np.asarray(rnd.sample(range(n_total), n_select))
    perm = np.random.default_rng(seed).permutation(n_select)
    n_train = int(train_ratio * n_select)
    return selected[perm[:n_train]], selected[perm[n_train:]]


def resolve_split(n_total: int, n_select: int = 10_000, seed: int = 2023,
                  split_file: str | None = None):
    """Train/test indices, optionally pinned to `split_file` (JSON
    {"train": [...], "test": [...]}): read if it exists, else computed by
    `sample_and_split` and saved there."""
    if split_file and os.path.exists(split_file):
        with open(split_file) as f:
            d = json.load(f)
        tr, te = np.asarray(d["train"], np.int64), np.asarray(d["test"], np.int64)
        both = np.concatenate([tr, te])
        if both.size and (both.min() < 0 or both.max() >= n_total):
            raise ValueError(
                f"split file {split_file} holds out-of-range indices for this "
                f"dataset ({n_total} windows) — built for a different cache?")
        return tr, te
    tr, te = sample_and_split(n_total, n_select, seed=seed)
    if split_file:
        os.makedirs(os.path.dirname(os.path.abspath(split_file)), exist_ok=True)
        with open(split_file, "w") as f:
            json.dump({"train": tr.tolist(), "test": te.tolist()}, f)
    return tr, te


def load_split_arrays(noise_name="bw", noise_intensity=0, path: str | None = None,
                      n_select: int = 10_000, seed: int = 2023,
                      split_file: str | None = None):
    """(train_noisy, train_clean, test_noisy, test_clean) float32 arrays,
    each (N, C, L)."""
    ds = EcgDataset(noise_name, noise_intensity, path)
    tr_idx, te_idx = resolve_split(len(ds), n_select, seed=seed,
                                   split_file=split_file)
    noisy = ds.data.astype(np.float32)
    clean = ds.ground_data.astype(np.float32)
    return noisy[tr_idx], clean[tr_idx], noisy[te_idx], clean[te_idx]
