"""12-lead transfer learning on the card — the port's counterpart of the
JAX package's cli/transfer_learning.py (reference Transfer_learning.py).

Wraps a frozen pretrained 2-lead RA-LENet core in trainable 12->2->12
lead adapters (`NewRale`) and trains them on the 12-lead ExternalData
cache with the standard loop: the full dataset (no 10k subsample), a
seeded 80/20 split, the core's parameters out of Adam and its BatchNorms
in eval mode.

The core's checkpoint is the latest under --model_save_dir/ralenet (as
`python -m ecg_denoise_tpu_torch.cli.main --model_index 4` writes it, or a
`.msgpack` of the JAX package's); --core_ckpt names another, of either
kind. With none, the core starts from its seeded
initial weights, with a printed warning: the adapters still train. It runs
on the card and raises without one. Example:

    python -m ecg_denoise_tpu_torch.cli.transfer_learning --epochs 10 \\
        --external_path ./ExternalData/dict_data
"""

from __future__ import annotations

import os

import numpy as np
import torch


def main(argv=None) -> None:
    from ecg_denoise_tpu_torch import default_device
    from ecg_denoise_tpu_torch.config import build_argparser, config_from_args
    from ecg_denoise_tpu_torch.data.dataset import EcgDataset
    from ecg_denoise_tpu_torch.models import build_model
    from ecg_denoise_tpu_torch.train import find_model, fit, load_model_weights
    from ecg_denoise_tpu_torch.utils.compile_cache import enable_compilation_cache
    from ecg_denoise_tpu_torch.utils.seed import random_seed

    enable_compilation_cache()
    p = build_argparser(__doc__)
    p.add_argument("--core_ckpt", type=str, default=None)
    p.add_argument("--external_path", type=str, default="./ExternalData/dict_data")
    args = p.parse_args(argv)
    cfg = config_from_args(args)
    device = default_device()

    ds = EcgDataset(cfg.noise_name, cfg.noise_intensity, path=args.external_path)
    noisy = ds.data.astype(np.float32)
    clean = ds.ground_data.astype(np.float32)
    perm = np.random.default_rng(cfg.seed).permutation(len(noisy))
    n_train = int(0.8 * len(noisy))
    tr, te = perm[:n_train], perm[n_train:]

    random_seed(cfg.seed)  # the adapters' initial weights
    dtype = torch.bfloat16 if cfg.dtype == "bfloat16" else torch.float32
    model = build_model("newrale", dtype=dtype, device=device)
    core_path = args.core_ckpt or find_model(
        os.path.join(cfg.model_save_dir, "ralenet"), "ralenet")
    if core_path and os.path.exists(core_path):
        load_model_weights(core_path, model.rale)
        print(f"loaded frozen core from {core_path}")
    else:
        print("WARNING: no pretrained ralenet checkpoint found — the frozen "
              "core starts from init (train one with `python -m "
              "ecg_denoise_tpu_torch.cli.main --model_index 4`)")

    _, hist = fit(
        model, noisy[tr], clean[tr], noisy[te], clean[te],
        epochs=cfg.epochs, batch_size=cfg.batch_size, learning_rate=cfg.lr,
        model_name="newrale", noise_name=cfg.noise_name,
        noise_intensity=cfg.noise_intensity, seed=cfg.seed,
        model_save_dir=cfg.model_save_dir, output_file=cfg.output_file,
        frozen_mask=model.frozen_parameters(), device=device)
    print(f"final test SNR {hist[1][-1]:.3f} dB")


if __name__ == "__main__":
    main()
