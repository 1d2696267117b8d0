"""Denoiser training on the card — the port's counterpart of the JAX
package's cli/main.py (reference main.py:24-87).

Seed 2023, (noise type, intensity, model) picked by index, a 10k-window
subsample of the dict_data cache split 80/20, Adam/MSE training with the
splits on the card, a checkpoint every 10 epochs and the output.txt result
line. It runs on the card and raises without one. Every --model_index
trains (0 unet, the default; 1 DANet; 2-4 the RA-LENet family; 5 ACDAE).
`--r_pos detect` centres each window's R-wave attention bias on its own
detected R peak (RaleNet family; printed and ignored for the others).
Example:

    python -m ecg_denoise_tpu_torch.cli.main --model_index 4 \\
        --noise_type_index 0 --intensity_index 0 --data_path ./data/dict_data \\
        --r_pos detect
"""

from __future__ import annotations

import torch

# The models that take r_pos (JAX counterpart: cli/main.py:79).
_RALE = {"ralenet", "ralenet_mlp", "ralenet_nra"}


def main(argv=None) -> None:
    from ecg_denoise_tpu_torch import default_device
    from ecg_denoise_tpu_torch.config import build_argparser, config_from_args
    from ecg_denoise_tpu_torch.data.dataset import load_split_arrays
    from ecg_denoise_tpu_torch.models import build_model
    from ecg_denoise_tpu_torch.train import fit
    from ecg_denoise_tpu_torch.utils.seed import random_seed

    args = build_argparser(__doc__).parse_args(argv)
    cfg = config_from_args(args)
    for k, v in vars(args).items():
        print(k, v)
    device = default_device()

    tr_n, tr_c, te_n, te_c = load_split_arrays(
        cfg.noise_name, cfg.noise_intensity, path=cfg.data_path,
        n_select=cfg.n_select, seed=cfg.seed, split_file=cfg.split_file)
    random_seed(cfg.seed)  # the model's initial weights
    dtype = torch.bfloat16 if cfg.dtype == "bfloat16" else torch.float32
    model = build_model(cfg.model_index, dtype=dtype, device=device)
    r_pos_mode = cfg.r_pos
    if r_pos_mode and cfg.model_name not in _RALE:
        print(f"--r_pos is RaleNet-family only; ignored for {cfg.model_name}")
        r_pos_mode = None
    fit(model, tr_n, tr_c, te_n, te_c,
        epochs=cfg.epochs, batch_size=cfg.batch_size, learning_rate=cfg.lr,
        model_name=cfg.model_name, noise_name=cfg.noise_name,
        noise_intensity=cfg.noise_intensity, seed=cfg.seed,
        model_save_dir=cfg.model_save_dir, output_file=cfg.output_file,
        r_pos_mode=r_pos_mode, device=device)


if __name__ == "__main__":
    main()
