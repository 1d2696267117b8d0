"""The classical DWT baseline's evaluation with the port (JAX counterpart:
cli/dwt_dn.py; reference dwt_dn.py).

The same dataset and seed-2023 split as `cli.main` (reference
dwt_dn.py:20-54), db8 soft-threshold wavelet denoising of the test split,
and its mean SNR and RMSE appended to --result_file as
`dwt_{noise}_intensity{k}: snr:..., rmse:...` (reference dwt_dn.py:59-75).
It denoises the whole split at once on the card (`kernels/dwt.py`) and
raises without one; --host takes the numpy path (`baselines/dwt.py`) on
the CPU instead. Example:

    python -m ecg_denoise_tpu_torch.cli.dwt_dn --noise_type_index 0 \\
        --intensity_index 0 --data_path ./data/dict_data
"""

from __future__ import annotations

import numpy as np
import torch


def main(argv=None) -> None:
    from ecg_denoise_tpu_torch import default_device
    from ecg_denoise_tpu_torch.config import build_argparser, config_from_args
    from ecg_denoise_tpu_torch.data.dataset import load_split_arrays
    from ecg_denoise_tpu_torch.metrics import RMSE, SNR
    from ecg_denoise_tpu_torch.utils.compile_cache import enable_compilation_cache

    enable_compilation_cache()
    p = build_argparser(__doc__)
    p.add_argument("--host", action="store_true", help="numpy reference path")
    p.add_argument("--result_file", type=str, default="./dwt_dn_result.txt")
    args = p.parse_args(argv)
    cfg = config_from_args(args)
    device = torch.device("cpu") if args.host else default_device()

    _, _, te_n, te_c = load_split_arrays(
        cfg.noise_name, cfg.noise_intensity, path=cfg.data_path,
        n_select=cfg.n_select, seed=cfg.seed)

    if args.host:
        from ecg_denoise_tpu_torch.baselines.dwt import wavelet_denoise

        den = torch.from_numpy(wavelet_denoise(te_n.astype(np.float64)))
    else:
        from ecg_denoise_tpu_torch.kernels.dwt import wavelet_denoise_device

        den = wavelet_denoise_device(torch.from_numpy(te_n).to(device))
    clean = torch.from_numpy(te_c).to(device)
    den = den.to(device, torch.float32)
    snr = SNR(clean, den).mean().item()
    rmse = RMSE(clean, den).mean().item()
    line = f"dwt_{cfg.noise_name}_intensity{cfg.noise_intensity}: snr:{snr}, rmse:{rmse}"
    print(line)
    with open(args.result_file, "a") as f:
        f.write(line + "\n")


if __name__ == "__main__":
    main()
