"""The downstream-utility benchmark on the card — the port's counterpart
of the JAX package's cli/test_cls.py (reference test_cls.py:106-255).

The frozen beat classifier (--cls_ckpt, from `cli.train_cls`) classifies
the cls cache's test beats under each condition, in the JAX CLI's order:
clean beats, the noised beats, each denoiser of `MODEL_NAMES` whose
checkpoint `find_model` finds under --model_save_dir/<name>/ (a `.pth` of
the port's or a `.msgpack` of the JAX package's) applied to the noised
beats (on the card, through `build_model` and `load_model_weights`), and the DWT (`kernels.dwt.wavelet_denoise_device`)
and FFT (`baselines.fft`) baselines. One line a condition: accuracy,
precision and F1, class 1 (V) positive. A denoiser without a checkpoint
is skipped with a notice; a missing classifier checkpoint leaves the
classifier untrained with a warning, as the JAX CLI does. It runs on the
card and raises without one. Example:

    python -m ecg_denoise_tpu_torch.cli.test_cls \\
        --cls_ckpt ./model_save/cls_model.pth --data_path ./data/cls_data
"""

from __future__ import annotations

import argparse
import os

import torch


def main(argv=None, device=None) -> None:
    """The CLI; `device`: where to run (default: the card)."""
    from ecg_denoise_tpu_torch import MODEL_NAMES, resolve_device
    from ecg_denoise_tpu_torch.baselines.fft import fft_denoise
    from ecg_denoise_tpu_torch.data.cls_cache import load_cls_arrays
    from ecg_denoise_tpu_torch.kernels.dwt import wavelet_denoise_device
    from ecg_denoise_tpu_torch.metrics import accuracy, f1_score, precision
    from ecg_denoise_tpu_torch.models import ResNetCls, build_model
    from ecg_denoise_tpu_torch.train import (
        create_train_state,
        find_model,
        load_checkpoint,
        load_model_weights,
        make_cls_epoch_fns,
    )
    from ecg_denoise_tpu_torch.utils.compile_cache import enable_compilation_cache
    from ecg_denoise_tpu_torch.utils.seed import random_seed

    enable_compilation_cache()
    p = argparse.ArgumentParser(description=__doc__)
    p.add_argument("--cls_ckpt", type=str, default="./model_save/cls_model.pth")
    p.add_argument("--model_save_dir", type=str, default="./model_save")
    p.add_argument("--data_path", type=str, default=None)
    p.add_argument("--noise_name", type=str, default="emb")
    p.add_argument("--intensity", type=int, default=-4)
    p.add_argument("--batch_size", type=int, default=128)
    args = p.parse_args(argv)
    device = resolve_device(device)

    te_x, te_y = load_cls_arrays(train=False, noised=False, path=args.data_path)
    no_x, _ = load_cls_arrays(train=False, noised=True, path=args.data_path)
    te_x, te_y, no_x = (torch.from_numpy(a).to(device) for a in (te_x, te_y, no_x))

    random_seed(0)  # the untrained classifier's weights, when there is no checkpoint
    cls_state = create_train_state(ResNetCls(), device=device)
    if os.path.exists(args.cls_ckpt):
        cls_state = load_checkpoint(args.cls_ckpt, cls_state)
    else:
        print(f"WARNING: classifier checkpoint {args.cls_ckpt} missing — "
              "using untrained weights (run cli.train_cls first)")
    _, eval_epoch = make_cls_epoch_fns(cls_state.model, cls_state.optimizer)

    def report(name, data):
        _, logits = eval_epoch(data, te_y, args.batch_size)
        a, pr, f1 = (float(m(logits, te_y)) for m in (accuracy, precision, f1_score))
        print(f"{name:24s} acc={a:.4f} precision={pr:.4f} f1={f1:.4f}")

    report("clean", te_x)
    report("noisy", no_x)

    for name in MODEL_NAMES:
        ckpt_dir = os.path.join(args.model_save_dir, name)
        path = find_model(ckpt_dir, name) if os.path.isdir(ckpt_dir) else None
        if not path:
            print(f"{name:24s} (no checkpoint under {ckpt_dir} — skipped)")
            continue
        denoiser = load_model_weights(path, build_model(name, device=device)).eval()
        with torch.no_grad():
            denoised = torch.cat([denoiser(no_x[i:i + args.batch_size]).float()
                                  for i in range(0, no_x.shape[0], args.batch_size)])
        report(name, denoised)

    report("dwt", wavelet_denoise_device(no_x).float())
    report("fft", torch.from_numpy(fft_denoise(no_x.cpu().numpy())).to(device, torch.float32))


if __name__ == "__main__":
    main()
