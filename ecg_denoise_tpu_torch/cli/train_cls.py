"""Train the downstream N-against-V beat classifier on the card — the
port's counterpart of the JAX package's cli/train_cls.py (reference
train_cls.py:46-77: ResNet_cls, Adam at lr 1e-3, cross-entropy, 20 epochs
at batch 32).

The class splits of the cls cache (`cli.build_data --cls`) go to the card
once; each epoch is `make_cls_epoch_fns`' train_epoch and an eval over the
test split, one line each. The checkpoint (model and Adam state, as
`train.save_checkpoint` writes it) goes to --save. It runs on the card and
raises without one. Example:

    python -m ecg_denoise_tpu_torch.cli.train_cls --epochs 20 --batch_size 32 \\
        --data_path ./data/cls_data
"""

from __future__ import annotations

import argparse

import torch


def main(argv=None, device=None) -> None:
    """The CLI; `device`: where to train (default: the card)."""
    from ecg_denoise_tpu_torch import resolve_device
    from ecg_denoise_tpu_torch.data.cls_cache import load_cls_arrays
    from ecg_denoise_tpu_torch.models import ResNetCls
    from ecg_denoise_tpu_torch.train import (
        create_train_state,
        make_cls_epoch_fns,
        save_checkpoint,
    )
    from ecg_denoise_tpu_torch.utils.compile_cache import enable_compilation_cache
    from ecg_denoise_tpu_torch.utils.seed import random_seed

    enable_compilation_cache()
    p = argparse.ArgumentParser(description=__doc__)
    p.add_argument("--epochs", type=int, default=20)
    p.add_argument("--batch_size", type=int, default=32)
    p.add_argument("--lr", type=float, default=1e-3)
    p.add_argument("--seed", type=int, default=2023)
    p.add_argument("--data_path", type=str, default=None)
    p.add_argument("--save", type=str, default="./model_save/cls_model.pth")
    args = p.parse_args(argv)
    device = resolve_device(device)

    tr_x, tr_y, te_x, te_y = (torch.from_numpy(a).to(device) for a in (
        *load_cls_arrays(train=True, path=args.data_path),
        *load_cls_arrays(train=False, path=args.data_path)))
    random_seed(args.seed)  # the model's initial weights
    state = create_train_state(ResNetCls(), learning_rate=args.lr, device=device)
    train_epoch, eval_epoch = make_cls_epoch_fns(state.model, state.optimizer)
    generator = torch.Generator(device=device).manual_seed(args.seed)  # the permutations
    for epoch in range(args.epochs):
        tm = train_epoch(tr_x, tr_y, generator, args.batch_size)
        em, _ = eval_epoch(te_x, te_y, 128)
        print(f"epoch {epoch + 1:02d}/{args.epochs} "
              f"train_loss={tm['loss']:.4f} train_acc={tm['acc']:.4f} "
              f"test_loss={em['loss']:.4f} test_acc={em['acc']:.4f}")
    save_checkpoint(args.save, state)
    print(f"saved {args.save}")


if __name__ == "__main__":
    main()
