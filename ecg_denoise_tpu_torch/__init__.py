"""ecg_denoise_tpu_torch — the PyTorch/CUDA port of `ecg_denoise_tpu`.

The JAX package beside it stays the reference: each module here mirrors a
module there by path and name, and the tests hold the two against each
other on the same weights and inputs. Plain tensor code is PyTorch; every
Pallas kernel of the JAX package becomes a kernel written by hand for an
NVIDIA Hopper card (`kernels/`).

This package imports torch and numpy only — never jax, flax or
`ecg_denoise_tpu` — and carries its own copies of the framework-free
pieces it needs.

Entry points run on the card: they default to `device="cuda"` and raise
when no card is present. The CPU is used only when the caller asks for it
with `device="cpu"`. On the card, float32 runs in full float32, never TF32
(`full_float32`).
"""

from __future__ import annotations

import torch

from ecg_denoise_tpu_torch.version import __version__  # noqa: F401

MODEL_NAMES = ["unet", "DANet", "ralenet_nra", "ralenet_mlp", "ralenet", "ACDAE"]
NOISE_INTENSITIES = [-4, -2, 0, 2, 4]  # input SNR (dB); reference main.py:26
NOISE_TYPES = ["bw", "ma", "em", "emb"]  # reference main.py:27


def default_device() -> torch.device:
    """The device entry points use when the caller names none: the card.

    Raises instead of falling back to the CPU; pass `device="cpu"` to run
    there on purpose.
    """
    if not torch.cuda.is_available():
        raise RuntimeError(
            "no CUDA device is available; ecg_denoise_tpu_torch runs on the "
            "card by default — pass device='cpu' to run on the CPU")
    return torch.device("cuda")


def full_float32() -> None:
    """Run float32 matmuls and convolutions on the card in full float32.

    PyTorch lets cuDNN run float32 convolutions in TF32 (a 10-bit mantissa)
    unless told otherwise; the port's float32 model is the one held against
    the JAX package and the CPU, so the entry points that put it on the card
    (`models.build_model`, `serving.Denoiser`) call this. The switches are
    process-wide, as PyTorch's are.
    """
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False


def resolve_device(device=None) -> torch.device:
    """`device` as a torch.device, or the default device when None."""
    return default_device() if device is None else torch.device(device)
