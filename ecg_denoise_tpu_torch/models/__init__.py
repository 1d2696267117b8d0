"""Model registry (JAX counterpart: models/__init__.py; reference
main.py:28,63-80). Every denoiser of the JAX package:

    index 0: 'unet'         -> UNet
    index 1: 'DANet'        -> Seq2Seq2 (the DACNN dual-attention family)
    index 2: 'ralenet_nra'  -> RaleNet(variant='nra')
    index 3: 'ralenet_mlp'  -> RaleNet(variant='mlp')
    index 4: 'ralenet'      -> RaleNet(variant='full')
    index 5: 'ACDAE'        -> ACDAE
    'newrale' (no index)    -> NewRale, the 12-lead transfer wrapper

The classifiers `ResNetCls` (the beat classifier of the downstream-utility
benchmark) and `Transformer1d` are exported beside them and, as in the JAX
package, stay out of `build_model`.
"""

from __future__ import annotations

from typing import Optional

import torch

from ecg_denoise_tpu_torch import MODEL_NAMES, full_float32, resolve_device
from ecg_denoise_tpu_torch.models.acdae import ACDAE
from ecg_denoise_tpu_torch.models.dam import Seq2Seq2
from ecg_denoise_tpu_torch.models.ralenet import RaleNet
from ecg_denoise_tpu_torch.models.ralenet_12leads import NewRale
from ecg_denoise_tpu_torch.models.resnet_cls import Bottleneck1d, ResNetCls
from ecg_denoise_tpu_torch.models.transformer1d import Transformer1d
from ecg_denoise_tpu_torch.models.unet import UNet

_BUILDERS = {
    "unet": UNet,
    "DANet": Seq2Seq2,
    "ralenet_nra": lambda dtype: RaleNet(variant="nra", dtype=dtype),
    "ralenet_mlp": lambda dtype: RaleNet(variant="mlp", dtype=dtype),
    "ralenet": lambda dtype: RaleNet(variant="full", dtype=dtype),
    "ACDAE": ACDAE,
    # Not in the reference's index dispatch (its Transfer_learning.py
    # builds it directly); named so that serving loads its checkpoints.
    "newrale": NewRale,
}


def apply(model: torch.nn.Module, x: torch.Tensor,
          r_pos: Optional[torch.Tensor] = None) -> torch.Tensor:
    """model(x), with `r_pos` only when it is set (only RA-LENet takes
    one): the one rule of the training steps and of serving."""
    return model(x) if r_pos is None else model(x, r_pos=r_pos)


def build_model(name_or_index, *, dtype: torch.dtype = torch.float32,
                device=None) -> torch.nn.Module:
    """Instantiate a denoiser by reference name or --model_index, on
    `device` (default: the card; raises without one). On the card,
    float32 runs in full float32 (`full_float32`)."""
    name = (MODEL_NAMES[name_or_index] if isinstance(name_or_index, int)
            else name_or_index)
    if name not in _BUILDERS:
        raise ValueError(f"unknown model {name!r}; choose from "
                         f"{MODEL_NAMES + ['newrale']}")
    device = resolve_device(device)
    if device.type == "cuda":
        full_float32()
    return _BUILDERS[name](dtype=dtype).to(device)


__all__ = ["UNet", "Seq2Seq2", "RaleNet", "ACDAE", "NewRale", "ResNetCls",
           "Bottleneck1d", "Transformer1d", "MODEL_NAMES", "apply", "build_model"]
