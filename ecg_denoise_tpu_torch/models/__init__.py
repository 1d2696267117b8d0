"""Model registry (JAX counterpart: models/__init__.py; reference
main.py:28,63-80). This slice ports the RA-LENet family:

    index 2: 'ralenet_nra'  -> RaleNet(variant='nra')
    index 3: 'ralenet_mlp'  -> RaleNet(variant='mlp')
    index 4: 'ralenet'      -> RaleNet(variant='full')
"""

from __future__ import annotations

import torch

from ecg_denoise_tpu_torch import MODEL_NAMES, full_float32, resolve_device
from ecg_denoise_tpu_torch.models.ralenet import RaleNet

_RALENET_VARIANTS = {"ralenet_nra": "nra", "ralenet_mlp": "mlp",
                     "ralenet": "full"}
# Where each model not ported yet stands in ROADMAP.md's queue A.
_QUEUED = {"unet": "A11", "DANet": "A11", "ACDAE": "A11", "newrale": "A12"}


def build_model(name_or_index, *, dtype: torch.dtype = torch.float32,
                device=None) -> RaleNet:
    """Instantiate a denoiser by reference name or --model_index, on
    `device` (default: the card; raises without one). On the card,
    float32 runs in full float32 (`full_float32`)."""
    name = (MODEL_NAMES[name_or_index] if isinstance(name_or_index, int)
            else name_or_index)
    if name in _RALENET_VARIANTS:
        device = resolve_device(device)
        if device.type == "cuda":
            full_float32()
        return RaleNet(variant=_RALENET_VARIANTS[name], dtype=dtype).to(device)
    if name in _QUEUED:
        raise NotImplementedError(
            f"model {name!r} is not ported yet (ROADMAP.md item {_QUEUED[name]})")
    raise ValueError(f"unknown model {name!r}; choose from "
                     f"{MODEL_NAMES + ['newrale']}")


__all__ = ["RaleNet", "MODEL_NAMES", "build_model"]
