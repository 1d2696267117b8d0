"""Checkpoints with the reference's file-name scheme (JAX counterpart:
train/checkpoint.py; reference denoise_train.py:90-94).

`{dir}/{name}/{name}_{epoch}_{noise}_intensity{k}.pth`, as the reference
names its files. The reference saves a bare state_dict; this file holds the
full training state, {"model": state_dict, "optimizer": Adam state_dict},
so a resume is exact, as the JAX package's is; the step count is Adam's
own (`TrainState.step`). `load_model_weights` reads the "model" part, or
a bare state_dict, into a module: 12-lead transfer loads a RA-LENet
checkpoint into `NewRale.rale` with it (serving's
`Denoiser.from_checkpoint` reads the same two layouts).

`find_model` mirrors the reference's checkpoint discovery
(local_utils/local_utils.py:700-715).
"""

from __future__ import annotations

import glob
import os
import re
from typing import Optional

import torch

from ecg_denoise_tpu_torch.train.state import TrainState


def checkpoint_path(model_dir: str, model_name: str, epoch: int,
                    noise_name: str, noise_intensity: int) -> str:
    return os.path.join(
        model_dir, model_name,
        f"{model_name}_{epoch}_{noise_name}_intensity{noise_intensity}.pth")


def save_checkpoint(path: str, state: TrainState) -> str:
    os.makedirs(os.path.dirname(path) or ".", exist_ok=True)
    torch.save({"model": state.model.state_dict(),
                "optimizer": state.optimizer.state_dict()}, path)
    return path


def load_checkpoint(path: str, state: TrainState) -> TrainState:
    """Restore the model and optimizer of `state` in place from `path`.

    Read onto the host: both load_state_dicts copy to the parameters'
    device, and Adam's step counts stay host scalars as torch keeps them.
    """
    ckpt = torch.load(path, map_location="cpu", weights_only=True)
    state.model.load_state_dict(ckpt["model"])
    state.optimizer.load_state_dict(ckpt["optimizer"])
    return state


def load_model_weights(path: str, module: torch.nn.Module) -> torch.nn.Module:
    """Load the "model" part of a checkpoint of `save_checkpoint`, or a
    bare `torch.save`d state_dict, into `module` (read onto the host and
    copied to the module's device)."""
    state = torch.load(path, map_location="cpu", weights_only=True)
    module.load_state_dict(state.get("model", state))
    return module


def find_model(model_path: str, model_name: Optional[str] = None,
               epoch: Optional[int] = None) -> Optional[str]:
    """A checkpoint file in `model_path` by name and epoch, else the latest
    epoch; None if there is none."""
    cands = glob.glob(os.path.join(model_path, "*.pth"))
    if model_name:
        cands = [c for c in cands if os.path.basename(c).startswith(model_name + "_")]

    def ep(c):
        m = re.search(r"_(\d+)_", os.path.basename(c))
        return int(m.group(1)) if m else -1

    if epoch is not None:
        cands = [c for c in cands if ep(c) == epoch]
    return max(cands, key=ep) if cands else None
