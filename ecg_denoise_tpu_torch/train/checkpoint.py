"""Checkpoints with the reference's file-name scheme (JAX counterpart:
train/checkpoint.py; reference denoise_train.py:90-94).

`{dir}/{name}/{name}_{epoch}_{noise}_intensity{k}.pth`, as the reference
names its files. The reference saves a bare state_dict; this file holds the
full training state, {"model": state_dict, "optimizer": Adam state_dict},
so a resume is exact, as the JAX package's is; the step count is Adam's
own (`TrainState.step`). `load_model_weights` reads the "model" part, or
a bare state_dict, into a module: 12-lead transfer loads a RA-LENet
checkpoint into `NewRale.rale` with it, and serving's
`Denoiser.from_checkpoint` reads through it.

The JAX package's checkpoints, the same names with `.msgpack` (a whole
flax TrainState: params, batch_stats, the optax state and the step), are
read too, by their suffix: `interop.flax_msgpack` decodes the file, and
`params` and `batch_stats` go through the model family's map
(`interop.jax_weights.state_dict_for`). `load_checkpoint` also restores
Adam from the optax state of `optax.adam`, its step from optax's count; a
state it cannot map (the `multi_transform` of a frozen-parameter mask,
which the JAX package itself reads only through `load_variables`) raises
and names the file, and is never resumed with a fresh Adam.
`load_model_weights` reads only `params` and `batch_stats`, as JAX's
`load_variables` does, so it takes any of them.

`find_model` mirrors the reference's checkpoint discovery
(local_utils/local_utils.py:700-715) over both suffixes.
"""

from __future__ import annotations

import glob
import os
import re
from collections.abc import Mapping
from typing import Optional

import torch

from ecg_denoise_tpu_torch.train.state import TrainState

JAX_SUFFIX = ".msgpack"


def checkpoint_path(model_dir: str, model_name: str, epoch: int,
                    noise_name: str, noise_intensity: int) -> str:
    return os.path.join(
        model_dir, model_name,
        f"{model_name}_{epoch}_{noise_name}_intensity{noise_intensity}.pth")


def save_checkpoint(path: str, state: TrainState, contents: Optional[dict] = None) -> str:
    """Write `state` to `path`; `contents`, where given, is its
    {"model", "optimizer"} in one process's layout (`parallel.gather_state`
    of a tensor-parallel state), written in its place."""
    os.makedirs(os.path.dirname(path) or ".", exist_ok=True)
    torch.save(contents or {"model": state.model.state_dict(),
                            "optimizer": state.optimizer.state_dict()}, path)
    return path


def _read_jax(path: str) -> dict:
    """A JAX `.msgpack` checkpoint's state dict, checked for its variables."""
    from ecg_denoise_tpu_torch.interop import flax_msgpack

    raw = flax_msgpack.load(path)
    if not isinstance(raw, Mapping) or "params" not in raw:
        raise ValueError(f"{path} holds no JAX 'params'")
    return raw


def _jax_model_state(raw: Mapping, module: torch.nn.Module) -> dict:
    from ecg_denoise_tpu_torch.interop.jax_weights import state_dict_for

    return state_dict_for(module, {"params": raw["params"],
                                   "batch_stats": raw.get("batch_stats") or {}})


def _optax_adam(path: str, opt_state) -> tuple:
    """(mu, nu, count) of the state of `optax.adam`: the chain
    (ScaleByAdamState, EmptyState), stored as {"0": {count, mu, nu}, "1": {}}."""
    if (isinstance(opt_state, Mapping) and set(opt_state) == {"0", "1"}
            and opt_state["1"] == {} and isinstance(opt_state["0"], Mapping)
            and set(opt_state["0"]) == {"count", "mu", "nu"}):
        adam = opt_state["0"]
        return adam["mu"], adam["nu"], adam["count"]
    keys = sorted(opt_state) if isinstance(opt_state, Mapping) else type(opt_state).__name__
    raise ValueError(f"{path}: its optimizer state ({keys}) is not optax.adam's, which "
                     "is the only one the port restores (a frozen-parameter mask's "
                     "multi_transform is not); load its weights with load_model_weights")


def load_checkpoint(path: str, state: TrainState) -> TrainState:
    """Restore the model and optimizer of `state` in place from `path`, a
    checkpoint of `save_checkpoint` or a JAX `.msgpack` TrainState.

    Read onto the host: both load_state_dicts copy to the parameters'
    device, and Adam's step counts stay host scalars as torch keeps them.
    """
    if os.fspath(path).endswith(JAX_SUFFIX):
        from ecg_denoise_tpu_torch.interop.jax_weights import adam_state_from_optax

        raw = _read_jax(path)
        mu, nu, count = _optax_adam(path, raw.get("opt_state"))
        params = [p for group in state.optimizer.param_groups for p in group["params"]]
        if [id(p) for p in params] != [id(p) for p in state.model.parameters()]:
            raise ValueError(f"{path}: optax.adam covers every parameter, and this "
                             "optimizer does not (a frozen state)")
        adam = adam_state_from_optax(mu, nu, count, state.model)
        state.model.load_state_dict(_jax_model_state(raw, state.model))
        sd = state.optimizer.state_dict()
        sd["state"] = adam
        state.optimizer.load_state_dict(sd)
        return state
    ckpt = torch.load(path, map_location="cpu", weights_only=True)
    state.model.load_state_dict(ckpt["model"])
    state.optimizer.load_state_dict(ckpt["optimizer"])
    return state


def load_model_weights(path: str, module: torch.nn.Module) -> torch.nn.Module:
    """Load the "model" part of a checkpoint of `save_checkpoint`, a bare
    `torch.save`d state_dict, or the params and batch_stats of a JAX
    `.msgpack` checkpoint into `module` (read onto the host and copied to
    the module's device)."""
    if os.fspath(path).endswith(JAX_SUFFIX):
        module.load_state_dict(_jax_model_state(_read_jax(path), module))
        return module
    state = torch.load(path, map_location="cpu", weights_only=True)
    module.load_state_dict(state.get("model", state))
    return module


def find_model(model_path: str, model_name: Optional[str] = None,
               epoch: Optional[int] = None) -> Optional[str]:
    """A checkpoint file (`.pth`, or the JAX package's `.msgpack`) in
    `model_path` by name and epoch, else the latest epoch; None if there is
    none."""
    cands = [c for suffix in (".pth", JAX_SUFFIX)
             for c in glob.glob(os.path.join(model_path, f"*{suffix}"))]
    if model_name:
        cands = [c for c in cands if os.path.basename(c).startswith(model_name + "_")]

    def ep(c):
        m = re.search(r"_(\d+)_", os.path.basename(c))
        return int(m.group(1)) if m else -1

    if epoch is not None:
        cands = [c for c in cands if ep(c) == epoch]
    return max(cands, key=ep) if cands else None
