"""The training loop (JAX counterpart: train/loop.py; reference
denoise_train.py:15-103).

Adam(lr=1e-3), MSE loss, per-epoch train and eval SNR/RMSE means, a
checkpoint every 10 epochs under model_save/{name}/, the result line
appended to output.txt in the reference's format, and the reference's
return value (train_snr_list, test_snr_list, train_rmse_list,
test_rmse_list). The splits are put on the device once.

Epoch e permutes the training split from a generator seeded by (seed, e).
`resume_path` restores the model and optimizer, and then, as JAX's `fit`
does, the loop trains `epochs` epochs counted from 0 again: epoch e takes
the generator of (seed, e), the checkpoints are named from epoch 0 again,
and the step count carries on from the checkpoint's.

`r_pos_mode="detect"` detects the R peaks of every batch on the device
and feeds them to the model's R-wave attention bias (`make_epoch_fns`'s
`detect_r_pos`). `frozen_mask` names parameters that stay frozen (12-lead
transfer's core, `NewRale.frozen_parameters()`; `create_train_state`'s
`frozen`).

With `mesh` (`parallel.make_mesh`) every rank of the ('data', 'model')
grid runs `fit` in lockstep on the same arguments: each starts from rank
0's state, with n_model > 1 sharded over its model group
(`shard_state_dp_tp`, as JAX's loop.py does; `replicate_state` without
tensor parallelism), trains its data index's share of every global batch
(`make_epoch_fns`' mesh), and returns the same four lists. Only rank 0
prints and writes checkpoints and output.txt, as JAX's `is_primary`
process does; a checkpoint is one process's layout (`gather_state`), so
`load_checkpoint`, `Denoiser.from_checkpoint` and a resume under any grid
read it. `local_data`: each rank passes only its data index's windows
(`multihost.process_shard`), as under `--multihost`.
"""

from __future__ import annotations

import os
import time
from collections.abc import Iterable
from typing import Optional

import numpy as np
import torch

from ecg_denoise_tpu_torch import resolve_device
from ecg_denoise_tpu_torch.parallel.mesh import gather_state, shard_state_dp_tp
from ecg_denoise_tpu_torch.train.checkpoint import (
    checkpoint_path,
    load_checkpoint,
    save_checkpoint,
)
from ecg_denoise_tpu_torch.train.state import create_train_state
from ecg_denoise_tpu_torch.train.steps import make_epoch_fns


def epoch_generator(seed: int, epoch: int, device) -> torch.Generator:
    """The generator that permutes epoch `epoch` of a run seeded `seed`."""
    mixed = int(np.random.SeedSequence([seed, epoch]).generate_state(1)[0])
    return torch.Generator(device=device).manual_seed(mixed)


def fit(
    model: torch.nn.Module,
    train_noisy: np.ndarray,
    train_clean: np.ndarray,
    test_noisy: np.ndarray,
    test_clean: np.ndarray,
    *,
    epochs: int = 100,
    batch_size: int = 32,
    learning_rate: float = 1e-3,
    model_name: str = "model",
    noise_name: str = "bw",
    noise_intensity: int = -4,
    seed: int = 2023,
    model_save_dir: str = "./model_save",
    output_file: str = "./output.txt",
    checkpoint_every: int = 10,
    resume_path: Optional[str] = None,
    init_variables: Optional[dict] = None,
    log_every: int = 1,
    verbose: bool = True,
    r_pos_mode: Optional[str] = None,
    frozen_mask: Iterable[str] = (),
    device=None,
    mesh=None,
    local_data: bool = False,
):
    """Train `model` (already initialised, e.g. after `random_seed(seed)`)
    on `device` (default: the card; under a `mesh`, the mesh's device).
    `init_variables`: a state_dict loaded into the model first. Returns
    (state, (train_snr_list, test_snr_list, train_rmse_list,
    test_rmse_list)).

    A resume trains `epochs` epochs after the checkpoint, counted from 0, as
    JAX's `fit` does. A training split shorter than one batch takes no step
    in any epoch (its train metrics are NaN)."""
    if r_pos_mode not in (None, "detect"):
        raise ValueError(f"r_pos_mode must be None or 'detect', got {r_pos_mode!r}")
    if mesh is not None:
        device = mesh.device
    # Only rank 0 touches shared storage or prints: the ranks would race on
    # the same paths and repeat every line.
    is_primary = mesh is None or mesh.is_primary
    verbose = verbose and is_primary
    state = create_train_state(model, learning_rate, device, frozen=frozen_mask)
    device = resolve_device(device)
    if init_variables is not None:
        state.model.load_state_dict(init_variables)
    if resume_path:
        load_checkpoint(resume_path, state)
    if mesh is not None:
        shard_state_dp_tp(state, mesh)

    def put(a):
        return torch.as_tensor(np.asarray(a, np.float32)).to(device)

    tr_n, tr_c = put(train_noisy), put(train_clean)
    te_n, te_c = put(test_noisy), put(test_clean)
    train_epoch, eval_epoch = make_epoch_fns(
        state.model, state.optimizer, detect_r_pos=r_pos_mode == "detect", mesh=mesh,
        local_data=local_data)

    train_snr_list, test_snr_list = [], []
    train_rmse_list, test_rmse_list = [], []
    t0 = time.time()
    test_metrics = {"snr": float("nan"), "rmse": float("nan")}
    for epoch in range(epochs):
        train_metrics = train_epoch(tr_n, tr_c, epoch_generator(seed, epoch, device),
                                    batch_size)
        test_metrics = eval_epoch(te_n, te_c, batch_size)
        train_snr_list.append(train_metrics["snr"])
        test_snr_list.append(test_metrics["snr"])
        train_rmse_list.append(train_metrics["rmse"])
        test_rmse_list.append(test_metrics["rmse"])
        if verbose and (epoch + 1) % log_every == 0:
            print(f"[{model_name}] epoch {epoch + 1:03d}/{epochs} "
                  f"loss={train_metrics['loss']:.5f} "
                  f"train_snr={train_metrics['snr']:.3f} "
                  f"test_snr={test_metrics['snr']:.3f} "
                  f"test_rmse={test_metrics['rmse']:.4f} ({time.time() - t0:.1f}s)",
                  flush=True)
        if (epoch + 1) % checkpoint_every == 0:
            # Every rank takes part in gathering a sharded state.
            contents = gather_state(state, mesh) if mesh is not None else None
            if is_primary:
                path = checkpoint_path(model_save_dir, model_name, epoch, noise_name,
                                       noise_intensity)
                save_checkpoint(path, state, contents)
                if verbose:
                    print(f"saved {path}", flush=True)

    if output_file and is_primary:
        os.makedirs(os.path.dirname(os.path.abspath(output_file)), exist_ok=True)
        with open(output_file, "a") as f:
            # Reference format (denoise_train.py:100-101).
            f.write(f"{model_name}_{epochs - 1}_{noise_name}_intensity{noise_intensity}:"
                    f"snr:{test_metrics['snr']}, rmse:{test_metrics['rmse']}\n")

    return state, (train_snr_list, test_snr_list, train_rmse_list, test_rmse_list)
