"""Training state (JAX counterpart: train/state.py; reference
denoise_train.py:20-24, the model and Adam(lr=1e-3)).

`TrainState` holds the model, its `torch.optim.Adam` and the step count.
torch's Adam (eps 1e-8, bias-corrected, no eps inside the root) computes
the update of optax's `adam` (eps_root 0): lr·m̂ / (sqrt(v̂) + eps). The step
count is the optimizer's own, so a checkpoint of the optimizer carries it.

The frozen-parameter mask of 12-lead transfer (`frozen_mask`) comes with
that slice (ROADMAP A12).
"""

from __future__ import annotations

from dataclasses import dataclass

import torch

from ecg_denoise_tpu_torch import full_float32, resolve_device


@dataclass
class TrainState:
    model: torch.nn.Module
    optimizer: torch.optim.Adam

    @property
    def step(self) -> int:
        """Optimizer steps taken (optax's `count`)."""
        for state in self.optimizer.state.values():
            return int(state["step"])
        return 0


def create_train_state(model: torch.nn.Module, learning_rate: float = 1e-3,
                       device=None) -> TrainState:
    """`model` moved to `device` (default: the card; raises without one)
    with a fresh Adam(lr=learning_rate) over its parameters. On the card,
    float32 runs in full float32 (`full_float32`)."""
    device = resolve_device(device)
    if device.type == "cuda":
        full_float32()
    model = model.to(device)
    return TrainState(model, torch.optim.Adam(model.parameters(), lr=learning_rate))
