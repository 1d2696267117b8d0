"""Training state (JAX counterpart: train/state.py; reference
denoise_train.py:20-24, the model and Adam(lr=1e-3)).

`TrainState` holds the model, its `torch.optim.Adam` and the step count.
torch's Adam (eps 1e-8, bias-corrected, no eps inside the root) computes
the update of optax's `adam` (eps_root 0): lr·m̂ / (sqrt(v̂) + eps). The step
count is the optimizer's own, so a checkpoint of the optimizer carries it.

`frozen` names parameters that stay as they are (12-lead transfer's core,
`NewRale.frozen_parameters()`): they stop requiring grad and stay out of
Adam, which gives the update of JAX's optax `set_to_zero` under
`multi_transform` for them and plain Adam for the rest.
"""

from __future__ import annotations

from collections.abc import Iterable
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
                       device=None, frozen: Iterable[str] = ()) -> TrainState:
    """`model` moved to `device` (default: the card; raises without one)
    with a fresh Adam(lr=learning_rate) over its parameters but those named
    in `frozen`, which stop requiring grad. On the card, float32 runs in
    full float32 (`full_float32`)."""
    device = resolve_device(device)
    if device.type == "cuda":
        full_float32()
    model = model.to(device)
    params = dict(model.named_parameters())
    frozen = set(frozen)
    if frozen - params.keys():
        raise ValueError(f"no parameters named {sorted(frozen - params.keys())}")
    for name in frozen:
        params[name].requires_grad_(False)
    trained = [p for name, p in params.items() if name not in frozen]
    return TrainState(model, torch.optim.Adam(trained, lr=learning_rate))
