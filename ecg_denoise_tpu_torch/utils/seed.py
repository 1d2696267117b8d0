"""Seeding — the port's `random_seed` (JAX counterpart: utils/seed.py).

Seeds the python, numpy and torch global RNGs (so module construction,
which draws its default init from torch's global RNG, is reproducible) and
returns a `torch.Generator` for explicit randomness — the counterpart of
the PRNGKey the JAX version returns.
"""

from __future__ import annotations

import random

import numpy as np
import torch


def random_seed(seed: int = 2023) -> torch.Generator:
    """Seed python + numpy + torch global RNGs; return a seeded Generator."""
    random.seed(seed)
    np.random.seed(seed)
    torch.manual_seed(seed)
    return torch.Generator().manual_seed(seed)
