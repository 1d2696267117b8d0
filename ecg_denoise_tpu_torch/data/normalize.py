"""Normalization helpers (JAX counterpart: data/normalize.py; reference
local_utils/local_utils.py:258-266, 691-692).

One definition each, numpy or torch in and out: a `torch.Tensor` is
normalised by torch on its own device, anything else (arrays, lists,
numbers) by numpy.
"""

from __future__ import annotations

import numpy as np
import torch


def znorm(x, axis: int = -1, eps: float = 0.0):
    """Zero-mean unit-std over `axis` (the reference's np_norm semantics:
    per-signal standardization; std==0 rows pass through unscaled)."""
    if isinstance(x, torch.Tensor):
        m = x.mean(dim=axis, keepdim=True)
        s = x.std(dim=axis, keepdim=True, correction=0)
        denom = torch.where(s > eps, s, torch.ones_like(s)) if eps == 0.0 else s + eps
        return (x - m) / denom
    m = np.mean(x, axis=axis, keepdims=True)
    s = np.std(x, axis=axis, keepdims=True)
    denom = np.where(s > eps, s, 1.0) if eps == 0.0 else s + eps
    return (x - m) / denom


def minmax_norm(x, axis: int = -1):
    """Scale to [0, 1] over `axis` (the reference np_normlize variant)."""
    if isinstance(x, torch.Tensor):
        lo = x.amin(dim=axis, keepdim=True)
        rng = x.amax(dim=axis, keepdim=True) - lo
        return (x - lo) / torch.where(rng > 0, rng, torch.ones_like(rng))
    lo = np.min(x, axis=axis, keepdims=True)
    rng = np.max(x, axis=axis, keepdims=True) - lo
    return (x - lo) / np.where(rng > 0, rng, 1.0)
