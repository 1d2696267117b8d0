"""Transformer1d, a hierarchical transformer sequence classifier (JAX
counterpart: models/transformer1d.py; reference
model/raletransformer.py:504-555, public there and used by no script).

A 1x1 conv embed to `embed_dim`, then per stage a `BasicLayer` of
`depths[i]` blocks with `num_heads[i]` heads and, between stages, a
`PatchMerging` (length halved, channels doubled: 128/256/512/1024 at the
defaults, every head 32 wide), a final LayerNorm, the mean over length and
a Linear head.

There is no `use_pallas` switch: as in RaleNet, the attention goes to the
Hopper kernels (B1 and B2's mma template up to a head width of 64, their
wide kernels past it) on a CUDA tensor and to their plain version on a
CPU tensor, at any head width (`kernels.attention.fused_attention`).
Attribute names are the JAX module names (`embed`, `layer{i}`,
`merge{i}`, `norm`, `head`), so `interop.jax_weights.transformer1d_state_dict`
maps JAX variables without renames. Parameters are float32; `dtype` is
the compute dtype, as in the JAX module.
"""

from __future__ import annotations

from typing import Sequence

import torch
import torch.nn as nn

from ecg_denoise_tpu_torch.ops.attention import BasicLayer, PatchMerging
from ecg_denoise_tpu_torch.ops.layers import Conv1d, LayerNorm, Linear, mean_f32


class Transformer1d(nn.Module):
    """(B, in_channels, L) -> (B, num_class) logits in the compute dtype."""

    def __init__(self, num_class: int = 9, in_channels: int = 32, embed_dim: int = 128,
                 depths: Sequence[int] = (2, 2, 6, 2),
                 num_heads: Sequence[int] = (4, 8, 16, 32), mlp_ratio: float = 4.0,
                 local_enhence: bool = False, dtype: torch.dtype = torch.float32):
        super().__init__()
        if dtype not in (torch.float32, torch.bfloat16):
            raise TypeError(f"dtype must be float32 or bfloat16, got {dtype}")
        self.in_channels, self.dtype = in_channels, dtype
        self.n_stages = len(depths)
        self.embed = Conv1d(in_channels, embed_dim, 1)
        for i, (depth, heads) in enumerate(zip(depths, num_heads)):
            dim = embed_dim * 2 ** i
            setattr(self, f"layer{i}", BasicLayer(dim, depth, heads, mlp_ratio,
                                                  local_enhence=local_enhence))
            if i < self.n_stages - 1:
                setattr(self, f"merge{i}", PatchMerging(dim))
        last = embed_dim * 2 ** (self.n_stages - 1)
        self.norm = LayerNorm(last)
        self.head = Linear(last, num_class)

    def forward(self, x):
        h = self.embed(x.to(self.dtype)).transpose(1, 2)  # (B, L, C)
        for i in range(self.n_stages):
            h = getattr(self, f"layer{i}")(h)
            if i < self.n_stages - 1:
                h = getattr(self, f"merge{i}")(h)
        return self.head(mean_f32(self.norm(h), 1))
