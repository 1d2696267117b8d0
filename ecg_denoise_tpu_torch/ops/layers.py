"""Core 1-D layers (JAX counterpart: ops/layers.py).

The layers are torch.nn's own, subclassed only to follow the JAX package's
compute-dtype rule: parameters stay float32 (the master weights) and are
cast to the activations' dtype at use, while the norms compute in float32
and return the input dtype. In bfloat16, Linear and Conv1d round the
product to bfloat16 before they add the bfloat16 bias, as the JAX layers
do (a fused bias would round once and differ in the last bit). At float32
every layer here is exactly its torch.nn base class.

Torch-compat facts the JAX package reproduces and this port gets for free:
Conv1d is cross-correlation with torch padding; BatchNorm1d has eps 1e-5,
momentum 0.1, and uses its running stats in eval mode; LayerNorm eps is
1e-5; GELU is the exact erf form (`F.gelu`'s default).

EcaLayer1d, ConvTranspose1d, the pools and linear_upsample2x are not on
RA-LENet's path and come with the UNet and ACDAE slices.
"""

from __future__ import annotations

import torch
import torch.nn as nn
import torch.nn.functional as F


class Linear(nn.Linear):
    """nn.Linear computing in the input's dtype with float32 parameters."""

    def forward(self, x):
        if x.dtype == torch.float32:
            return super().forward(x)
        y = F.linear(x, self.weight.to(x.dtype))
        return y if self.bias is None else y + self.bias.to(x.dtype)


class Conv1d(nn.Conv1d):
    """nn.Conv1d on (B, C, L), computing in the input's dtype."""

    def forward(self, x):
        if x.dtype == torch.float32:
            return super().forward(x)
        y = self._conv_forward(x, self.weight.to(x.dtype), None)
        return y if self.bias is None else y + self.bias.to(x.dtype)[:, None]


class LayerNorm(nn.LayerNorm):
    """LayerNorm over the last axis, eps 1e-5, computed in float32."""

    def __init__(self, normalized_shape, eps: float = 1e-5):
        super().__init__(normalized_shape, eps=eps)

    def forward(self, x):
        return super().forward(x.float()).to(x.dtype)


class BatchNorm1d(nn.BatchNorm1d):
    """BatchNorm1d on (B, C, L), computed in float32 (eval: running stats)."""

    def forward(self, x):
        return super().forward(x.float()).to(x.dtype)


class PartialConv1d(nn.Module):
    """FasterNet partial conv (reference model/transformer.py:16-59).

    Convolves only the first dim // n_div channels (k=3, pad=1, no bias);
    the rest pass through untouched. RA-LENet builds it with n_div == dim,
    so exactly ONE channel is convolved. Input is (B, C, L).
    """

    def __init__(self, dim: int, n_div: int):
        super().__init__()
        self.dim_conv = dim // n_div
        self.partial_conv3 = Conv1d(self.dim_conv, self.dim_conv, 3, padding=1,
                                    bias=False)

    def forward(self, x):
        x1 = self.partial_conv3(x[:, :self.dim_conv])
        return torch.cat([x1, x[:, self.dim_conv:]], dim=1)
