"""The downstream N-against-V beat classifier (JAX counterpart:
models/resnet_cls.py; reference model/ResNet_cls.py:12-67).

A conv7/s2 stem, four stages of `Bottleneck1d` blocks (2, 3, 3, 3) at
32/64/128/256 channels with a conv3/s2 downsample between stages, a mean
over length and an MLP 256 -> 512 -> 2; no conv has a bias.

The reference takes `Bottleneck1d` from a package outside its repository,
so the JAX package reconstructs it as the standard 1-D bottleneck: 1x1
reduce to planes // 4, 3x3, 1x1 expand, BatchNorm + ReLU after each and an
identity residual (every block keeps its width). This module copies that
reconstruction.

Attribute names are the JAX module names (`init_conv`,
`layer{s}_block{b}.conv1/bn1/...`, `downsample{s}`, `mlp_fc1`, `mlp_fc2`),
so `interop.jax_weights.resnet_cls_state_dict` maps JAX variables without
renames. Parameters are float32; `dtype` is the compute dtype, as in the
JAX module.
"""

from __future__ import annotations

import torch
import torch.nn as nn
import torch.nn.functional as F

from ecg_denoise_tpu_torch.ops.layers import BatchNorm1d, Conv1d, Linear, mean_f32

CHANNELS = (32, 64, 128, 256)
BLOCKS = (2, 3, 3, 3)


class Bottleneck1d(nn.Module):
    """1x1 reduce -> 3x3 (stride) -> 1x1 expand, BN + ReLU each, identity
    residual; `planes` in and out."""

    def __init__(self, planes: int, stride: int = 1):
        super().__init__()
        width = max(planes // 4, 1)
        self.conv1 = Conv1d(planes, width, 1, bias=False)
        self.bn1 = BatchNorm1d(width)
        self.conv2 = Conv1d(width, width, 3, stride=stride, padding=1, bias=False)
        self.bn2 = BatchNorm1d(width)
        self.conv3 = Conv1d(width, planes, 1, bias=False)
        self.bn3 = BatchNorm1d(planes)

    def forward(self, x):
        h = F.relu(self.bn1(self.conv1(x)))
        h = F.relu(self.bn2(self.conv2(h)))
        return F.relu(self.bn3(self.conv3(h)) + x)


class ResNetCls(nn.Module):
    """(B, in_channels, L) beats -> (B, num_classes) logits in the compute
    dtype."""

    def __init__(self, in_channels: int = 2, num_classes: int = 2,
                 dtype: torch.dtype = torch.float32):
        super().__init__()
        self.in_channels, self.dtype = in_channels, dtype
        self.init_conv = Conv1d(in_channels, CHANNELS[0], 7, stride=2, padding=3,
                                bias=False)
        for s, (ch, n) in enumerate(zip(CHANNELS, BLOCKS), start=1):
            for b in range(n):
                setattr(self, f"layer{s}_block{b}", Bottleneck1d(ch))
            if s < len(CHANNELS):
                setattr(self, f"downsample{s}",
                        Conv1d(ch, CHANNELS[s], 3, stride=2, padding=1, bias=False))
        self.mlp_fc1 = Linear(CHANNELS[-1], 512)
        self.mlp_fc2 = Linear(512, num_classes)

    def forward(self, x):
        x = self.init_conv(x.to(self.dtype))
        for s, n in enumerate(BLOCKS, start=1):
            for b in range(n):
                x = getattr(self, f"layer{s}_block{b}")(x)
            if s < len(CHANNELS):
                x = getattr(self, f"downsample{s}")(x)
        x = mean_f32(x, 2)  # (B, C)
        return self.mlp_fc2(F.relu(self.mlp_fc1(x)))
