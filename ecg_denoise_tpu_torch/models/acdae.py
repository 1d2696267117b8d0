"""Attention-based convolutional denoising autoencoder (JAX counterpart:
models/acdae.py; reference model/ACDAE.py:62-86).

Encoder: 4 x [conv (k 13/7/7/7, same padding) -> max pool (2) ->
LeakyReLU], channels 2->16->32->64->128. Decoder: 4 x [ConvTranspose (k,
stride 1, same padding) -> linear upsample (x2) -> LeakyReLU -> ECA
channel attention], with additive skips after decoder stages 1-3; the
last stage's ECA output is returned.

The upsample interpolates with float32 weights, so in bfloat16 the model
computes as the JAX module does: every conv rounds its input to bfloat16,
the decoder stages return float32, and so does the model.

Attribute names are the reference's (`EncList[i].conv`, `DecList[i].conv`,
`DecList[i].ECA.conv`), so the JAX package's `acdae_variables` reads this
module's weights and the reference's `.pth` files load as they are.
"""

from __future__ import annotations

import torch
import torch.nn as nn
import torch.nn.functional as F

from ecg_denoise_tpu_torch.ops.layers import (
    Conv1d,
    ConvTranspose1d,
    adaptive_avg_pool1d,
    linear_upsample2x,
    max_pool1d,
)

SLOPE = 0.01
CHANNELS = (2, 16, 32, 64, 128)
KSIZE = (13, 7, 7, 7)


class ECAModule(nn.Module):
    """ECA on (B, C, L) (reference ACDAE.py:9-23): GAP over L, a k3 conv
    across channels, a sigmoid gate."""

    def __init__(self, dtype: torch.dtype = torch.float32, k_size: int = 3):
        super().__init__()
        self.dtype = dtype
        self.conv = Conv1d(1, 1, k_size, padding=1, bias=False)

    def forward(self, x):
        y = adaptive_avg_pool1d(x).transpose(1, 2)  # (B, 1, C)
        y = self.conv(y.to(self.dtype)).transpose(1, 2)  # (B, C, 1)
        return x * torch.sigmoid(y)


class EncBlock(nn.Module):
    def __init__(self, in_ch: int, out_ch: int, k: int):
        super().__init__()
        self.conv = Conv1d(in_ch, out_ch, k, padding=(k - 1) // 2)


class DecBlock(nn.Module):
    def __init__(self, in_ch: int, out_ch: int, k: int, dtype: torch.dtype):
        super().__init__()
        self.conv = ConvTranspose1d(in_ch, out_ch, k, padding=(k - 1) // 2)
        self.ECA = ECAModule(dtype)


class ACDAE(nn.Module):
    """ACDAE on (B, 2, L), L a multiple of 16. Parameters are float32;
    `dtype` is the compute dtype of the convs, as in the JAX module."""

    in_channels = 2

    def __init__(self, dtype: torch.dtype = torch.float32):
        super().__init__()
        self.dtype = dtype
        self.EncList = nn.ModuleList(
            EncBlock(CHANNELS[i], CHANNELS[i + 1], KSIZE[i]) for i in range(4))
        self.DecList = nn.ModuleList(
            DecBlock(CHANNELS[4 - i], CHANNELS[3 - i], KSIZE[3 - i], dtype)
            for i in range(4))

    def forward(self, x):
        skips = []
        for blk in self.EncList:
            x = F.leaky_relu(max_pool1d(blk.conv(x.to(self.dtype))), SLOPE)
            skips.append(x)
        for i, blk in enumerate(self.DecList):
            h = F.leaky_relu(linear_upsample2x(blk.conv(x.to(self.dtype))), SLOPE)
            x = blk.ECA(h)
            if i < 3:
                x = x + skips[2 - i]
        return x
