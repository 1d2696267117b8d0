"""1-D conv U-Net denoiser (JAX counterpart: models/unet.py; reference
model/UNet.py:96-141).

Channels 2->4->8->16->32 through four stride-2 encoder blocks (conv k3 +
BatchNorm + LeakyReLU), a 1x1/3x3/1x1 conv bottleneck with a residual,
and four ConvTranspose (k4, s2, p1) decoder blocks with additive skips;
the last decoder block has no activation.

Attribute names are the reference's (`EncList[i].conv`/`.bn`,
`DecList[i].conv`/`.bn`, `bottleneck` with the convs at 0, 3, 6 and the
BatchNorms at 2, 5), so the JAX package's `unet_variables` reads this
module's weights and the reference's `.pth` files load as they are.
"""

from __future__ import annotations

import torch
import torch.nn as nn
import torch.nn.functional as F

from ecg_denoise_tpu_torch.ops.layers import BatchNorm1d, Conv1d, ConvTranspose1d

SLOPE = 0.01


class EncBlock(nn.Module):
    def __init__(self, in_ch: int, out_ch: int):
        super().__init__()
        self.conv = Conv1d(in_ch, out_ch, 3, stride=2, padding=1)
        self.bn = BatchNorm1d(out_ch)

    def forward(self, x):
        return F.leaky_relu(self.bn(self.conv(x)), SLOPE)


class DecBlock(nn.Module):
    def __init__(self, in_ch: int, out_ch: int, use_relu: bool = True):
        super().__init__()
        self.conv = ConvTranspose1d(in_ch, out_ch, 4, stride=2, padding=1)
        self.bn = BatchNorm1d(out_ch)
        self.use_relu = use_relu

    def forward(self, x):
        x = self.bn(self.conv(x))
        return F.leaky_relu(x, SLOPE) if self.use_relu else x


class UNet(nn.Module):
    """UNet on (B, 2, L), L a multiple of 16. Parameters are float32;
    `dtype` is the compute dtype, as in the JAX module."""

    in_channels = 2

    def __init__(self, dtype: torch.dtype = torch.float32):
        super().__init__()
        self.dtype = dtype
        ch = [2 ** (n + 1) for n in range(5)]  # 2, 4, 8, 16, 32
        self.EncList = nn.ModuleList(EncBlock(ch[i], ch[i + 1]) for i in range(4))
        self.bottleneck = nn.Sequential(
            Conv1d(ch[4], ch[4], 1), nn.LeakyReLU(SLOPE), BatchNorm1d(ch[4]),
            Conv1d(ch[4], ch[4], 3, padding=1), nn.LeakyReLU(SLOPE), BatchNorm1d(ch[4]),
            Conv1d(ch[4], ch[4], 1))
        self.DecList = nn.ModuleList(
            DecBlock(ch[4 - i], ch[3 - i], use_relu=i < 3) for i in range(4))

    def forward(self, x):
        x = x.to(self.dtype)
        skips = []
        for enc in self.EncList:
            x = enc(x)
            skips.append(x)
        x = self.bottleneck(x) + x
        for i, dec in enumerate(self.DecList[:3]):
            x = dec(x) + skips[2 - i]
        return self.DecList[3](x)
