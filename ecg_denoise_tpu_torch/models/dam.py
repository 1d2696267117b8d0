"""DANet / DACNN family, the dual-attention conv denoiser (JAX
counterpart: models/dam.py; reference model/DAM.py:12-156,283-350).

Seq2Seq2 = an encoder of 4 strided EncoderCells (k 17/17/3/3, channels
4/8/16/32, APReLU activations, BatchNorm) and a decoder of 4 ConvTranspose
DecoderCells (k 4/4/18/18, channels 16/8/4/2, APReLU + BatchNorm + DAM
dual attention, the last without DAM), with truncating additive skips
(`alignment_add`).

Attribute names are the reference's (`enc.EncoderList[i].{conv,
activate.fcn, bn}`, `dec.DecoderList[i].{deconv, activate.fcn, bn, dam}`,
`dam.{fcn1, fcn2, convsa}`), so the JAX package's `seq2seq2_variables`
reads this module's weights and the reference's `.pth` files load as they
are. DAM's `fcn1` and `fcn2` are one module registered under both names,
as the reference builds them from one layer list: the state_dict carries
both key sets, Adam sees each tensor once, and in training the shared
BatchNorms update their running stats twice a forward, as the JAX
module's do.
"""

from __future__ import annotations

import torch
import torch.nn as nn

from ecg_denoise_tpu_torch.ops.layers import (
    BatchNorm1d,
    Conv1d,
    ConvTranspose1d,
    Linear,
    adaptive_avg_pool1d,
    mean_f32,
)


def _fcn(c_in: int, c_mid: int, c_out: int) -> nn.Sequential:
    """Linear, BatchNorm, ReLU, Linear, BatchNorm, Sigmoid (the reference's
    layer list; the parameters sit at 0, 1, 3 and 4)."""
    return nn.Sequential(Linear(c_in, c_mid), BatchNorm1d(c_mid), nn.ReLU(),
                         Linear(c_mid, c_out), BatchNorm1d(c_out), nn.Sigmoid())


class APReLU(nn.Module):
    """Adaptively parametric ReLU (reference DAM.py:12-48): the negative
    slope is a per-sample, per-channel sigmoid gate computed by an FCN over
    GAP(pos) || GAP(neg)."""

    def __init__(self, channels: int):
        super().__init__()
        self.fcn = _fcn(2 * channels, 2 * channels, channels)

    def forward(self, x):  # (B, C, L)
        pos, neg = torch.clamp(x, min=0), torch.clamp(x, max=0)
        h = torch.cat([adaptive_avg_pool1d(pos)[..., 0],
                       adaptive_avg_pool1d(neg)[..., 0]], dim=1)  # (B, 2C)
        return pos + self.fcn(h)[:, :, None] * neg


class DAM(nn.Module):
    """Dual attention (reference DAM.py:101-156): channel attention
    sigmoid(FCN(GAP) + FCN(GMP)), one FCN for both, and spatial attention
    sigmoid(1x1 conv over [mean, max] across channels)."""

    def __init__(self, channels: int):
        super().__init__()
        self.fcn1 = self.fcn2 = _fcn(channels, channels, channels)
        self.convsa = Conv1d(2, 1, 1)

    def forward(self, x):  # (B, C, L)
        gap, gmp = mean_f32(x, -1), x.amax(-1)
        c_attn = torch.sigmoid(self.fcn1(gap) + self.fcn2(gmp))[:, :, None]
        cat = torch.cat([mean_f32(x, 1, keepdim=True), x.amax(1, keepdim=True)], dim=1)
        return x * c_attn * torch.sigmoid(self.convsa(cat))


class EncoderCell(nn.Module):
    def __init__(self, in_ch: int, out_ch: int, kernel_size: int, padding: int):
        super().__init__()
        self.conv = Conv1d(in_ch, out_ch, kernel_size, stride=2, padding=padding)
        self.activate = APReLU(out_ch)
        self.bn = BatchNorm1d(out_ch)

    def forward(self, x):
        return self.bn(self.activate(self.conv(x)))


class DecoderCell(nn.Module):
    def __init__(self, in_ch: int, out_ch: int, kernel_size: int, padding: int,
                 last: bool = False):
        super().__init__()
        self.deconv = ConvTranspose1d(in_ch, out_ch, kernel_size, stride=2,
                                      padding=padding)
        self.activate = APReLU(out_ch)
        self.bn = BatchNorm1d(out_ch)
        self.last = last
        if not last:
            self.dam = DAM(out_ch)

    def forward(self, x):
        x = self.bn(self.activate(self.deconv(x)))
        return x if self.last else self.dam(x)


class DeNoiseEnc(nn.Module):
    def __init__(self):
        super().__init__()
        self.EncoderList = nn.ModuleList(
            EncoderCell(c_in, c_out, k, p) for c_in, c_out, k, p in
            [(2, 4, 17, 8), (4, 8, 17, 8), (8, 16, 3, 1), (16, 32, 3, 1)])


class DeNoiseDec(nn.Module):
    def __init__(self):
        super().__init__()
        self.DecoderList = nn.ModuleList(
            DecoderCell(c_in, c_out, k, p, last=i == 3) for i, (c_in, c_out, k, p) in
            enumerate([(32, 16, 4, 1), (16, 8, 4, 1), (8, 4, 18, 8), (4, 2, 18, 8)]))


def alignment_add(t1, t2):
    """Truncating skip-add (reference alignment_add, DAM.py:283-308)."""
    n = min(t1.shape[-1], t2.shape[-1])
    return t1[..., :n] + t2[..., :n]


class Seq2Seq2(nn.Module):
    """DANet on (B, 2, L). Parameters are float32; `dtype` is the compute
    dtype, as in the JAX module."""

    in_channels = 2

    def __init__(self, dtype: torch.dtype = torch.float32):
        super().__init__()
        self.dtype = dtype
        self.enc = DeNoiseEnc()
        self.dec = DeNoiseDec()

    def forward(self, x):
        x = x.to(self.dtype)
        feats = []
        for cell in self.enc.EncoderList:
            x = cell(x)
            feats.append(x)
        y = feats[-1]
        for i, cell in enumerate(self.dec.DecoderList):
            y = cell(y if i == 0 else alignment_add(y, feats[-1 - i]))
        return y
