"""RA-LENet — LE-Transformer U-Net with R-wave attention
(JAX counterpart: models/ralenet.py; reference model/transformer.py:560-667
for 'full'/'mlp', model/raletransformer.py:559-683 for 'nra').

    conv stem 2->8 (k3) + LeakyReLU(0.2) + BatchNorm
    4 encoder stages: [depth TransformerBlocks -> PatchMerging], C 8->128, L 256->16
    bottleneck of depth blocks + residual
    4 decoder stages: [depth TransformerBlocks -> PatchSeparate] + encoder skips
    conv head 8->2 (k3)

Variants differ in two flags: 'nra' has no R-wave bias and LeFF on, 'mlp'
has the bias and a plain MLP, 'full' has both. Encoder stages get biases
for W = 32/16/8/4; the bottleneck and the first decoder stage get none;
decoder stages 3/2/1 reuse the biases of encoder stages 4/3/2 (one scale
coarser than their mirror — a reference quirk kept).

Attribute names are the reference's, typos included (`dtransformer34`,
`utranformer3`, `conv1[0]`/`conv1[2]`, `transconv[0]`), so a state_dict of
this module has the reference's keys and the JAX package's
`interop/torch_weights.ralenet_variables` reads it as is.
"""

from __future__ import annotations

import torch
import torch.nn as nn

from ecg_denoise_tpu_torch.ops.attention import (
    BasicLayer,
    PatchMerging,
    PatchSeparate,
    RelativePositionEmbedding,
)
from ecg_denoise_tpu_torch.ops.layers import BatchNorm1d, Conv1d

VARIANTS = ("nra", "mlp", "full")
ENCODER_NAMES = ("dtransformer1", "dtransformer2", "dtransformer3",
                 "dtransformer34")
DECODER_NAMES = {4: "utransformer4", 3: "utranformer3", 2: "utransformer2",
                 1: "utransformer1"}


class RaleNet(nn.Module):
    """RA-LENet on (B, 2, 256) windows. Parameters are float32; `dtype`
    (float32 or bfloat16) is the compute dtype, as in the JAX module.
    `train()`/`eval()` selects batch or running BatchNorm statistics."""

    in_channels = 2

    def __init__(self, variant: str = "full", depth: int = 2,
                 mlp_ratio: float = 4.0, dtype: torch.dtype = torch.float32):
        super().__init__()
        if variant not in VARIANTS:
            raise ValueError(f"variant must be one of {VARIANTS}, got {variant!r}")
        if dtype not in (torch.float32, torch.bfloat16):
            raise TypeError(f"dtype must be float32 or bfloat16, got {dtype}")
        self.variant, self.dtype = variant, dtype
        channels = [2 ** (i + 3) for i in range(5)]  # 8..128
        heads = [2 ** (i + 1) for i in range(5)]  # 2..32
        lengths = [2 ** (8 - i) for i in range(5)]  # 256..16
        windows = [32, 16, 8, 4]
        local_enhence = variant in ("nra", "full")
        self.use_bias = variant in ("mlp", "full")

        def layer(i):
            return BasicLayer(channels[i], depth, heads[i], mlp_ratio,
                              local_enhence=local_enhence)

        self.conv1 = nn.Sequential(
            Conv1d(2, channels[0], 3, padding=1),
            nn.LeakyReLU(0.2),
            BatchNorm1d(channels[0]),
        )
        if self.use_bias:
            for i in range(4):
                self.add_module(f"rwattn{i + 1}", RelativePositionEmbedding(
                    windows[i], lengths[i], heads[i], dtype=dtype))
        for i in range(4):
            self.add_module(ENCODER_NAMES[i], layer(i))
            self.add_module(f"pm{i + 1}", PatchMerging(channels[i]))
        self.transformer = layer(4)
        for i in range(4, 0, -1):
            self.add_module(DECODER_NAMES[i], layer(i))
            self.add_module(f"ps{i}", PatchSeparate(channels[i]))
        self.transconv = nn.Sequential(Conv1d(channels[0], 2, 3, padding=1))

    def forward(self, x, r_pos=None):
        """(B, 2, 256) -> (B, 2, 256) in the compute dtype. `r_pos`: None,
        a scalar R-peak position shared by the batch, or a (B,) integer
        tensor of per-window positions (`data.rpeaks.detect_r_peaks`);
        stage i takes r_pos // 2**i, floor division as in JAX."""
        stem = self.conv1(x.to(self.dtype))  # (B, 8, 256)

        attn = [None] * 4
        if self.use_bias:
            for i in range(4):
                rp = None if r_pos is None else r_pos // (2 ** i)
                attn[i] = getattr(self, f"rwattn{i + 1}")(rp)

        h = stem.transpose(1, 2)  # (B, L, C)
        skips = []
        for i in range(4):
            h = getattr(self, ENCODER_NAMES[i])(h, attn[i])
            h = getattr(self, f"pm{i + 1}")(h)
            skips.append(h)

        h = self.transformer(skips[3]) + skips[3]

        dec_masks = [None, attn[3], attn[2], attn[1]]
        for j, i in enumerate(range(4, 0, -1)):
            h = getattr(self, DECODER_NAMES[i])(h, dec_masks[j])
            h = getattr(self, f"ps{i}")(h)
            if i > 1:
                h = h + skips[i - 2]

        return self.transconv(h.transpose(1, 2) + stem)
