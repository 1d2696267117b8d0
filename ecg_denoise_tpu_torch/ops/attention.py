"""RA-LENet transformer primitives (JAX counterpart: ops/attention.py).

The reference transformer stack (reference model/transformer.py:16-506)
with the quirks the JAX package documents, each kept because it changes
the output:

* TransformerBlock re-injects the absolute PE in EVERY block as
  `x*sqrt(dim) + PE` inside the attention branch only; the residual
  shortcut is the pre-PE input (reference transformer.py:383-405).
* PatchSeparate maps channels to length by CONCATENATION: the first half
  of the channels becomes the first half of the doubled length
  (reference transformer.py:418-424) — not the inverse of PatchMerging.
* The LeFF local-enhance conv is a PartialConv1d with n_div == hidden, so
  only ONE hidden channel is convolved.
* The R-wave relative-position table is zero-initialised, and its W-window
  bias is embedded at (L-W)//2, or at r_pos - W//2, truncated at the edges
  like the reference's negative F.pad (transformer.py:534-558).

The attention itself goes through `kernels.attention.fused_attention`:
the Hopper kernel for CUDA tensors, its plain version on the CPU. The
per-window `RPosBias` (r_pos per window) comes with the r_pos slice.
"""

from __future__ import annotations

import math
from typing import Optional

import torch
import torch.nn as nn
import torch.nn.functional as F

from ecg_denoise_tpu_torch.kernels.attention import fused_attention
from ecg_denoise_tpu_torch.ops.layers import LayerNorm, Linear, PartialConv1d


def sinusoidal_pe_table(max_len: int, num_hiddens: int) -> torch.Tensor:
    """Sinusoidal absolute PE table (1, max_len, num_hiddens), float32:
    even channels sin, odd channels cos, frequency 10000^(2i/d)
    (reference AbsPositionalEncoding, transformer.py:166-181)."""
    pos = torch.arange(max_len, dtype=torch.float32)[:, None]
    freqs = torch.pow(10000.0, torch.arange(0, num_hiddens, 2,
                                            dtype=torch.float32) / num_hiddens)
    angles = pos / freqs
    table = torch.zeros(max_len, num_hiddens)
    table[:, 0::2] = torch.sin(angles)
    table[:, 1::2] = torch.cos(angles[:, :num_hiddens // 2])
    return table[None]


def multi_head_attention(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                         bias: Optional[torch.Tensor]) -> torch.Tensor:
    """softmax(q @ k^T + bias) @ v over (B, H, L, D) operands; q is
    pre-scaled, bias is None or a (1, H, L, L) tensor."""
    return fused_attention(q, k, v, bias)


class LinearProjection(nn.Module):
    """Q/KV projection (reference LinearProjection, transformer.py:183-247)."""

    def __init__(self, dim: int, heads: int, dim_head: int, bias: bool = True):
        super().__init__()
        inner = heads * dim_head
        self.heads, self.dim_head = heads, dim_head
        self.to_q = Linear(dim, inner, bias=bias)
        self.to_kv = Linear(dim, 2 * inner, bias=bias)

    def forward(self, x):
        """(B, N, dim) -> q, k, v as contiguous (B, heads, N, dim_head)."""
        B, N, _ = x.shape
        q = self.to_q(x).reshape(B, N, self.heads, self.dim_head)
        kv = self.to_kv(x).reshape(B, N, 2, self.heads, self.dim_head)
        q = q.permute(0, 2, 1, 3).contiguous()
        kv = kv.permute(2, 0, 3, 1, 4).contiguous()
        return q, kv[0], kv[1]


class MSAttention(nn.Module):
    """Multi-head self-attention with an optional additive bias
    (reference MSAttention, transformer.py:250-323)."""

    def __init__(self, dim: int, num_heads: int, qkv_bias: bool = True,
                 qk_scale: Optional[float] = None):
        super().__init__()
        self.num_heads = num_heads
        head_dim = dim // num_heads
        self.scale = qk_scale or head_dim ** -0.5
        self.qkv_proj = LinearProjection(dim, num_heads, head_dim, qkv_bias)
        self.proj = Linear(dim, dim)

    def forward(self, x, mask=None):
        B, N, _ = x.shape
        q, k, v = self.qkv_proj(x)
        out = multi_head_attention(q * self.scale, k, v, mask)
        return self.proj(out.transpose(1, 2).reshape(B, N, -1))


class Mlp(nn.Module):
    """Feed-forward (reference Mlp, transformer.py:118-161): fc1 -> GELU ->
    [LeFF: partial conv over length -> GELU] -> fc2. Dropout is 0 on every
    exercised path. The depthwise-conv and ECA options are not on
    RA-LENet's path and are not ported."""

    def __init__(self, in_features: int, hidden_features: Optional[int] = None,
                 out_features: Optional[int] = None, local_enhence: bool = False):
        super().__init__()
        hidden = hidden_features or in_features
        self.fc1 = Linear(in_features, hidden)
        self.leconv = PartialConv1d(hidden, hidden) if local_enhence else None
        self.fc2 = Linear(hidden, out_features or in_features)

    def forward(self, x):  # (B, L, C)
        x = F.gelu(self.fc1(x))
        if self.leconv is not None:
            x = F.gelu(self.leconv(x.transpose(1, 2))).transpose(1, 2)
        return self.fc2(x)


class TransformerBlock(nn.Module):
    """Pre-norm block with per-block PE re-injection
    (reference TransformerBlock, transformer.py:325-411)."""

    def __init__(self, dim: int, num_heads: int, mlp_ratio: float = 4.0,
                 qkv_bias: bool = True, qk_scale: Optional[float] = None,
                 local_enhence: bool = False):
        super().__init__()
        self.dim = dim
        self.register_buffer("pe", sinusoidal_pe_table(1000, dim),
                             persistent=False)
        self.norm1 = LayerNorm(dim)
        self.attn = MSAttention(dim, num_heads, qkv_bias, qk_scale)
        self.norm2 = LayerNorm(dim)
        self.mlp = Mlp(dim, int(dim * mlp_ratio), local_enhence=local_enhence)

    def forward(self, x, mask=None):  # (B, L, C)
        # Attention branch: PE inject -> LN -> MSA; residual from pre-PE x.
        # sqrt(dim) is rounded to the compute dtype first, as JAX rounds a
        # python scalar to the array's dtype.
        scale = torch.tensor(math.sqrt(self.dim), dtype=x.dtype).item()
        h = x * scale + self.pe[:, :x.shape[1]].to(x.dtype)
        x = x + self.attn(self.norm1(h), mask)
        return x + self.mlp(self.norm2(x))


class BasicLayer(nn.Module):
    """A stack of TransformerBlocks sharing one attention bias
    (reference BasicLayer, transformer.py:462-506)."""

    def __init__(self, dim: int, depth: int, num_heads: int,
                 mlp_ratio: float = 4.0, local_enhence: bool = False):
        super().__init__()
        self.blocks = nn.ModuleList(
            TransformerBlock(dim, num_heads, mlp_ratio,
                             local_enhence=local_enhence)
            for _ in range(depth))

    def forward(self, x, mask=None):
        for block in self.blocks:
            x = block(x, mask)
        return x


class PatchMerging(nn.Module):
    """L -> L/2, C -> 2C by even/odd interleave + LN + Linear(2C, 2C, no
    bias) (reference PatchMerging, transformer.py:426-460)."""

    def __init__(self, dim: int):
        super().__init__()
        self.norm = LayerNorm(2 * dim)
        self.reduction = Linear(2 * dim, 2 * dim, bias=False)

    def forward(self, x):  # (B, L, C)
        if x.shape[1] % 2:
            x = F.pad(x, (0, 0, 0, 1))
        x = torch.cat([x[:, 0::2], x[:, 1::2]], dim=-1)
        return self.reduction(self.norm(x))


class PatchSeparate(nn.Module):
    """L -> 2L, C -> C/2 by channel-half CONCATENATION along length + LN +
    Linear(C/2, C/2, no bias) (reference PatchSeparate,
    transformer.py:412-424)."""

    def __init__(self, dim: int):
        super().__init__()
        half = dim // 2
        self.norm = LayerNorm(half)
        self.reduction = Linear(half, half, bias=False)

    def forward(self, x):  # (B, L, C)
        half = x.shape[-1] // 2
        x = torch.cat([x[..., :half], x[..., half:]], dim=1)
        return self.reduction(self.norm(x))


class RelativePositionEmbedding(nn.Module):
    """R-wave windowed relative-position attention bias (reference
    RelativePositionEmbedding + mask_fill, transformer.py:508-558).

    A learnable (2W-1, H) table, zero-initialised, gathered into an
    (H, W, W) local bias and embedded into a (1, H, L, L) bias at window
    start (L-W)//2, or r_pos - W//2 for a scalar R-peak position. A window
    hanging over an edge is truncated (the reference's negative F.pad),
    not shifted in-bounds.
    """

    def __init__(self, length: int, whole_length: int, num_heads: int,
                 dtype: torch.dtype = torch.float32):
        super().__init__()
        self.W, self.L, self.H = length, whole_length, num_heads
        self.dtype = dtype
        self.relative_position_bias_table = nn.Parameter(
            torch.zeros(2 * length - 1, num_heads))
        coords = torch.arange(length)
        self.register_buffer(
            "rel", (coords[:, None] - coords[None, :] + length - 1).reshape(-1),
            persistent=False)

    def forward(self, r_pos=None):
        W, L, H = self.W, self.L, self.H
        if r_pos is None:
            offset = (L - W) // 2
        elif torch.as_tensor(r_pos).dim() == 0:
            offset = int(r_pos) - W // 2
        else:
            raise NotImplementedError(
                "per-window r_pos (RPosBias) comes with the r_pos slice")
        table = self.relative_position_bias_table
        local = table[self.rel].reshape(W, W, H).permute(2, 0, 1)  # (H, W, W)
        big = table.new_zeros(H, L + 2 * W, L + 2 * W)
        off = min(max(offset + W, 0), L + W)
        big[:, off:off + W, off:off + W] = local
        return big[None, :, W:W + L, W:W + L].to(self.dtype).contiguous()
