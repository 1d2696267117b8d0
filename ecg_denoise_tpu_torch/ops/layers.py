"""Core 1-D layers (JAX counterpart: ops/layers.py).

The layers are torch.nn's own, subclassed only to follow the JAX package's
compute-dtype rule: parameters stay float32 (the master weights) and are
cast to the activations' dtype at use, while the norms compute in float32
and return the input dtype. In bfloat16, Linear and Conv1d round the
product to bfloat16 before they add the bfloat16 bias, as the JAX layers
do (a fused bias would round once and differ in the last bit). At float32
every layer here is exactly its torch.nn base class.

Torch-compat facts the JAX package reproduces and this port gets for free:
Conv1d is cross-correlation with torch padding; ConvTranspose1d is torch's
own, weight (in, out, k); BatchNorm1d has eps 1e-5, momentum 0.1, and uses
its running stats in eval mode; LayerNorm eps is 1e-5; GELU is the exact
erf form (`F.gelu`'s default).

The pools and `linear_upsample2x` (UNet, DANet, ACDAE) are functions, as
in the JAX package; a mean computes in float32 and returns the input
dtype, as `jnp.mean` does. `EcaLayer1d` is on no model's path (only
`use_eca`, which no model sets, reaches it) and is not ported.
"""

from __future__ import annotations

import contextlib

import torch
import torch.nn as nn
import torch.nn.functional as F

from ecg_denoise_tpu_torch.parallel.mesh import all_reduce_sum


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


class ConvTranspose1d(nn.ConvTranspose1d):
    """nn.ConvTranspose1d on (B, C, L), computing in the input's dtype."""

    def forward(self, x):
        if x.dtype == torch.float32:
            return super().forward(x)
        y = F.conv_transpose1d(x, self.weight.to(x.dtype), None, self.stride,
                               self.padding, self.output_padding, self.groups,
                               self.dilation)
        return y if self.bias is None else y + self.bias.to(x.dtype)[:, None]


class LayerNorm(nn.LayerNorm):
    """LayerNorm over the last axis, eps 1e-5, computed in float32."""

    def __init__(self, normalized_shape, eps: float = 1e-5):
        super().__init__(normalized_shape, eps=eps)

    def forward(self, x):
        return super().forward(x.float()).to(x.dtype)


class BatchNorm1d(nn.BatchNorm1d):
    """BatchNorm1d on (B, C, L) or (B, C), computed in float32 (eval:
    running stats).

    In training, a batch of one value per channel (DANet's gates at batch
    1) is normalised as the JAX layer does it, with variance 0, where
    torch.nn raises: the output is the bias, the running mean moves toward
    the value and the running variance toward 0.

    With a process `group` (set by `global_batch_stats` for a data-parallel
    epoch), training statistics are the global batch's, as JAX's BatchNorm
    computes them on a batch-sharded array: each rank's count and sum, then
    its sum of squared deviations from the global mean, are all-reduced
    by `parallel.mesh.all_reduce_sum`, whose backward all-reduces the
    gradient, so every rank's gradient is the global batch's. The running
    variance is the unbiased variance of the global count (0 at a global
    count of 1, as in the one-value case). `torch.nn.SyncBatchNorm` takes
    only the card's tensors; this takes the CPU's too.
    """

    group = None

    def forward(self, x):
        if self.training and self.group is not None:
            return self._global_batch(x.float()).to(x.dtype)
        if self.training and x.numel() == x.shape[1]:
            return self._one_value_per_channel(x.float()).to(x.dtype)
        return super().forward(x.float()).to(x.dtype)

    def _global_batch(self, x):
        dims = (0,) if x.dim() == 2 else (0, 2)
        shape = (1, -1) + (1,) * (x.dim() - 2)
        sums = all_reduce_sum(torch.cat([x.sum(dims),
                                         x.new_full((1,), x.numel() / x.shape[1])]),
                              self.group)
        n = sums[-1]
        mean = sums[:-1] / n
        centred = x - mean.reshape(shape)
        var = all_reduce_sum((centred * centred).sum(dims), self.group) / n
        with torch.no_grad():
            unbiased = var * n / torch.clamp(n - 1, min=1)
            self.running_mean.mul_(1 - self.momentum).add_(self.momentum * mean)
            self.running_var.mul_(1 - self.momentum).add_(self.momentum * unbiased)
            self.num_batches_tracked += 1
        y = centred * torch.rsqrt(var + self.eps).reshape(shape)
        return y * self.weight.reshape(shape) + self.bias.reshape(shape)

    def _one_value_per_channel(self, x):
        shape = (1, -1) + (1,) * (x.dim() - 2)
        mean = x.reshape(-1)
        with torch.no_grad():
            self.running_mean.mul_(1 - self.momentum).add_(self.momentum * mean)
            self.running_var.mul_(1 - self.momentum)  # the unbiased variance is 0
            self.num_batches_tracked += 1
        y = (x - mean.reshape(shape)) * self.eps ** -0.5
        return y * self.weight.reshape(shape) + self.bias.reshape(shape)


@contextlib.contextmanager
def global_batch_stats(model: nn.Module, group):
    """Within the block, every `BatchNorm1d` of `model` takes its training
    statistics over the process `group`'s global batch; none does after."""
    norms = [m for m in model.modules() if isinstance(m, BatchNorm1d)]
    for m in norms:
        m.group = group
    try:
        yield
    finally:
        for m in norms:
            m.group = None


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


def max_pool1d(x, window: int = 2, stride: int | None = None):
    """torch.nn.MaxPool1d on (B, C, L): windows that fit, no padding."""
    return F.max_pool1d(x, window, stride or window)


def mean_f32(x, dim, keepdim: bool = False):
    """The mean over `dim` summed in float32, in x's dtype (`jnp.mean`)."""
    return x.float().mean(dim, keepdim=keepdim).to(x.dtype)


def adaptive_avg_pool1d(x):
    """AdaptiveAvgPool1d(1) on (B, C, L) -> (B, C, 1), summed in float32."""
    return mean_f32(x, -1, keepdim=True)


def linear_upsample2x(x):
    """nn.Upsample(scale_factor=2, mode='linear', align_corners=False) on
    (B, C, L) -> (B, C, 2L), written as the JAX package writes it: gather
    the two neighbours, then interpolate with float32 weights, so a
    bfloat16 input comes back float32, as it does there."""
    L = x.shape[-1]
    src = (torch.arange(2 * L, dtype=torch.float32, device=x.device) + 0.5) / 2.0 - 0.5
    lo = torch.clamp(torch.floor(src), 0, L - 1).long()
    hi = torch.clamp(lo + 1, 0, L - 1)
    w = torch.clamp(src - lo.float(), 0.0, 1.0)
    return x[..., lo] * (1.0 - w) + x[..., hi] * w
