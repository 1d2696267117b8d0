"""Tensor parallelism's region ops and the live model's shards (JAX
counterpart: the 'model' axis of parallel/mesh.py, which XLA's partitioner
turns into per-block psums).

The port shards by hand, Megatron's way. A transformer block's attention
and MLP are each one region over the model group of ranks:

* `copy_in` at the region's entry: the identity forward, the gradient
  summed over the group backward (every rank's shard of the columns
  contributes to the input's gradient);
* column-parallel `to_q`, `to_kv` and `fc1`: each rank holds its heads'
  rows of `to_q` and `to_kv` (both K and V of its heads) and its slice of
  `fc1`'s hidden units, and runs attention (B1/B2, B3/B4 or B5) on its
  local heads only;
* row-parallel `proj` and `fc2` (`row_parallel`): each rank's partial
  product in float32, `reduce_out` (the sum over the group forward, the
  identity backward), rounded to the compute dtype once, then the bias,
  replicated, added once.

Two replicated pieces sit inside a region, and each needs its gradient
made whole on every rank:

* the attention bias, built on every rank from a replicated rel-pos table
  and sliced to the rank's heads through `copy_in` (`local_heads`), so the
  table's gradient sums every rank's heads;
* LeFF's partial conv, which convolves hidden channel 0 alone: only model
  rank 0 holds that channel and applies it; its weight's gradient is made
  whole after backward (`partial_parameters`, the others adding zero;
  `parallel.mesh.all_reduce_gradients`).

`shard_modules` marks the live modules (`MSAttention.tp`, `Mlp.tp`) once
their parameters are sliced (`parallel.mesh.shard_state_dp_tp`). Nothing
here imports a model module at import time: `ops.attention` imports this.
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import Any

import torch
import torch.distributed as dist
import torch.nn.functional as F


@dataclass(frozen=True)
class TensorParallel:
    """A module's place in its model group: rank `rank` of `size`, over
    the process `group`."""
    group: Any
    rank: int
    size: int


def _summed(t: torch.Tensor, group) -> torch.Tensor:
    """`t` summed over `group`, in float32 (bf16 partials rounded once),
    returned in `t`'s dtype."""
    total = t.float().clone(memory_format=torch.contiguous_format)
    dist.all_reduce(total, group=group)
    return total.to(t.dtype)


class _CopyIn(torch.autograd.Function):
    """Identity forward; the gradient summed over the group backward."""

    @staticmethod
    def forward(ctx, t, group):
        ctx.group = group
        return t.view_as(t)

    @staticmethod
    def backward(ctx, grad):
        return _summed(grad, ctx.group), None


class _ReduceOut(torch.autograd.Function):
    """The sum over the group forward; the identity backward."""

    @staticmethod
    def forward(ctx, t, group):
        return _summed(t, group)

    @staticmethod
    def backward(ctx, grad):
        return grad, None


def copy_in(t: torch.Tensor, tp: TensorParallel) -> torch.Tensor:
    """A replicated tensor entering a region of the model group."""
    return _CopyIn.apply(t, tp.group)


def reduce_out(t: torch.Tensor, tp: TensorParallel) -> torch.Tensor:
    """The model group's partial results summed: a region's output."""
    return _ReduceOut.apply(t, tp.group)


def local_heads(mask, heads: int, tp: TensorParallel):
    """The attention bias of this rank's heads [h0, h1): a (1, H, L, L)
    tensor or an `RPosBias` whose toep is one, through `copy_in` (the whole
    table's gradient comes back on every rank); None stays None."""
    if mask is None:
        return None
    h0, h1 = tp.rank * heads // tp.size, (tp.rank + 1) * heads // tp.size
    if isinstance(mask, torch.Tensor):
        return copy_in(mask, tp)[:, h0:h1]
    return type(mask)(toep=copy_in(mask.toep, tp)[:, h0:h1], offsets=mask.offsets,
                      W=mask.W)


def row_parallel(linear: torch.nn.Linear, x: torch.Tensor, tp: TensorParallel):
    """A row-parallel Linear on this rank's input columns `x`: the partial
    products in float32 summed over the group, rounded to x's dtype once,
    then the replicated bias added once, as the Linear of one process adds
    it to its rounded product."""
    weight = linear.weight.to(x.dtype).float()
    y = reduce_out(F.linear(x.float(), weight), tp).to(x.dtype)
    return y if linear.bias is None else y + linear.bias.to(x.dtype)


# A marked module's sharded parameters and their axes: the column-parallel
# weights and biases on axis 0, the row-parallel weights on axis 1 (their
# biases replicated).
_ATTENTION_AXES = {"qkv_proj.to_q.weight": 0, "qkv_proj.to_q.bias": 0,
                   "qkv_proj.to_kv.weight": 0, "qkv_proj.to_kv.bias": 0, "proj.weight": 1}
_MLP_AXES = {"fc1.weight": 0, "fc1.bias": 0, "fc2.weight": 1}


def shard_modules(model: torch.nn.Module, tp: TensorParallel, sharded: set[str]) -> None:
    """Mark every `MSAttention` and `Mlp` of `model` whose projections are
    in `sharded` (parameter names) with `tp`, and set each sharded
    attention's count of local heads; every other module runs whole."""
    from ecg_denoise_tpu_torch.ops.attention import Mlp, MSAttention

    for name, module in model.named_modules():
        prefix = f"{name}." if name else ""
        if isinstance(module, MSAttention):
            on = f"{prefix}qkv_proj.to_q.weight" in sharded
            module.tp = tp if on else None
            module.qkv_proj.heads = module.num_heads // (tp.size if on else 1)
        elif isinstance(module, Mlp):
            module.tp = tp if f"{prefix}fc1.weight" in sharded else None


def sharded_axes(model: torch.nn.Module) -> dict[str, int]:
    """{parameter name: sharded axis} of the modules `shard_modules` marked."""
    from ecg_denoise_tpu_torch.ops.attention import Mlp, MSAttention

    params = dict(model.named_parameters())
    out = {}
    for name, module in model.named_modules():
        axes = (_ATTENTION_AXES if isinstance(module, MSAttention) else
                _MLP_AXES if isinstance(module, Mlp) else {})
        if getattr(module, "tp", None) is None:
            continue
        prefix = f"{name}." if name else ""
        out.update({prefix + k: axis for k, axis in axes.items() if prefix + k in params})
    return out


def partial_parameters(model: torch.nn.Module) -> list[torch.nn.Parameter]:
    """The trained, replicated parameters whose gradient one model rank
    alone computes: the partial conv of a sharded LeFF, which only model
    rank 0 applies."""
    from ecg_denoise_tpu_torch.ops.attention import Mlp

    return [p for m in model.modules()
            if isinstance(m, Mlp) and m.tp is not None and m.leconv is not None
            for p in m.leconv.parameters() if p.requires_grad]
