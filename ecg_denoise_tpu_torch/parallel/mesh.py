"""Data and tensor parallelism over process groups (JAX counterpart:
parallel/mesh.py: `make_mesh`, `shard_batch`, `replicate_state`,
`tp_param_spec`, `shard_state_dp_tp`).

JAX lays a ('data', 'model') mesh over the devices of one program and lets
SPMD shard the batch on 'data' and the transformer projections on
'model'. The port runs one process per card, each a rank of a
`torch.distributed` process group, and `make_mesh` lays the ranks out as
JAX's `devices.reshape(n_data, n_model)` does: rank r sits at (data r //
n_model, model r % n_model), with a process group for each row (a model
group) and each column (a data group) of that grid (`Mesh`):

* the batch: every rank holds the same global batch and takes its data
  index's contiguous rows (`shard_batch`, the layout `P("data")` gives);
  the model ranks of one data index take the same rows;
* the parameters: replicated over the data group, every rank starting
  from rank 0's (`replicate_state`); after each backward the gradients are
  averaged over the data group in one coalesced all-reduce
  (`all_reduce_gradients`), so Adam steps identically on every replica;
* BatchNorm: in training, its statistics are the global batch's
  (`ops.layers.global_batch_stats` over the data group), as JAX's SPMD
  BatchNorm computes them on a batch-sharded array;
* with n_model > 1, Megatron tensor parallelism over the model group
  (`tp_param_spec`, `shard_state_dp_tp`, `parallel.tensor`): each model
  rank holds its heads' rows of `to_q` and `to_kv` and columns of `proj`,
  its hidden units' rows of `fc1` and columns of `fc2`, with their Adam
  moments; `gather_state` puts a sharded state back in one process's
  layout for a checkpoint.

The JAX package's Pallas kernels have shard_map twins for a data mesh
(`_rpos_dp`, `_fused_dp`, `_fused_dp_nobias`): each runs the kernel on its
shard and psums the bias or Toeplitz cotangent over 'data'. Here each rank
launches the same kernels on its local batch and, under tensor
parallelism, on its local heads; the bias tables' gradients, ordinary
parameters, are made whole over the model group (`parallel.tensor`) and
averaged over the data group with the rest.

The groups run NCCL on the card and gloo on the CPU; gloo also carries
groups whose ranks share one card (NCCL refuses two ranks on one device),
when the caller names it.
"""

from __future__ import annotations

import os
from dataclasses import dataclass
from typing import Any, Optional

import torch
import torch.distributed as dist

from ecg_denoise_tpu_torch import resolve_device
from ecg_denoise_tpu_torch.parallel.tensor import (
    TensorParallel,
    partial_parameters,
    shard_modules,
    sharded_axes,
)


@dataclass(frozen=True)
class Mesh:
    """The ranks' ('data', 'model') grid: `world_size` ranks, this one
    `rank`, its `device`, the world's process `group`, `n_model` ranks a
    model group, and this rank's `data_group` (its column: the ranks of its
    model index) and `model_group` (its row: the ranks of its data index).
    With n_model = 1 the data group is the world's and there is no model
    group."""
    world_size: int
    rank: int
    device: torch.device
    group: Any
    n_model: int = 1
    data_group: Any = None
    model_group: Any = None

    def __post_init__(self):
        if self.world_size % self.n_model:
            raise ValueError(f"{self.world_size} ranks do not split into model groups of "
                             f"{self.n_model}")
        if self.n_model == 1 and self.data_group is None:
            object.__setattr__(self, "data_group", self.group)

    @property
    def n_data(self) -> int:
        return self.world_size // self.n_model

    @property
    def data_rank(self) -> int:
        """This rank's data index: its row of the grid."""
        return self.rank // self.n_model

    @property
    def model_rank(self) -> int:
        """This rank's model index: its column of the grid."""
        return self.rank % self.n_model

    @property
    def tp(self) -> Optional[TensorParallel]:
        """This rank's place in its model group, or None without one."""
        if self.n_model == 1:
            return None
        return TensorParallel(self.model_group, self.model_rank, self.n_model)

    @property
    def is_primary(self) -> bool:
        """Whether this rank writes files and prints (rank 0: data 0, model 0)."""
        return self.rank == 0


def _grid_groups(n_data: int, n_model: int, rank: int) -> tuple[Any, Any]:
    """(data group, model group) of `rank`. Every rank makes every group,
    in the same order (the model groups, then the data groups), as
    `dist.new_group` requires."""
    mine = {}
    for axis, groups in (("model", [[d * n_model + m for m in range(n_model)]
                                    for d in range(n_data)]),
                         ("data", [[d * n_model + m for d in range(n_data)]
                                   for m in range(n_model)])):
        for ranks in groups:
            group = dist.new_group(ranks)
            if rank in ranks:
                mine[axis] = group
    return mine["data"], mine["model"]


def make_mesh(n_data: Optional[int] = None, n_model: int = 1, device=None,
              backend: Optional[str] = None) -> Mesh:
    """The ('data', 'model') grid of this process's ranks.

    Under a process group already initialised (a launcher's, through
    `multihost.initialize`, or a spawned worker's), the group's world size
    must be n_data * n_model; `n_data` None takes world // n_model, as
    JAX's `make_mesh` takes the devices. Without one, only a grid of one
    rank is made, a group of this process alone. `device` defaults to the
    card of this process's LOCAL_RANK. `backend` defaults to NCCL on the
    card and gloo on the CPU; a group that exists must run the backend
    named."""
    if n_model < 1:
        raise ValueError(f"n_model={n_model} must be at least 1")
    device = resolve_device(device)
    if device.type == "cuda":
        if device.index is None:
            device = torch.device("cuda", int(os.environ.get("LOCAL_RANK", "0")))
        if device.index >= torch.cuda.device_count():
            raise RuntimeError(f"this rank's card is cuda:{device.index}, but "
                               f"{torch.cuda.device_count()} cards are visible")
        torch.cuda.set_device(device)
    backend = backend or ("nccl" if device.type == "cuda" else "gloo")
    if not dist.is_initialized():
        want = (n_data or 1) * n_model
        if want != 1:
            raise ValueError(
                f"(n_data, n_model) = ({n_data}, {n_model}) needs {want} processes: start "
                f"them with `torchrun --nproc_per_node {want}`, or `cli.main --n_data "
                f"{n_data or 1} --n_model {n_model}` alone")
        dist.init_process_group(backend, store=dist.HashStore(), world_size=1, rank=0)
    elif dist.get_backend() != backend:
        raise ValueError(f"the process group runs {dist.get_backend()}, not {backend}")
    world, rank = dist.get_world_size(), dist.get_rank()
    if n_data is None:
        n_data = world // n_model
    if n_data * n_model != world:
        raise ValueError(f"n_data={n_data} x n_model={n_model} = {n_data * n_model}, but "
                         f"the process group has {world} ranks")
    if n_model == 1:
        return Mesh(world, rank, device, dist.group.WORLD)
    data_group, model_group = _grid_groups(n_data, n_model, rank)
    return Mesh(world, rank, device, dist.group.WORLD, n_model, data_group, model_group)


def shard_batch(t: torch.Tensor, mesh: Mesh) -> torch.Tensor:
    """This rank's rows of a global batch: [d B/n, (d+1) B/n) for its data
    index d of n."""
    b, n, d = t.shape[0], mesh.n_data, mesh.data_rank
    if b % n:
        raise ValueError(f"a batch of {b} does not split over {n} ranks")
    rows = b // n
    return t[d * rows:(d + 1) * rows]


def _broadcast(t: torch.Tensor, mesh: Mesh) -> None:
    """`t` in place from rank 0 (through the mesh's device where `t` lies
    elsewhere: NCCL takes only the card's tensors)."""
    if t.device == mesh.device:
        dist.broadcast(t, 0, group=mesh.group)
        return
    on_device = t.to(mesh.device)
    dist.broadcast(on_device, 0, group=mesh.group)
    t.copy_(on_device)


def replicate_state(state, mesh: Mesh):
    """Every rank's model (parameters and buffers) and Adam state set to
    rank 0's; returns `state`."""
    with torch.no_grad():
        for t in (*state.model.parameters(), *state.model.buffers()):
            _broadcast(t, mesh)
        for group in state.optimizer.param_groups:
            for p in group["params"]:
                for key in sorted(state.optimizer.state.get(p, {})):
                    value = state.optimizer.state[p][key]
                    if isinstance(value, torch.Tensor):
                        _broadcast(value, mesh)
    return state


def _mean_over(params, grads, group, count) -> None:
    """Each of `params`' gradient set to its slice of `grads` (one per
    parameter) summed over `group` in one all-reduce, divided by `count`."""
    if not params:
        return
    flat = torch.cat([g.reshape(-1) for g in grads])
    dist.all_reduce(flat, group=group)
    flat /= count
    # Each gradient becomes its slice of the reduced buffer: no copy back.
    for p, grad in zip(params, flat.split([p.numel() for p in params])):
        p.grad = grad.view_as(p)


def all_reduce_gradients(model: torch.nn.Module, mesh: Mesh) -> None:
    """Average every parameter's gradient over the data group, in one
    all-reduce. Parameters without a gradient (frozen, or on no path of
    this step: the same ones on every rank) keep none.

    Under tensor parallelism a shard's gradient is averaged over the data
    group (the ranks holding the same shard), and every replicated
    parameter's over the whole grid: the model ranks compute it alike, but
    a kernel whose sums follow thread or atomic order (cuDNN's weight
    gradients; the CPU's threads, on a rel-pos table's) can make them
    differ in the last bit, and the mean steps every replica bit for bit
    alike. A gradient that model rank 0 alone computes
    (`parallel.tensor.partial_parameters`, the others adding zero) is
    weighted by n_model, so that it too comes out the data group's mean."""
    tp = mesh.tp
    if tp is None:
        params = [p for p in model.parameters() if p.grad is not None]
        _mean_over(params, [p.grad for p in params], mesh.data_group, mesh.n_data)
        return
    partial = {id(p) for p in partial_parameters(model)}
    axes = sharded_axes(model)
    sharded = {id(p) for n, p in model.named_parameters() if n in axes}
    shards = [p for p in model.parameters() if id(p) in sharded and p.grad is not None]
    _mean_over(shards, [p.grad for p in shards], mesh.data_group, mesh.n_data)

    def weighted(p):
        if p.grad is None:  # a partial parameter off model rank 0
            return torch.zeros_like(p)
        return p.grad * tp.size if id(p) in partial else p.grad

    replicated = [p for p in model.parameters() if id(p) not in sharded
                  and (p.grad is not None or id(p) in partial)]
    _mean_over(replicated, [weighted(p) for p in replicated], mesh.group, mesh.world_size)


class _AllReduceSum(torch.autograd.Function):
    """A sum over the ranks whose gradient is the sum of the ranks'
    gradients: every rank's input feeds every rank's output."""

    @staticmethod
    def forward(ctx, t, group):
        ctx.group = group
        t = t.clone(memory_format=torch.contiguous_format)
        dist.all_reduce(t, group=group)
        return t

    @staticmethod
    def backward(ctx, grad):
        grad = grad.clone(memory_format=torch.contiguous_format)
        dist.all_reduce(grad, group=ctx.group)
        return grad, None


def all_reduce_sum(t: torch.Tensor, group) -> torch.Tensor:
    """`t` summed over the process `group`'s ranks (a new tensor), with
    autograd through the sum."""
    return _AllReduceSum.apply(t, group)


# Megatron's rules for the transformer projections (JAX: `_COL_PARALLEL`,
# `_ROW_PARALLEL`): column-parallel layers shard their outputs, row-parallel
# ones their inputs.
_COL_PARALLEL = ("to_q", "to_kv", "fc1")
_ROW_PARALLEL = ("proj", "fc2")
_ATTENTION_PROJECTIONS = ("to_q", "to_kv", "proj")


def tp_param_spec(name: str, tensor: torch.Tensor, n_model: int,
                  heads: Optional[int] = None) -> Optional[int]:
    """The axis of parameter `name` (a state_dict name of the port) that
    the model group shards, or None where it is replicated: JAX's
    `tp_param_spec` on the port's layout. Only a parameter under an `attn`,
    `mlp` or `qkv*` module is sharded: the weight of `to_q`, `to_kv` and
    `fc1` on its outputs (axis 0), and their biases; the weight of `proj`
    and `fc2` on its inputs (axis 1), their biases replicated; each where
    n_model divides that axis.

    One deliberate difference: an attention's projections are sharded by
    whole heads, so `heads` (its head count, where known) must divide too,
    and `to_kv`, one (2, heads, head_dim) projection, gives each rank the
    K and the V rows of its heads, where JAX cuts it into its K and V
    halves."""
    parts = name.split(".")
    if n_model == 1 or len(parts) < 2 or tensor.dim() == 0:
        return None
    if not any(p in ("attn", "mlp") or p.startswith("qkv") for p in parts):
        return None
    parent, leaf = parts[-2], parts[-1]
    if parent in _ATTENTION_PROJECTIONS and heads is not None and heads % n_model:
        return None
    if parent == "to_kv" and tensor.shape[0] % (2 * n_model):
        return None
    if parent in _COL_PARALLEL and leaf in ("weight", "bias"):
        return 0 if tensor.shape[0] % n_model == 0 else None
    if parent in _ROW_PARALLEL and leaf == "weight":
        return 1 if tensor.shape[1] % n_model == 0 else None
    return None


def tp_param_specs(model: torch.nn.Module, n_model: int) -> dict[str, int]:
    """{name: sharded axis} over `model`'s parameters that `tp_param_spec`
    shards, each attention's projections with its head count."""
    from ecg_denoise_tpu_torch.ops.attention import MSAttention

    heads = {f"{name}.": m.num_heads for name, m in model.named_modules()
             if isinstance(m, MSAttention)}
    specs = {}
    for name, p in model.named_parameters():
        h = next((n for prefix, n in heads.items() if name.startswith(prefix)), None)
        axis = tp_param_spec(name, p, n_model, h)
        if axis is not None:
            specs[name] = axis
    return specs


def _local(name: str, t: torch.Tensor, axis: int, tp: TensorParallel) -> torch.Tensor:
    """Model rank tp.rank's shard of the full `t` along `axis`; `to_kv`'s
    are the K and the V rows of its heads."""
    if name.endswith(("to_kv.weight", "to_kv.bias")):
        halves = t.reshape(2, t.shape[0] // 2, *t.shape[1:])
        return _local("", halves, 1, tp).reshape(-1, *t.shape[1:])
    size = t.shape[axis] // tp.size
    return t.narrow(axis, tp.rank * size, size)


def _gathered(name: str, t: torch.Tensor, axis: int, tp: TensorParallel) -> torch.Tensor:
    """The full tensor of the model group's shards `t` (`_local`'s inverse)."""
    shards = [torch.empty_like(t) for _ in range(tp.size)]
    dist.all_gather(shards, t.contiguous(), group=tp.group)
    if name.endswith(("to_kv.weight", "to_kv.bias")):
        halves = [s.reshape(2, s.shape[0] // 2, *s.shape[1:]) for s in shards]
        return torch.cat(halves, 1).reshape(-1, *t.shape[1:])
    return torch.cat(shards, axis)


def shard_state_dp_tp(state, mesh: Mesh):
    """Every rank's state set to rank 0's (`replicate_state`), then each
    parameter that `tp_param_specs` shards replaced in place by this model
    rank's shard, its Adam moments too where Adam holds them (a resumed
    state; a fresh one has none); frozen parameters, outside Adam, are
    sharded alike. The model's attention and MLP modules are marked to run
    their regions over the model group (`parallel.tensor`). Returns
    `state`."""
    replicate_state(state, mesh)
    tp = mesh.tp
    if tp is None:
        return state
    specs = tp_param_specs(state.model, mesh.n_model)
    with torch.no_grad():
        for name, p in state.model.named_parameters():
            if name not in specs:
                continue
            p.data = _local(name, p.data, specs[name], tp).clone()
            moments = state.optimizer.state.get(p, {})
            for key in ("exp_avg", "exp_avg_sq"):
                if key in moments:
                    moments[key] = _local(name, moments[key], specs[name], tp).clone()
    shard_modules(state.model, tp, set(specs))
    if sharded_axes(state.model) != specs:
        raise ValueError("the sharding rules split a module's projections apart: "
                         f"{sorted(set(specs) ^ set(sharded_axes(state.model)))}")
    return state


def gather_named(tensors: dict, model: torch.nn.Module, mesh: Mesh) -> dict:
    """`tensors`, keyed by `model`'s parameter names (its state_dict, its
    gradients) and each shaped as this rank's shard, in one process's
    layout; a name that is not sharded passes as it is. Every rank of the
    model group calls it, with the same names in the same order."""
    tp = mesh.tp
    if tp is None:
        return dict(tensors)
    axes = sharded_axes(model)
    return {k: _gathered(k, v, axes[k], tp) if k in axes else v for k, v in tensors.items()}


def gather_state(state, mesh: Mesh) -> dict:
    """One process's checkpoint of a state sharded by `shard_state_dp_tp`:
    {"model": the full state_dict, "optimizer": the full Adam state_dict},
    `to_kv` in one process's (and JAX's) layout, the shape
    `train.save_checkpoint` writes. Every rank of the model group calls it
    (the shards are all-gathered); without tensor parallelism it is the
    state's own."""
    model = state.model
    opt_sd = state.optimizer.state_dict()
    names = {id(p): n for n, p in model.named_parameters()}
    order = [names[id(p)] for g in state.optimizer.param_groups for p in g["params"]]
    # Adam's moments are shaped as their parameter, and sharded as it is.
    opt_sd["state"] = {
        i: {k: gather_named({order[i]: v}, model, mesh)[order[i]]
            if k in ("exp_avg", "exp_avg_sq") else v for k, v in moments.items()}
        for i, moments in opt_sd["state"].items()}
    return {"model": gather_named(model.state_dict(), model, mesh), "optimizer": opt_sd}
