"""Data parallelism over a process group (JAX counterpart:
parallel/mesh.py's `make_mesh`, `shard_batch` and `replicate_state`).

JAX lays a ('data', 'model') mesh over the devices of one program and lets
SPMD shard the batch on 'data'. The port runs one process per card, each a
rank of a `torch.distributed` process group, and `make_mesh` describes that
group (`Mesh`):

* the batch: every rank holds the same global batch and takes its
  contiguous rows (`shard_batch`, the layout `P("data")` gives device r);
* the parameters: replicated, every rank starting from rank 0's
  (`replicate_state`); after each backward the gradients are averaged over
  the ranks in one coalesced all-reduce (`all_reduce_gradients`), so Adam
  steps identically everywhere;
* BatchNorm: in training, its statistics are the global batch's
  (`ops.layers.global_batch_stats`), as JAX's SPMD BatchNorm computes them
  on a batch-sharded array.

The JAX package's Pallas kernels have shard_map twins for a data mesh
(`_rpos_dp`, `_fused_dp`, `_fused_dp_nobias`): each runs the kernel on its
shard and psums the bias or Toeplitz cotangent over 'data'. Here each rank
launches the same kernels on its local batch, and the bias tables'
gradients, ordinary parameters, are averaged with the rest.

The group runs NCCL on the card and gloo on the CPU; gloo also carries a
group whose ranks share one card (NCCL refuses two ranks on one device),
when the caller names it. Tensor parallelism (`--n_model > 1`,
`tp_param_spec`, `shard_state_dp_tp`) is not ported (ROADMAP.md A19).
"""

from __future__ import annotations

import os
from dataclasses import dataclass
from typing import Any, Optional

import torch
import torch.distributed as dist

from ecg_denoise_tpu_torch import resolve_device

TENSOR_PARALLEL = ("tensor parallelism (--n_model > 1) is not ported yet "
                   "(ROADMAP.md A19, slice 14)")


@dataclass(frozen=True)
class Mesh:
    """A data-parallel group: `world_size` ranks, this one `rank`, its
    `device` and the process `group`."""
    world_size: int
    rank: int
    device: torch.device
    group: Any

    @property
    def is_primary(self) -> bool:
        """Whether this rank writes files and prints (rank 0)."""
        return self.rank == 0


def make_mesh(n_data: Optional[int] = None, n_model: int = 1, device=None,
              backend: Optional[str] = None) -> Mesh:
    """The data-parallel group of this process.

    Under a process group already initialised (a launcher's, through
    `multihost.initialize`, or a spawned worker's), the group's world size
    is the data axis: `n_data` None takes it, any other value must equal
    it. Without one, `n_data` must be None or 1, and a group of this
    process alone is made. `device` defaults to the card of this process's
    LOCAL_RANK. `backend` defaults to NCCL on the card and gloo on the CPU;
    a group that exists must run the backend named."""
    if n_model != 1:
        raise NotImplementedError(TENSOR_PARALLEL)
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
        if n_data not in (None, 1):
            raise ValueError(
                f"n_data={n_data} needs {n_data} processes: start them with `torchrun "
                f"--nproc_per_node {n_data}`, or `cli.main --n_data {n_data}` alone")
        dist.init_process_group(backend, store=dist.HashStore(), world_size=1, rank=0)
    elif dist.get_backend() != backend:
        raise ValueError(f"the process group runs {dist.get_backend()}, not {backend}")
    world = dist.get_world_size()
    if n_data is not None and n_data != world:
        raise ValueError(f"n_data={n_data}, but the process group has {world} ranks")
    return Mesh(world, dist.get_rank(), device, dist.group.WORLD)


def shard_batch(t: torch.Tensor, mesh: Mesh) -> torch.Tensor:
    """This rank's rows of a global batch: [r B/n, (r+1) B/n)."""
    b = t.shape[0]
    if b % mesh.world_size:
        raise ValueError(f"a batch of {b} does not split over {mesh.world_size} ranks")
    rows = b // mesh.world_size
    return t[mesh.rank * rows:(mesh.rank + 1) * rows]


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


def all_reduce_gradients(model: torch.nn.Module, mesh: Mesh) -> None:
    """Average every parameter's gradient over the ranks, in one
    all-reduce. Parameters without a gradient (frozen, or on no path of
    this step: the same ones on every rank) keep none."""
    params = [p for p in model.parameters() if p.grad is not None]
    if not params:
        return
    flat = torch.cat([p.grad.reshape(-1) for p in params])
    dist.all_reduce(flat, group=mesh.group)
    flat /= mesh.world_size
    # Each gradient becomes its slice of the reduced buffer: no copy back.
    for p, grad in zip(params, flat.split([p.numel() for p in params])):
        p.grad = grad.view_as(p)


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
