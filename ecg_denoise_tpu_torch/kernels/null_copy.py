"""The null launch (JAX counterpart: the null `pallas_call`s of
scripts/probe_chain.py and scripts/probe_floor.py).

`null_copy(x)` returns a copy of a float32 tensor made by one kernel,
`csrc/null_copy.cu`: on a CUDA tensor it launches that kernel or raises;
on a CPU tensor it takes the plain version, `x.clone()`. With 1,024
elements it is the cheapest launch the port makes, the launch-floor probes'
null call (`ecg_denoise_tpu_torch.probes`); with an attention call's q it
is the time to move those bytes and nothing else, their "dma" floor.

`null_copy.launches` counts kernel launches (a plain int).
"""

from __future__ import annotations

import functools

import torch

from ecg_denoise_tpu_torch.kernels.attention import bind, ptr, raise_on


@functools.cache
def _library():
    """The kernel's library, built at first use."""
    return bind("null_copy", "ecg_null_copy", 2, 2)


def null_copy(x: torch.Tensor) -> torch.Tensor:
    """A copy of the float32 tensor `x` (see the module docstring)."""
    if x.dtype != torch.float32:
        raise TypeError(f"null_copy copies float32, got {x.dtype}")
    if x.device.type == "cpu":
        return x.clone()
    if x.device.type != "cuda":
        raise ValueError(f"no null_copy path for device {x.device}")
    if not x.is_contiguous() or not 0 < x.numel() < 2**31:
        raise ValueError("null_copy takes a contiguous tensor of 1 to 2**31 - 1 "
                         "elements")
    lib = _library()
    o = torch.empty_like(x)
    err = lib.ecg_null_copy(ptr(x), ptr(o), x.numel(), x.device.index,
                            torch.cuda.current_stream(x.device).cuda_stream)
    raise_on(lib, err, "null copy")
    null_copy.launches += 1
    return o


null_copy.launches = 0
