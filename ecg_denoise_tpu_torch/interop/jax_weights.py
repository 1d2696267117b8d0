"""JAX variable trees -> the port's state_dicts.

Turns a `{"params", "batch_stats"}` tree of the JAX package (leaves given
as numpy arrays, or anything numpy can convert) into a state_dict that the
port's module loads, with the layout conversions:

* Dense kernel (in, out)      -> Linear weight (out, in)
* Conv kernel HIO (k, in, out) -> Conv1d weight (out, in, k)
* LayerNorm / BatchNorm scale, bias -> weight, bias
* BatchNorm batch_stats mean, var   -> running_mean, running_var
* the rel-pos table, as it is.

This is the reverse of the JAX package's `interop/torch_weights.py`, kept
here as a copy of the logic because the port imports nothing of that
package. Loading a trained JAX `.msgpack` checkpoint waits for the
checkpoint slice; this maps trees already in memory.
"""

from __future__ import annotations

import re
from collections.abc import Mapping

import numpy as np
import torch

from ecg_denoise_tpu_torch.models.ralenet import DECODER_NAMES, ENCODER_NAMES

_LEAF_NAMES = {"scale": "weight", "bias": "bias", "mean": "running_mean",
               "var": "running_var",
               "relative_position_bias_table": "relative_position_bias_table"}

# JAX module names -> the port's (reference) attribute paths for RaleNet.
RALENET_RENAMES = {
    "conv1_conv": "conv1.0",
    "conv1_bn": "conv1.2",
    "transconv": "transconv.0",
    **{f"dtransformer{i + 1}": n for i, n in enumerate(ENCODER_NAMES)},
    **{f"utransformer{i}": n for i, n in DECODER_NAMES.items()},
}


def _flatten(tree, prefix=()):
    for key, val in tree.items():
        if isinstance(val, Mapping):
            yield from _flatten(val, prefix + (key,))
        else:
            yield prefix + (key,), val


def _module_path(path, renames) -> str:
    segs = []
    for seg in path:
        seg = renames.get(seg, seg)
        m = re.fullmatch(r"blocks_(\d+)", seg)
        segs.append(f"blocks.{m.group(1)}" if m else seg)
    return ".".join(segs)


def _leaf(name: str, value):
    a = np.asarray(value, np.float32)
    if name == "kernel":
        return "weight", a.T if a.ndim == 2 else a.transpose(2, 1, 0)
    return _LEAF_NAMES[name], a


def state_dict_from_variables(variables: Mapping, renames: Mapping = None
                              ) -> dict[str, torch.Tensor]:
    """Map any JAX {"params", "batch_stats"} tree to state_dict keys,
    renaming module path segments by `renames`."""
    renames = renames or {}
    sd = {}
    for collection in ("params", "batch_stats"):
        for path, value in _flatten(variables.get(collection, {})):
            name, a = _leaf(path[-1], value)
            module = _module_path(path[:-1], renames)
            prefix = f"{module}." if module else ""
            sd[prefix + name] = torch.tensor(a)  # a copy: JAX arrays convert read-only
            if name == "running_mean":
                sd[prefix + "num_batches_tracked"] = torch.tensor(0)
    return sd


def ralenet_state_dict(variables: Mapping, variant: str
                       ) -> dict[str, torch.Tensor]:
    """JAX RaleNet variables -> the port's RaleNet(variant) state_dict."""
    has_tables = any(k.startswith("rwattn") for k in variables["params"])
    if has_tables != (variant in ("mlp", "full")):
        raise ValueError(f"variables {'have' if has_tables else 'lack'} the "
                         f"rel-pos tables, which variant {variant!r} "
                         f"{'lacks' if has_tables else 'needs'}")
    return state_dict_from_variables(variables, RALENET_RENAMES)
