"""JAX variable trees -> the port's state_dicts.

Turns a `{"params", "batch_stats"}` tree of the JAX package (leaves given
as numpy arrays, or anything numpy can convert) into a state_dict that the
port's module loads, with the layout conversions:

* Dense kernel (in, out)      -> Linear weight (out, in)
* Conv kernel HIO (k, in, out) -> Conv1d weight (out, in, k)
* ConvTranspose kernel (k, in, out) -> ConvTranspose1d weight (in, out, k)
* LayerNorm / BatchNorm scale, bias -> weight, bias
* BatchNorm batch_stats mean, var   -> running_mean, running_var
* the rel-pos table, as it is.

A 3-D kernel alone does not say whether it is a conv's or a transpose
conv's, so each model's map names its transpose convs. There is one map a
model family: `ralenet_state_dict`, `unet_state_dict`,
`seq2seq2_state_dict` (DANet; DAM's shared FCN fills both `fcn1.*` and
`fcn2.*`), `acdae_state_dict` and `newrale_state_dict`, and one for each
classifier, `resnet_cls_state_dict` and `transformer1d_state_dict` (both
without renames: those modules keep the JAX module names).

`state_dict_for(model, variables)` picks the map by the port module's
family. This is the reverse of the JAX package's `interop/torch_weights.py`,
kept here as a copy of the logic because the port imports nothing of that
package. `adam_state_from_optax` maps the optax Adam state the same way,
so a JAX training state carries over with its weights. The trees come from
memory or, read from a JAX `.msgpack` checkpoint by `interop.flax_msgpack`,
from disk (`train.checkpoint`).
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


def _leaf(name: str, value, transposed: bool = False):
    a = np.asarray(value, np.float32)
    if name == "kernel":
        if a.ndim == 2:
            return "weight", a.T
        return "weight", a.transpose(1, 2, 0) if transposed else a.transpose(2, 1, 0)
    return _LEAF_NAMES[name], a


def state_dict_from_variables(variables: Mapping, renames: Mapping = None,
                              transposed=lambda path: False
                              ) -> dict[str, torch.Tensor]:
    """Map any JAX {"params", "batch_stats"} tree to state_dict keys,
    renaming module path segments by `renames`; `transposed(path)` is true
    for the JAX module paths (tuples of names) of transpose convs."""
    renames = renames or {}
    sd = {}
    for collection in ("params", "batch_stats"):
        for path, value in _flatten(variables.get(collection, {})):
            name, a = _leaf(path[-1], value, transposed(path[:-1]))
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


UNET_RENAMES = {
    **{f"enc{i}": f"EncList.{i}" for i in range(4)},
    **{f"dec{i}": f"DecList.{i}" for i in range(4)},
    "bottleneck_conv0": "bottleneck.0", "bottleneck_bn0": "bottleneck.2",
    "bottleneck_conv1": "bottleneck.3", "bottleneck_bn1": "bottleneck.5",
    "bottleneck_conv2": "bottleneck.6",
}
SEQ2SEQ2_RENAMES = {
    **{f"enc{i}": f"enc.EncoderList.{i}" for i in range(4)},
    **{f"dec{i}": f"dec.DecoderList.{i}" for i in range(4)},
    "aprelu": "activate",
    "fc1": "fcn.0", "bn1": "fcn.1", "fc2": "fcn.3", "bn2": "fcn.4",
    "fcn_fc1": "fcn1.0", "fcn_bn1": "fcn1.1", "fcn_fc2": "fcn1.3", "fcn_bn2": "fcn1.4",
}
ACDAE_RENAMES = {
    **{f"enc{i}_conv": f"EncList.{i}.conv" for i in range(4)},
    **{f"dec{i}_conv": f"DecList.{i}.conv" for i in range(4)},
    **{f"dec{i}_eca": f"DecList.{i}.ECA" for i in range(4)},
}


def unet_state_dict(variables: Mapping) -> dict[str, torch.Tensor]:
    """JAX UNet variables -> the port's UNet state_dict."""
    return state_dict_from_variables(
        variables, UNET_RENAMES,
        lambda path: path[0].startswith("dec") and path[-1] == "conv")


def seq2seq2_state_dict(variables: Mapping) -> dict[str, torch.Tensor]:
    """JAX Seq2Seq2 (DANet) variables -> the port's Seq2Seq2 state_dict;
    DAM's one FCN under both of its names."""
    sd = state_dict_from_variables(variables, SEQ2SEQ2_RENAMES,
                                   lambda path: path[-1] == "deconv")
    for key in [k for k in sd if ".dam.fcn1." in k]:
        sd[key.replace(".dam.fcn1.", ".dam.fcn2.")] = sd[key].clone()
    return sd


def acdae_state_dict(variables: Mapping) -> dict[str, torch.Tensor]:
    """JAX ACDAE variables -> the port's ACDAE state_dict."""
    return state_dict_from_variables(
        variables, ACDAE_RENAMES,
        lambda path: path[-1].startswith("dec") and path[-1].endswith("_conv"))


def newrale_state_dict(variables: Mapping) -> dict[str, torch.Tensor]:
    """JAX NewRale variables (the 'full' core under "rale") -> the port's
    NewRale state_dict."""
    return state_dict_from_variables(variables, RALENET_RENAMES)


def resnet_cls_state_dict(variables: Mapping) -> dict[str, torch.Tensor]:
    """JAX ResNetCls variables -> the port's ResNetCls state_dict."""
    return state_dict_from_variables(variables)


def transformer1d_state_dict(variables: Mapping) -> dict[str, torch.Tensor]:
    """JAX Transformer1d variables -> the port's Transformer1d state_dict
    (`blocks_{j}` -> `blocks.{j}`, as for RaleNet's layers)."""
    return state_dict_from_variables(variables)


def state_dict_for(model: torch.nn.Module, variables: Mapping
                   ) -> dict[str, torch.Tensor]:
    """JAX variables -> the state_dict of the port's `model`, through the
    map of its family (a RaleNet's with its variant)."""
    from ecg_denoise_tpu_torch.models import (
        ACDAE,
        NewRale,
        RaleNet,
        ResNetCls,
        Seq2Seq2,
        Transformer1d,
        UNet,
    )

    if isinstance(model, RaleNet):
        return ralenet_state_dict(variables, model.variant)
    maps = ((UNet, unet_state_dict), (Seq2Seq2, seq2seq2_state_dict),
            (ACDAE, acdae_state_dict), (NewRale, newrale_state_dict),
            (ResNetCls, resnet_cls_state_dict), (Transformer1d, transformer1d_state_dict))
    for cls, to_port in maps:
        if isinstance(model, cls):
            return to_port(variables)
    raise TypeError(f"no map from JAX variables to a {type(model).__name__}")


def adam_state_from_optax(mu: Mapping, nu: Mapping, count,
                          model: torch.nn.Module) -> dict:
    """The optax Adam state of a JAX model (its first and second moments
    `mu` and `nu`, trees shaped like "params" with numpy leaves, and its
    step `count`) as the "state" entry of the state_dict of
    `torch.optim.Adam(model.parameters())` for the port's `model`. The
    moments get the weights' renames and layout conversions, by the map of
    the model's family (`state_dict_for`). Load it with:

        sd = optimizer.state_dict()
        sd["state"] = adam_state_from_optax(mu, nu, count, model)
        optimizer.load_state_dict(sd)
    """
    try:
        exp_avg = state_dict_for(model, {"params": mu})
        exp_avg_sq = state_dict_for(model, {"params": nu})
    except ValueError as e:  # a family's map refuses the trees
        raise ValueError(f"the Adam moments do not match the model: {e}") from e
    names = [name for name, _ in model.named_parameters()]
    # A map may fill a module's second name (DANet's shared FCN): such
    # keys are in the state_dict but not among the parameters.
    keys = set(model.state_dict())
    for moments in (exp_avg, exp_avg_sq):
        if not set(names) <= set(moments) <= keys:
            raise ValueError("the Adam moments do not match the model's parameters: "
                             f"{sorted(set(names) ^ set(moments))}")
    step = float(np.asarray(count))
    return {i: {"step": torch.tensor(step), "exp_avg": exp_avg[name],
                "exp_avg_sq": exp_avg_sq[name]}
            for i, name in enumerate(names)}
