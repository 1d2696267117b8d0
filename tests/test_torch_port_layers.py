"""The port's layers and transformer blocks against the JAX package's.

Inputs and weights are made from a seed with numpy and handed to both
sides; JAX runs on the CPU and the port with device="cpu". Tolerance 1e-5
at float32: both sides compute the same float32 arithmetic, in other
summation orders.
"""

import ast
from pathlib import Path

import numpy as np
import pytest
import torch
torch.set_num_threads(1)  # six test workers share the host's cores: one intra-op thread each
import jax
import jax.numpy as jnp
from flax.traverse_util import flatten_dict, unflatten_dict

import ecg_denoise_tpu.ops.attention as jatt
import ecg_denoise_tpu.ops.layers as jlay
import ecg_denoise_tpu_torch as port
from ecg_denoise_tpu_torch.interop.jax_weights import state_dict_from_variables
from ecg_denoise_tpu_torch.ops import attention as patt
from ecg_denoise_tpu_torch.ops import layers as play

REPO = Path(__file__).resolve().parents[1]
ATOL = 1e-5
BF16 = jnp.bfloat16


def random_variables(module, *args, seed=0):
    """Numpy variables of `module`'s shapes: torch-scale uniform kernels,
    norm scales near 1, nonzero biases, stats and rel-pos tables."""
    rng = np.random.default_rng(seed)
    shapes = jax.eval_shape(module.init, jax.random.PRNGKey(0), *args)
    out = {}
    for path, s in flatten_dict(shapes).items():
        leaf = path[-1]
        if leaf == "kernel":
            a = rng.uniform(-1, 1, s.shape) / np.sqrt(np.prod(s.shape[:-1]))
        elif leaf == "scale":
            a = 1 + 0.1 * rng.standard_normal(s.shape)
        elif leaf == "var":
            a = rng.uniform(0.5, 1.5, s.shape)
        elif leaf == "relative_position_bias_table":
            a = rng.standard_normal(s.shape)
        else:
            a = 0.1 * rng.standard_normal(s.shape)
        out[path] = a.astype(np.float32)
    return unflatten_dict(out)


def _port(module, variables):
    module.load_state_dict(state_dict_from_variables(variables))
    return module.eval()


def _x(*shape, seed=1):
    return np.random.default_rng(seed).standard_normal(shape).astype(np.float32)


def _close(torch_out, jax_out, atol=ATOL):
    np.testing.assert_allclose(torch_out.detach().numpy(), np.asarray(jax_out),
                               atol=atol, rtol=0)


def test_partial_conv_convolves_one_channel():
    x = _x(2, 16, 32)
    jm = jlay.PartialConv1d(16, 16)
    v = random_variables(jm, jnp.asarray(x))
    pm = _port(play.PartialConv1d(16, 16), v)
    y = pm(torch.from_numpy(x))
    _close(y, jm.apply(v, x))
    np.testing.assert_array_equal(y[:, 1:].detach().numpy(), x[:, 1:])


@pytest.mark.parametrize("cls,args", [
    (play.Linear, (8, 16)),
    (play.Conv1d, (8, 16, 3)),
    (play.LayerNorm, (8,)),
    (play.BatchNorm1d, (8,)),
])
def test_layers_follow_the_compute_dtype(cls, args):
    """float32: exactly the torch.nn base layer; bfloat16 input: bfloat16
    output from float32 parameters."""
    m = cls(*args).eval()
    base = cls.__mro__[1]
    x = torch.from_numpy(_x(4, 8, 8))
    torch.testing.assert_close(m(x), base.forward(m, x), atol=0, rtol=0)
    y = m(x.to(torch.bfloat16))
    assert y.dtype == torch.bfloat16
    assert all(p.dtype == torch.float32 for p in m.parameters())


def test_sinusoidal_pe_table():
    _close(patt.sinusoidal_pe_table(1000, 24), jatt.sinusoidal_pe_table(1000, 24))


@pytest.mark.parametrize("local_enhence", [True, False])
def test_mlp(local_enhence):
    x = _x(2, 32, 8)
    jm = jatt.Mlp(8, 32, local_enhence=local_enhence)
    v = random_variables(jm, jnp.asarray(x))
    pm = _port(patt.Mlp(8, 32, local_enhence=local_enhence), v)
    _close(pm(torch.from_numpy(x)), jm.apply(v, x))


@pytest.mark.parametrize("L,C,H,with_bias,local_enhence", [
    (64, 32, 8, True, True),
    (32, 64, 16, True, False),
    (16, 128, 32, False, True),
])
def test_transformer_block(L, C, H, with_bias, local_enhence):
    x = _x(2, L, C)
    bias = _x(1, H, L, L, seed=2) if with_bias else None
    jm = jatt.TransformerBlock(C, H, local_enhence=local_enhence)
    v = random_variables(jm, jnp.asarray(x), bias)
    pm = _port(patt.TransformerBlock(C, H, local_enhence=local_enhence), v)
    y = pm(torch.from_numpy(x), None if bias is None else torch.from_numpy(bias))
    _close(y, jm.apply(v, x, bias))


def test_basic_layer_stacks_blocks():
    x, bias = _x(2, 32, 16), _x(1, 4, 32, 32, seed=2)
    jm = jatt.BasicLayer(16, 2, 4, local_enhence=True)
    v = random_variables(jm, jnp.asarray(x), bias)
    pm = _port(patt.BasicLayer(16, 2, 4, local_enhence=True), v)
    _close(pm(torch.from_numpy(x), torch.from_numpy(bias)), jm.apply(v, x, bias))


@pytest.mark.parametrize("L", [32, 31])
def test_patch_merging(L):
    x = _x(2, L, 16)
    jm = jatt.PatchMerging(16)
    v = random_variables(jm, jnp.asarray(x))
    pm = _port(patt.PatchMerging(16), v)
    _close(pm(torch.from_numpy(x)), jm.apply(v, x))


def test_patch_separate_concatenates_channel_halves():
    x = _x(2, 16, 32)
    jm = jatt.PatchSeparate(32)
    v = random_variables(jm, jnp.asarray(x))
    pm = _port(patt.PatchSeparate(32), v)
    y = pm(torch.from_numpy(x))
    assert y.shape == (2, 32, 16)
    _close(y, jm.apply(v, x))


def _zero_fc2(variables):
    """Zero the Mlp's output layer, so a block's output is its attention
    branch plus the residual."""
    flat = flatten_dict(variables)
    return unflatten_dict({k: np.zeros_like(a) if "fc2" in k else a
                           for k, a in flat.items()})


@pytest.mark.parametrize("name,jax_module,port_module,shape,with_bias", [
    ("linear", lambda: jlay.Dense(48, dtype=BF16), lambda: play.Linear(32, 48),
     (2, 64, 32), False),
    ("conv1d", lambda: jlay.Conv1d(16, 3, padding=1, dtype=BF16),
     lambda: play.Conv1d(32, 16, 3, padding=1), (2, 32, 64), False),
    ("layernorm", lambda: jlay.LayerNorm(dtype=BF16), lambda: play.LayerNorm(32),
     (2, 64, 32), False),
    ("batchnorm", lambda: jlay.BatchNorm1d(dtype=BF16),
     lambda: play.BatchNorm1d(32), (2, 32, 64), False),
    ("attention", lambda: jatt.MSAttention(32, 8, dtype=BF16),
     lambda: patt.MSAttention(32, 8), (2, 64, 32), True),
    ("attention_no_bias", lambda: jatt.MSAttention(128, 32, dtype=BF16),
     lambda: patt.MSAttention(128, 32), (2, 16, 128), False),
    ("patch_merging", lambda: jatt.PatchMerging(32, dtype=BF16),
     lambda: patt.PatchMerging(32), (2, 64, 32), False),
    ("patch_separate", lambda: jatt.PatchSeparate(32, dtype=BF16),
     lambda: patt.PatchSeparate(32), (2, 64, 32), False),
    ("block_without_mlp", lambda: jatt.TransformerBlock(32, 8, local_enhence=True,
                                                        dtype=BF16),
     lambda: patt.TransformerBlock(32, 8, local_enhence=True), (2, 64, 32), True),
])
def test_bfloat16_rounds_where_jax_does(name, jax_module, port_module, shape,
                                        with_bias):
    """bfloat16: the port rounds to bfloat16 where the JAX layers' code does
    (a product before its bias is added, sqrt(dim) before it scales the PE
    input, the norms' outputs, the softmax probabilities before the pv
    product), so its outputs match the JAX layers' run op by op: at most
    1 % of the elements differ, none by more than 2^-7 of max|out| (one
    bfloat16 step at the top of the range). Float32 sums inside a layer may
    run in another order and flip a rounding now and then; a cast in
    another place flips far more. (Under jit XLA may
    fuse an elementwise chain and round it once: the compiler's choice,
    not the code's casts.) The block's Mlp output is zeroed because GELU
    differs by design: the port's rounds once, JAX's erfc form rounds
    after each of its ops."""
    x = _x(*shape)
    bias = _x(1, shape[-1] // 4, shape[1], shape[1], seed=2) if with_bias else None
    jm = jax_module()
    v = random_variables(jm, jnp.asarray(x), *([] if bias is None else [bias]))
    if name == "block_without_mlp":
        v = _zero_fc2(v)
    kwargs = {"use_running_average": True} if name == "batchnorm" else {}
    args = [jnp.asarray(a, BF16) for a in (x, bias) if a is not None]
    ref = np.asarray(jm.apply(v, *args, **kwargs)).astype(np.float32)
    pm = _port(port_module(), v)
    with torch.no_grad():
        y = pm(*(torch.from_numpy(a).to(torch.bfloat16)
                 for a in (x, bias) if a is not None))
    assert y.dtype == torch.bfloat16
    y = y.float().numpy()
    assert (y != ref).mean() <= 0.01, (y != ref).mean()
    np.testing.assert_allclose(y, ref, atol=2 ** -7 * np.abs(ref).max(), rtol=0)


def _imports(path: Path):
    for node in ast.walk(ast.parse(path.read_text(), str(path))):
        if isinstance(node, ast.Import):
            yield from (a.name for a in node.names)
        elif isinstance(node, ast.ImportFrom) and node.level == 0:
            yield node.module


def test_port_imports_no_jax():
    files = sorted((REPO / "ecg_denoise_tpu_torch").rglob("*.py"))
    files.append(REPO / "chip_smoke.py")
    assert len(files) > 10 and all(f.exists() for f in files)
    banned = {"jax", "jaxlib", "flax", "ecg_denoise_tpu"}
    found = [(f.relative_to(REPO), m) for f in files for m in _imports(f)
             if m.split(".")[0] in banned]
    assert not found


def test_default_device_raises_without_cuda(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="device='cpu'"):
        port.default_device()
    from ecg_denoise_tpu_torch.models import build_model
    from ecg_denoise_tpu_torch.serving import Denoiser

    with pytest.raises(RuntimeError):
        build_model("ralenet")
    with pytest.raises(RuntimeError):
        Denoiser(patt.PatchMerging(8))
    assert port.resolve_device("cpu") == torch.device("cpu")


def test_random_seed_reproduces_module_init():
    from ecg_denoise_tpu_torch.utils.seed import random_seed

    g = random_seed(7)
    a = (play.Linear(4, 4).weight.clone(), torch.rand(3, generator=g))
    g = random_seed(7)
    b = (play.Linear(4, 4).weight.clone(), torch.rand(3, generator=g))
    for u, w in zip(a, b):
        torch.testing.assert_close(u, w, atol=0, rtol=0)
