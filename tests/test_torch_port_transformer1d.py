"""The port's Transformer1d and its head_dim-32 attention against the JAX
package's, on the CPU.

`attention_reference` and `attention_backward_reference` at D = 32 (the
plain versions of B1 and B2 at Transformer1d's head width) against JAX's
`fused_attention` with its Pallas kernel pair (`_fwd_kernel`,
`_bwd_kernel`) run in interpret mode, as tests/test_pallas_attention.py
runs it, q pre-scaled by D^-1/2 as the model scales it, with and without
the bias: the forward within 1e-5, the gradients within 1e-4 (the JAX
package's kernel bars, tests/test_pallas_attention.py:85,125).

`Transformer1d` at embed 32, depths (1, 1), heads (1, 2) (every head 32
wide, the slice's shape), L = 64, with random variables through
`transformer1d_state_dict`: the forward within 1e-4 of JAX's with
`use_pallas=True` (interpret mode) and `False`, every parameter's gradient
within 1e-4 of its tensor's largest, and an odd L through PatchMerging's
pad; the same at heads 16, 64, and 128 and 256 wide (embed 128, heads (1,
1)). At its published widths with num_heads (1, 1, 2, 4) (heads 128 and
256 wide) the model has the default's parameter shapes on both sides, so
`transformer1d_state_dict` carries JAX's variables across unchanged.

The plain attention is also held to JAX's Pallas pair at D = 128, 256 and
320, the wide kernels' head dims. With ECG_ATTN_DENSE=1 a D = 32 call takes the dense route (B5) where
the stage packs, as JAX's `_fwd` packs it, and B1 elsewhere.
"""

import numpy as np
import pytest
import torch
torch.set_num_threads(1)  # six test workers share the host's cores: one intra-op thread each
import jax
import jax.numpy as jnp

import ecg_denoise_tpu.kernels.attention_pallas as ap
from ecg_denoise_tpu.models import Transformer1d as JaxTransformer1d
from ecg_denoise_tpu_torch.interop.jax_weights import transformer1d_state_dict
from ecg_denoise_tpu_torch.kernels.attention import (
    attention_backward_reference,
    attention_reference,
)
from ecg_denoise_tpu_torch.kernels.attention_dense import dense_route
from ecg_denoise_tpu_torch.models import Transformer1d
from test_torch_port_layers import random_variables

D = 32
FWD_ATOL = 1e-5
GRAD_ATOL = 1e-4
MODEL_ATOL = 1e-4
GRAD_TOL_OF_MAX = 1e-4
# The slice's model shape at CPU size: every head 32 wide.
SMALL = dict(num_class=9, in_channels=32, embed_dim=32, depths=(1, 1), num_heads=(1, 2))


@pytest.fixture(autouse=True)
def _interpret_mode(monkeypatch):
    monkeypatch.setattr(ap, "_INTERPRET", True)


def _operands(B, H, L, with_bias, seed=0, D=D):
    """q (pre-scaled), k, v, bias and the output gradient g, numpy float32."""
    rng = np.random.default_rng(seed)
    q, k, v, g = (rng.standard_normal((B, H, L, D)).astype(np.float32) for _ in range(4))
    bias = rng.standard_normal((1, H, L, L)).astype(np.float32) if with_bias else None
    return (q * D ** -0.5).astype(np.float32), k, v, bias, g


# (with_bias, B, H, L, head_dim): Transformer1d's 32 with and without a
# bias, then the mma template's other head dims, a bias at two of them
# (the CPU takes any D; JAX's kernels are generic in D).
@pytest.mark.parametrize("with_bias,B,H,L,d", [
    *(pytest.param(wb, B, H, L, D, id=f"{wb}-{B}-{H}-{L}")
      for wb in (True, False) for B, H, L in ((2, 2, 64), (3, 1, 33))),
    pytest.param(True, 2, 1, 16, 8, id="True-2-1-16-d8"),
    pytest.param(False, 2, 1, 16, 16, id="False-2-1-16-d16"),
    pytest.param(True, 2, 1, 16, 64, id="True-2-1-16-d64"),
    # Past 64: the wide kernels' head dims (Transformer1d's 128 and 256
    # with num_heads (1, 1, 2, 4)), and 320, five of their 64-wide chunks.
    pytest.param(True, 1, 2, 16, 128, id="True-1-2-16-d128"),
    pytest.param(False, 2, 1, 8, 256, id="False-2-1-8-d256"),
    pytest.param(True, 1, 1, 8, 320, id="True-1-1-8-d320")])
def test_plain_attention_at_d32_matches_pallas_interpret(with_bias, B, H, L, d):
    q, k, v, bias, g = _operands(B, H, L, with_bias, seed=L + H, D=d)
    args = tuple(map(jnp.asarray, (q, k, v) + ((bias,) if with_bias else ())))
    f = ((lambda q, k, v, b: ap.fused_attention(q, k, v, b)) if with_bias
         else (lambda q, k, v: ap.fused_attention(q, k, v)))
    ref_out, vjp = jax.vjp(f, *args)
    ref_grads = vjp(jnp.asarray(g))

    t = [torch.from_numpy(a) for a in (q, k, v)] + (
        [torch.from_numpy(bias)] if with_bias else [None])
    out, lse = attention_reference(*t, return_lse=True)
    np.testing.assert_allclose(out.numpy(), np.asarray(ref_out), atol=FWD_ATOL, rtol=0)
    grads = attention_backward_reference(*t, out, lse, torch.from_numpy(g))
    ins = [a.clone().requires_grad_() for a in t if a is not None]
    autograd = torch.autograd.grad(
        attention_reference(*ins[:3], ins[3] if with_bias else None), ins,
        torch.from_numpy(g))
    for name, ref, flash, auto in zip("q k v bias".split(), ref_grads, grads, autograd):
        ref = np.asarray(ref)
        np.testing.assert_allclose(flash.numpy(), ref, atol=GRAD_ATOL, rtol=0, err_msg=name)
        np.testing.assert_allclose(auto.numpy(), ref, atol=GRAD_ATOL, rtol=0, err_msg=name)


def _pair(use_pallas, seed=0, length=64, config=SMALL):
    """JAX Transformer1d (SMALL), random variables, and the port's with them."""
    jm = JaxTransformer1d(**config, use_pallas=use_pallas)
    v = random_variables(jm, jnp.zeros((2, config["in_channels"], length)), seed=seed)
    pm = Transformer1d(**config)
    pm.load_state_dict(transformer1d_state_dict(v))
    return jm, v, pm


def _x(B, L, seed=1):
    return np.random.default_rng(seed).standard_normal(
        (B, SMALL["in_channels"], L)).astype(np.float32)


# Heads 16 and 64 wide (C1: the mma template's other head dims), then 128
# and 256 wide (the wide kernels' head dims, as Transformer1d's first two
# stages with num_heads (1, 1, 2, 4)). JAX's gradients of these are jitted:
# op by op they take about 12 s a config.
HEADS_16 = dict(SMALL, embed_dim=32, num_heads=(2, 4))
HEADS_64 = dict(SMALL, embed_dim=64, num_heads=(1, 2))
HEADS_128 = dict(SMALL, embed_dim=128, num_heads=(1, 1))


@pytest.mark.parametrize("use_pallas,config", [
    pytest.param(True, SMALL, id="True"), pytest.param(False, SMALL, id="False"),
    pytest.param(False, HEADS_16, id="False-d16"), pytest.param(False, HEADS_64, id="False-d64"),
    pytest.param(False, HEADS_128, id="False-d128")])
def test_transformer1d_forward_and_gradients_match_jax(use_pallas, config):
    jm, v, pm = _pair(use_pallas, config=config)
    x = _x(2, 64)
    w = np.random.default_rng(2).standard_normal((2, SMALL["num_class"])).astype(np.float32)

    def loss(params):
        y = jm.apply({"params": params}, jnp.asarray(x))
        return jnp.sum(y * w), y

    grad = jax.value_and_grad(loss, has_aux=True)
    (_, ref), ref_grads = (grad if config is SMALL else jax.jit(grad))(v["params"])
    y = pm(torch.from_numpy(x))
    assert y.shape == (2, SMALL["num_class"]) and y.dtype == torch.float32
    np.testing.assert_allclose(y.detach().numpy(), np.asarray(ref), atol=MODEL_ATOL, rtol=0)
    (y * torch.from_numpy(w)).sum().backward()
    ref_grads = transformer1d_state_dict({"params": ref_grads})
    params = dict(pm.named_parameters())
    assert params.keys() == ref_grads.keys()
    for name, p in params.items():
        bar = GRAD_TOL_OF_MAX * ref_grads[name].abs().max().item()
        err = (p.grad - ref_grads[name]).abs().max().item()
        assert err <= bar, (name, err, bar)


def test_odd_length_goes_through_patch_merging_pad():
    """L = 63: the first PatchMerging pads one zero row, as JAX's does."""
    jm, v, pm = _pair(False, seed=3, length=63)
    x = _x(3, 63, seed=4)
    ref = np.asarray(jax.jit(lambda v, x: jm.apply(v, x))(v, x))
    with torch.no_grad():
        y = pm(torch.from_numpy(x))
    np.testing.assert_allclose(y.numpy(), ref, atol=MODEL_ATOL, rtol=0)


def test_dense_route_takes_d32_at_packable_stages(monkeypatch):
    """With ECG_ATTN_DENSE=1 the dense route takes a D = 32 call where the
    stage packs, as JAX's `_fwd` packs it (Transformer1d's (64, 16) and
    (32, 32)), and leaves the calls of the stages that do not pack, (256,
    4) and (128, 8), to B1, as JAX leaves them to `_fwd_raw`; with the
    switch off every call stays on B1."""
    monkeypatch.setenv("ECG_ATTN_DENSE", "1")
    B = 8
    for (L, H), packs in (((256, 4), False), ((128, 8), False), ((64, 16), True),
                          ((32, 32), True)):
        assert ap._dense_wanted() and (ap._pack_factor(B, H, L) > 1) == packs
        assert dense_route((B, H, L, D)) == packs == dense_route((B, H, L, 4))
    monkeypatch.setenv("ECG_ATTN_DENSE", "0")
    assert not dense_route((B, 16, 64, D)) and not dense_route((B, 16, 64, 4))


def test_published_widths_with_wide_heads_keep_the_default_shapes():
    """Transformer1d at embed 128, depths (2, 2, 6, 2) with num_heads (1, 1,
    2, 4): JAX's variables (shapes only, `jax.eval_shape`) are the
    default's, `transformer1d_state_dict` maps them onto the port's model
    with those heads, and both have 47,478,153 parameters."""
    wide = dict(num_heads=(1, 1, 2, 4))
    x = jax.ShapeDtypeStruct((1, 32, 256), jnp.float32)

    def shapes(**kw):
        m = JaxTransformer1d(**kw)
        return jax.eval_shape(lambda x: m.init(jax.random.PRNGKey(0), x), x)

    ref, got = shapes(), shapes(**wide)
    assert jax.tree_util.tree_structure(ref) == jax.tree_util.tree_structure(got)
    assert jax.tree_util.tree_leaves(jax.tree_util.tree_map(
        lambda a, b: a.shape == b.shape, ref, got))
    state = transformer1d_state_dict(jax.tree_util.tree_map(
        lambda a: np.zeros(a.shape, np.float32), got))
    pm = Transformer1d(**wide)
    assert {k: tuple(v.shape) for k, v in state.items()} == {
        k: tuple(v.shape) for k, v in pm.state_dict().items()}
    pm.load_state_dict(state)
    assert sum(p.numel() for p in pm.parameters()) == 47_478_153
    assert [getattr(pm, f"layer{i}").blocks[0].attn.num_heads for i in range(4)] == [1, 1, 2, 4]
