"""Attention at head_dim 32 past 256 keys, and Transformer1d past 256
samples, against the JAX package, on the CPU.

B1 and B2 at D = 32 take any L (the D = 4 kernels keep their cap of 256,
which RA-LENet, built for 256 samples, never passes). Their plain versions
at L = 300 and 520, q pre-scaled by 32^-1/2, against JAX's `fused_attention`
with its Pallas pair run in interpret mode (as tests/test_pallas_attention.py
runs it), with and without a bias: the forward within 1e-5, the gradients
within 1e-4 (the JAX package's kernel bars). Then the small Transformer1d of
test_torch_port_transformer1d.py (embed 32, depths (1, 1), heads (1, 2))
on 520-sample inputs, where the port raised before: the forward within
1e-4 of JAX's with `use_pallas=True` and every parameter's gradient within
1e-4 of its tensor's largest. The D = 4 kernels keep their cap of 256:
past it a D = 4 call takes the mma template at D = 8 on the card, and the
plain version on the CPU; past D = 64 a call takes the wide kernels at the
next multiple of 64. The card's padding of q, k, v (and o, g) along D to
the kernel's head dim (`forward_at`, `backward_at`), run here with the
plain versions at D = 12 and 24 (the template) and 72 and 200 (the wide
kernels, padded to 128 and 256), gives the unpadded plain
version's output, lse and gradients within 1e-6 of each tensor's largest
(the padded sums run in another order); and B1's and B2's card wrappers,
their launches replaced by the plain versions, call them at the padded D
and slice the results back (D = 320, a multiple of 64, unpadded).
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
from ecg_denoise_tpu_torch.kernels import attention
from ecg_denoise_tpu_torch.kernels.attention import (
    attention_backward_reference,
    attention_reference,
    backward_at,
    forward_at,
    fused_attention,
    kernel_head_dim,
)
from ecg_denoise_tpu_torch.models import Transformer1d
from test_torch_port_layers import random_variables

D = 32
FWD_ATOL = 1e-5
GRAD_ATOL = 1e-4
MODEL_ATOL = 1e-4
GRAD_TOL_OF_MAX = 1e-4
SMALL = dict(num_class=9, in_channels=32, embed_dim=32, depths=(1, 1), num_heads=(1, 2))
LONG = 520


@pytest.fixture(autouse=True)
def _interpret_mode(monkeypatch):
    monkeypatch.setattr(ap, "_INTERPRET", True)


@pytest.mark.parametrize("L", [300, LONG])
@pytest.mark.parametrize("with_bias", [True, False])
def test_plain_attention_past_256_matches_pallas_interpret(L, with_bias):
    rng = np.random.default_rng(L + with_bias)
    B, H = 1, 2
    q, k, v, g = (rng.standard_normal((B, H, L, D)).astype(np.float32) for _ in range(4))
    q = (q * D ** -0.5).astype(np.float32)
    bias = rng.standard_normal((1, H, L, L)).astype(np.float32) if with_bias else None
    args = tuple(map(jnp.asarray, (q, k, v) + ((bias,) if with_bias else ())))
    f = ((lambda q, k, v, b: ap.fused_attention(q, k, v, b)) if with_bias
         else (lambda q, k, v: ap.fused_attention(q, k, v)))
    ref_out, vjp = jax.vjp(f, *args)
    ref_grads = vjp(jnp.asarray(g))

    t = [torch.from_numpy(a) for a in (q, k, v)] + (
        [torch.from_numpy(bias)] if with_bias else [None])
    out = fused_attention(*t)
    np.testing.assert_allclose(out.numpy(), np.asarray(ref_out), atol=FWD_ATOL, rtol=0)
    out, lse = attention_reference(*t, return_lse=True)
    grads = attention_backward_reference(*t, out, lse, torch.from_numpy(g))
    for name, ref, got in zip("q k v bias".split(), ref_grads, grads):
        np.testing.assert_allclose(got.numpy(), np.asarray(ref), atol=GRAD_ATOL, rtol=0,
                                   err_msg=name)


def test_transformer1d_past_256_matches_jax():
    jm = JaxTransformer1d(**SMALL, use_pallas=True)
    v = random_variables(jm, jnp.zeros((2, SMALL["in_channels"], LONG)), seed=23)
    pm = Transformer1d(**SMALL)
    pm.load_state_dict(transformer1d_state_dict(v))
    rng = np.random.default_rng(24)
    x = rng.standard_normal((2, SMALL["in_channels"], LONG)).astype(np.float32)
    w = rng.standard_normal((2, SMALL["num_class"])).astype(np.float32)

    def loss(params):
        y = jm.apply({"params": params}, jnp.asarray(x))
        return jnp.sum(y * w), y

    (_, ref), ref_grads = jax.value_and_grad(loss, has_aux=True)(v["params"])
    y = pm(torch.from_numpy(x))
    assert y.shape == (2, SMALL["num_class"])
    np.testing.assert_allclose(y.detach().numpy(), np.asarray(ref), atol=MODEL_ATOL, rtol=0)
    (y * torch.from_numpy(w)).sum().backward()
    ref_grads = transformer1d_state_dict({"params": ref_grads})
    params = dict(pm.named_parameters())
    assert params.keys() == ref_grads.keys()
    for name, p in params.items():
        bar = GRAD_TOL_OF_MAX * ref_grads[name].abs().max().item()
        err = (p.grad - ref_grads[name]).abs().max().item()
        assert err <= bar, (name, err, bar)


def test_d4_keeps_its_length_cap():
    """On the card the D = 4 kernels take L <= 256 and the mma template
    the rest (at D = 8, bf16 at 16, its depth); on the CPU the plain
    version takes any L; past D = 64 the card takes the wide kernels at
    the next multiple of 64, at any L and both dtypes."""
    assert kernel_head_dim(4, 256, torch.float32) == 4 == kernel_head_dim(4, 256, torch.bfloat16)
    assert kernel_head_dim(4, 257, torch.float32) == 8
    assert kernel_head_dim(4, 257, torch.bfloat16) == 16
    assert [kernel_head_dim(d, 64, torch.float32) for d in (8, 12, 24, 32, 40, 64)] == [
        8, 16, 32, 32, 64, 64]
    for dtype in (torch.float32, torch.bfloat16):
        assert [kernel_head_dim(d, L, dtype) for d, L in (
            (65, 64), (72, 1000), (128, 256), (200, 7), (256, 64), (320, 32), (512, 1))] == [
            128, 128, 128, 256, 256, 320, 512]
    rng = np.random.default_rng(257)
    q, k, v = (torch.from_numpy(rng.standard_normal((1, 2, 257, 4)).astype(np.float32))
               for _ in range(3))
    assert torch.equal(fused_attention(q, k, v), attention_reference(q, k, v))
    assert fused_attention(*(torch.zeros(1, 2, 257, D),) * 3).shape == (1, 2, 257, D)
    assert fused_attention(*(torch.zeros(1, 2, 9, 65),) * 3).shape == (1, 2, 9, 65)


@pytest.mark.parametrize("d", [12, 24, 72, 200])
def test_padding_to_the_kernel_head_dim_is_exact(d):
    rng = np.random.default_rng(d)
    B, H, L = 2, 3, 37
    q, k, v, g = (torch.from_numpy(rng.standard_normal((B, H, L, d)).astype(np.float32))
                  for _ in range(4))
    q = q * d ** -0.5
    bias = torch.from_numpy(rng.standard_normal((1, H, L, L)).astype(np.float32))
    wide = kernel_head_dim(d, L, torch.float32)
    assert wide > d

    def forward(*args, **kw):
        return attention_reference(*args, return_lse=True, **kw)

    out, lse = forward_at(wide, forward, q, k, v, bias)
    ref, ref_lse = attention_reference(q, k, v, bias, return_lse=True)
    grads = backward_at(wide, attention_backward_reference, q, k, v, bias, out, lse, g)
    ref_grads = attention_backward_reference(q, k, v, bias, ref, ref_lse, g)
    for name, got, want in zip("out lse q k v bias".split(), (out, lse, *grads),
                               (ref, ref_lse, *ref_grads)):
        assert got.shape == want.shape and got.is_contiguous(), name
        bar = 1e-6 * want.abs().max().item()
        assert (got - want).abs().max().item() <= bar, name


@pytest.mark.parametrize("d,wide", [(72, 128), (200, 256), (320, 320)])
@pytest.mark.parametrize("with_bias", [True, False])
def test_card_wrappers_pad_past_64_and_slice_back(monkeypatch, d, wide, with_bias):
    """B1's and B2's card wrappers at D > 64 call their kernels at the next
    multiple of 64 (D = 320 as it is) on zero-padded operands and slice the
    results back; with the plain versions as the kernels the results are
    the unpadded calls', within 1e-6 of each tensor's largest."""
    calls = []

    def plain_fwd(q, k, v, bias, *, with_lse):
        calls.append(("fwd", q.shape[-1], with_lse))
        return attention_reference(q, k, v, bias, return_lse=with_lse)

    def plain_bwd(q, k, v, bias, o, lse, g, *, want_dbias):
        calls.append(("bwd", q.shape[-1], want_dbias))
        dq, dk, dv, dbias = attention_backward_reference(q, k, v, bias, o, lse, g)
        return dq, dk, dv, dbias if want_dbias else None

    monkeypatch.setattr(attention, "_launch_kernel", plain_fwd)
    monkeypatch.setattr(attention, "_launch_bwd_kernel", plain_bwd)
    rng = np.random.default_rng(d + with_bias)
    B, H, L = 2, 1, 9
    q, k, v, g = (torch.from_numpy(rng.standard_normal((B, H, L, d)).astype(np.float32))
                  for _ in range(4))
    q = q * d ** -0.5
    bias = (torch.from_numpy(rng.standard_normal((1, H, L, L)).astype(np.float32))
            if with_bias else None)
    out, lse = attention._launch(q, k, v, bias, with_lse=True)
    grads = attention._launch_bwd(q, k, v, bias, out, lse, g, want_dbias=with_bias)
    assert calls == [("fwd", wide, True), ("bwd", wide, with_bias)]
    ref, ref_lse = attention_reference(q, k, v, bias, return_lse=True)
    ref_grads = attention_backward_reference(q, k, v, bias, ref, ref_lse, g)
    for name, got, want in zip("out lse q k v bias".split(), (out, lse, *grads),
                               (ref, ref_lse, *ref_grads)):
        if want is None:
            assert got is None, name
            continue
        assert got.shape == want.shape and got.is_contiguous(), name
        bar = 1e-6 * want.abs().max().item()
        assert (got - want).abs().max().item() <= bar, name
