"""The port's dense forward (B5) at head_dim 32, and at 8, 16 and 64,
against the JAX package's, on the CPU.

`attention_dense_reference` (B5's plain version, which `fused_attention_dense`
runs for CPU tensors) at D = 32, q pre-scaled by 32^-1/2 as Transformer1d
scales it, against JAX's `_fwd_dense` run through `fused_attention` in
interpret mode with ECG_ATTN_DENSE=1 (a counter on `_fwd_dense` shows the
call went through it), at Transformer1d's two packable stages, (L, H) =
(64, 16) and (32, 32), with and without a bias, within 1e-5: both sides
compute float32 logits and softmax. JAX subtracts one max over the packed
row of P heads and the port each head's own; with these logits the two are
equal to rounding.

Then a small Transformer1d (embed 64, depths (1, 1), heads (2, 4): every
head 32 wide and both stages packable) with ECG_ATTN_DENSE=1 against JAX's
with `use_pallas=True`: on the port's side the attention takes the card's
dispatch (`dense_route`, then B5's or B1's wrapper), whose CPU versions are
the plain ones, within 1e-4; both sides take the dense forward at both
stages. The same at embed 32, every head 16 wide.

B5 takes every head dim: the plain version against JAX's `_fwd_dense` at
D = 8, 16 and 64 at both stages and at L = 8 (and D = 32 at L = 8), and
at D = 128 and 256 (Transformer1d's packable stages with 256-wide heads,
(64, 2) and (32, 4), and D = 128 at (64, 16)), B = 2, within 1e-5;
`dense_route` takes any D at a packable stage and declines the stages
that do not pack; and the card's wrapper runs a D = 24 call at D = 32
(`kernel_head_dim`), and D = 72, 200 at 128, 256 (D = 320 as it is),
zero-padded and sliced back (`forward_at`), here with the plain version
as its kernel.
"""

import numpy as np
import pytest
import torch
torch.set_num_threads(1)  # six test workers share the host's cores: one intra-op thread each
import jax
import jax.numpy as jnp

import ecg_denoise_tpu.kernels.attention_pallas as ap
import ecg_denoise_tpu_torch.ops.attention as port_ops
from ecg_denoise_tpu.models import Transformer1d as JaxTransformer1d
from ecg_denoise_tpu_torch.interop.jax_weights import transformer1d_state_dict
from ecg_denoise_tpu_torch.kernels import attention_dense
from ecg_denoise_tpu_torch.kernels.attention import attention_reference, fused_attention
from ecg_denoise_tpu_torch.kernels.attention_dense import (
    attention_dense_reference,
    dense_pack_factor,
    dense_route,
    fused_attention_dense,
)
from ecg_denoise_tpu_torch.models import Transformer1d
from test_torch_port_layers import random_variables

D = 32
ATOL = 1e-5
MODEL_ATOL = 1e-4
STAGES = [(64, 16), (32, 32)]  # Transformer1d's packable (L, H) at 256 samples
DENSE_SMALL = dict(num_class=9, in_channels=32, embed_dim=64, depths=(1, 1), num_heads=(2, 4))
# Every head 16 wide: embed 32 over (2, 4) heads.
DENSE_SMALL_D16 = dict(DENSE_SMALL, embed_dim=32)
# B5's other head dims at Transformer1d's stages and at L = 8 (P = 16);
# then past 64: Transformer1d's packable stages with 256-wide heads (num_heads
# (1, 1, 2, 4)) and D = 128 at its first default one.
OTHER_D_CASES = ([(d, L, H) for d in (8, 16, 64) for L, H in STAGES + [(8, 16)]] + [(D, 8, 16)]
                 + [(256, 64, 2), (256, 32, 4), (128, 64, 16)])


@pytest.fixture
def jax_dense_calls(monkeypatch):
    """JAX's attention in interpret mode with ECG_ATTN_DENSE=1; the list
    grows by one for every call into `_fwd_dense`."""
    monkeypatch.setattr(ap, "_INTERPRET", True)
    monkeypatch.setenv("ECG_ATTN_DENSE", "1")
    calls = []
    real = ap._fwd_dense

    def counted(*args, **kwargs):
        calls.append(args[0].shape)
        return real(*args, **kwargs)

    monkeypatch.setattr(ap, "_fwd_dense", counted)
    return calls


def _operands(B, H, L, with_bias, seed=0, d=D):
    rng = np.random.default_rng(seed)
    q, k, v = (rng.standard_normal((B, H, L, d)).astype(np.float32) for _ in range(3))
    bias = rng.standard_normal((1, H, L, L)).astype(np.float32) if with_bias else None
    return (q * d ** -0.5).astype(np.float32), k, v, bias


def _t(a):
    return None if a is None else torch.from_numpy(a)


@pytest.mark.parametrize("L,H", STAGES)
@pytest.mark.parametrize("with_bias", [True, False])
def test_reference_matches_jax_dense_kernel_at_d32(jax_dense_calls, L, H, with_bias):
    q, k, v, bias = _operands(3, H, L, with_bias, seed=L + with_bias)
    ref = ap.fused_attention(q, k, v, bias)
    assert jax_dense_calls == [(3, H, L, D)]
    out = attention_dense_reference(*map(_t, (q, k, v, bias)))
    assert out.shape == (3, H, L, D) and out.dtype == torch.float32
    np.testing.assert_allclose(out.numpy(), np.asarray(ref), atol=ATOL, rtol=0)
    torch.testing.assert_close(out, attention_reference(*map(_t, (q, k, v, bias))),
                               atol=ATOL, rtol=0)


@pytest.mark.parametrize("d,L,H", OTHER_D_CASES)
@pytest.mark.parametrize("with_bias", [True, False])
def test_reference_matches_jax_dense_kernel_at_other_head_dims(jax_dense_calls, d, L, H,
                                                               with_bias):
    q, k, v, bias = _operands(2, H, L, with_bias, seed=d + L + with_bias, d=d)
    ref = ap.fused_attention(q, k, v, bias)
    assert jax_dense_calls == [(2, H, L, d)]
    out = attention_dense_reference(*map(_t, (q, k, v, bias)))
    assert out.shape == (2, H, L, d) and out.dtype == torch.float32
    np.testing.assert_allclose(out.numpy(), np.asarray(ref), atol=ATOL, rtol=0)


def test_dense_route_takes_every_head_dim_up_to_64(monkeypatch):
    """With ECG_ATTN_DENSE=1 the route takes any D <= 64 where the stage
    packs, and declines the stages that do not pack; with the switch off
    it takes nothing."""
    monkeypatch.setenv("ECG_ATTN_DENSE", "1")
    for L, H in STAGES + [(8, 16), (2, 2)]:
        assert all(dense_route((2, H, L, d)) for d in (1, 4, 8, 12, 16, 24, 32, 48, 64))
    for L, H in [(256, 4), (128, 8), (48, 4), (64, 1), (64, 3)]:
        assert dense_pack_factor(H, L) == 1 and not dense_route((2, H, L, 16))
    monkeypatch.setenv("ECG_ATTN_DENSE", "0")
    assert not dense_route((2, 16, 64, 16))


def test_dense_route_takes_head_dims_past_64(monkeypatch):
    """Past D = 64 the route takes a packable stage too (B5's wide kernel,
    where it declined and left the call to B1 before), as JAX's `_fwd`
    packs any D: Transformer1d's (64, 2) and (32, 4) with 256-wide heads;
    B1 keeps the stages that do not pack."""
    monkeypatch.setenv("ECG_ATTN_DENSE", "1")
    for L, H in STAGES + [(64, 2), (32, 4), (8, 16), (2, 2)]:
        assert all(dense_route((2, H, L, d)) for d in (65, 72, 128, 200, 256, 320, 512))
    for L, H in [(256, 1), (128, 1), (64, 1)]:
        assert not dense_route((2, H, L, 128)) and not dense_route((2, H, L, 256))
    monkeypatch.setenv("ECG_ATTN_DENSE", "0")
    assert not dense_route((2, 2, 64, 256))


@pytest.mark.parametrize("with_bias", [True, False])
def test_card_wrapper_pads_d24_to_32_and_slices_back(monkeypatch, with_bias):
    """B5's card wrapper at D = 24 calls its kernel at D = 32 on
    zero-padded operands and slices the output back; with the plain
    version as the kernel the result is the unpadded call's."""
    calls = []

    def plain_kernel(q, k, v, bias, *, P):
        calls.append((tuple(q.shape), P))
        return attention_dense_reference(q, k, v, bias)

    monkeypatch.setattr(attention_dense, "_launch_kernel", plain_kernel)
    q, k, v, bias = map(_t, _operands(2, 16, 64, with_bias, seed=24, d=24))
    out = attention_dense._launch(q, k, v, bias, dense_pack_factor(16, 64))
    assert calls == [((2, 16, 64, 32), 2)]
    assert out.shape == (2, 16, 64, 24) and out.is_contiguous()
    torch.testing.assert_close(out, attention_dense_reference(q, k, v, bias), atol=1e-6, rtol=0)


@pytest.mark.parametrize("d,wide", [(72, 128), (200, 256), (320, 320)])
@pytest.mark.parametrize("with_bias", [True, False])
def test_card_wrapper_pads_past_64_and_slices_back(monkeypatch, d, wide, with_bias):
    """Past D = 64 B5's card wrapper calls its kernel at the next multiple
    of 64 (the wide kernel's; D = 320 as it is) on zero-padded operands and
    slices the output back; with the plain version as the kernel the result
    is the unpadded call's."""
    calls = []

    def plain_kernel(q, k, v, bias, *, P):
        calls.append((tuple(q.shape), P))
        return attention_dense_reference(q, k, v, bias)

    monkeypatch.setattr(attention_dense, "_launch_kernel", plain_kernel)
    q, k, v, bias = map(_t, _operands(2, 4, 32, with_bias, seed=d, d=d))
    out = attention_dense._launch(q, k, v, bias, dense_pack_factor(4, 32))
    assert calls == [((2, 4, 32, wide), 4)]
    # Sliced back into a contiguous tensor; unpadded, the kernel's own.
    assert out.shape == (2, 4, 32, d) and (out.is_contiguous() or wide == d)
    torch.testing.assert_close(out, attention_dense_reference(q, k, v, bias), atol=1e-6, rtol=0)


def _small_transformer1d_dense_forward(jax_dense_calls, monkeypatch, config, d):
    """A small Transformer1d of `config` (every head `d` wide) through the
    card's dispatch with the plain versions, against JAX's dense forward."""
    jm = JaxTransformer1d(**config, use_pallas=True)
    v = random_variables(jm, jnp.zeros((2, config["in_channels"], 64)), seed=21)
    pm = Transformer1d(**config).eval()
    pm.load_state_dict(transformer1d_state_dict(v))
    x = np.random.default_rng(22).standard_normal(
        (2, config["in_channels"], 64)).astype(np.float32)
    ref = np.asarray(jm.apply(v, jnp.asarray(x)))
    # Each stage's call traced through `_fwd_dense` (a trace may visit it twice).
    assert set(jax_dense_calls) == {(2, 2, 64, d), (2, 4, 32, d)}

    routes = []

    def card_dispatch(q, k, v, bias=None):
        """The card's no-grad dispatch of `fused_attention`, with the CPU
        versions of its kernels."""
        dense = dense_route(q.shape)
        routes.append((tuple(q.shape), dense))
        return (fused_attention_dense if dense else fused_attention)(q, k, v, bias)

    monkeypatch.setattr(port_ops, "fused_attention", card_dispatch)
    with torch.no_grad():
        y = pm(torch.from_numpy(x))
    assert routes == [((2, 2, 64, d), True), ((2, 4, 32, d), True)]
    np.testing.assert_allclose(y.numpy(), ref, atol=MODEL_ATOL, rtol=0)


def test_small_transformer1d_dense_forward_matches_jax(jax_dense_calls, monkeypatch):
    _small_transformer1d_dense_forward(jax_dense_calls, monkeypatch, DENSE_SMALL, D)


def test_small_transformer1d_dense_forward_matches_jax_at_head_dim_16(jax_dense_calls,
                                                                      monkeypatch):
    _small_transformer1d_dense_forward(jax_dense_calls, monkeypatch, DENSE_SMALL_D16, 16)
