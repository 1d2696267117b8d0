"""The port's dense forward (B5) against the JAX package's, on the CPU.

`attention_dense_reference` — B5's plain version, written in the TPU
kernel's own packed form, and what `fused_attention_dense` runs for CPU
tensors — is held against JAX's `_fwd_dense` run as
tests/test_pallas_attention.py runs it (interpret mode, ECG_ATTN_DENSE=1,
through `fused_attention` with no gradient; a counter on `_fwd_dense`
shows the call went through it), and against `attention_reference`, at
the four stage shapes the route takes, with and without the bias.
Tolerance 1e-5 at float32: all sides compute float32 logits and softmax.

The route's predicate equals JAX's `_pack_factor`. The last test shows
the hazard of JAX's kernel that the port does not copy (ROADMAP section
C): one max over the packed row of P heads underflows a head whose logits
sit far below another's.
"""

import numpy as np
import pytest
import torch
torch.set_num_threads(1)  # six test workers share the host's cores: one intra-op thread each

import ecg_denoise_tpu.kernels.attention_pallas as ap
from ecg_denoise_tpu_torch.kernels.attention import attention_reference, fused_attention
from ecg_denoise_tpu_torch.kernels.attention_dense import (
    attention_dense_reference,
    dense_pack_factor,
    dense_wanted,
    fused_attention_dense,
)

ATOL = 1e-5
SHAPES = [(64, 8), (32, 16), (16, 32), (64, 4)]  # (L, H) the route takes in RA-LENet
# Other shapes the route admits: L <= 8, more heads than a warp, pack
# factors that are not powers of two.
SMALL_SHAPES = [(2, 2), (8, 4), (1, 3), (8, 6), (2, 64)]


def _operands(B, H, L, with_bias, seed=0):
    rng = np.random.default_rng(seed)
    q, k, v = (rng.standard_normal((B, H, L, 4)).astype(np.float32) for _ in range(3))
    bias = rng.standard_normal((1, H, L, L)).astype(np.float32) if with_bias else None
    return q, k, v, bias


def _t(a):
    return None if a is None else torch.from_numpy(a)


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


@pytest.mark.parametrize("L,H", SHAPES)
@pytest.mark.parametrize("with_bias", [True, False])
def test_reference_matches_jax_dense_kernel(jax_dense_calls, L, H, with_bias):
    q, k, v, bias = _operands(5, H, L, with_bias)
    ref = ap.fused_attention(q, k, v, bias)
    assert jax_dense_calls == [(5, H, L, 4)]
    out = attention_dense_reference(*map(_t, (q, k, v, bias)))
    np.testing.assert_allclose(out.numpy(), np.asarray(ref), atol=ATOL, rtol=0)


@pytest.mark.parametrize("L,H", SHAPES + SMALL_SHAPES)
@pytest.mark.parametrize("with_bias", [True, False])
def test_reference_matches_attention_reference(L, H, with_bias):
    q, k, v, bias = map(_t, _operands(3, H, L, with_bias, seed=1))
    out = attention_dense_reference(q, k, v, bias)
    assert out.shape == q.shape and out.dtype == q.dtype
    torch.testing.assert_close(out, attention_reference(q, k, v, bias), atol=ATOL, rtol=0)


@pytest.mark.parametrize("H", [1, 2, 3, 4, 8, 32])
def test_pack_factor_is_jax_pack_factor(monkeypatch, H):
    monkeypatch.delenv("ECG_ATTN_PACK", raising=False)  # JAX's switch, not ported
    for L in (1, 2, 8, 16, 32, 64, 128, 256):
        assert dense_pack_factor(H, L) == ap._pack_factor(5, H, L), (H, L)


def test_dense_wanted_reads_the_environment_at_call_time(monkeypatch):
    monkeypatch.delenv("ECG_ATTN_DENSE", raising=False)
    assert not dense_wanted()
    monkeypatch.setenv("ECG_ATTN_DENSE", "1")
    assert dense_wanted()
    monkeypatch.setenv("ECG_ATTN_DENSE", "0")
    assert not dense_wanted()


def test_cpu_tensors_take_the_plain_versions(monkeypatch):
    """On the CPU B5's wrapper runs its plain version, and the dispatcher
    keeps its plain version whatever ECG_ATTN_DENSE says; no kernel runs."""
    monkeypatch.setenv("ECG_ATTN_DENSE", "1")
    q, k, v, bias = map(_t, _operands(2, 8, 64, True, seed=2))
    before = (fused_attention_dense.launches, fused_attention.launches)
    torch.testing.assert_close(fused_attention_dense(q, k, v, bias),
                               attention_dense_reference(q, k, v, bias), atol=0, rtol=0)
    torch.testing.assert_close(fused_attention(q, k, v, bias),
                               attention_reference(q, k, v, bias), atol=0, rtol=0)
    assert (fused_attention_dense.launches, fused_attention.launches) == before


@pytest.mark.parametrize("shape,err", [
    ((2, 2, 256, 4), ValueError),   # L >= 128: not packed
    ((2, 1, 64, 4), ValueError),    # one head: pack factor 1
    ((2, 2, 48, 4), ValueError),    # L not a power of two
    ((2, 3, 64, 8), ValueError),    # H = 3 at L = 64: pack factor 1, at D = 8
])
def test_stages_the_route_does_not_take_raise(shape, err):
    q = torch.zeros(shape)
    with pytest.raises(err):
        fused_attention_dense(q, q, q)


def test_jax_global_max_underflows_where_the_port_is_exact(jax_dense_calls):
    """At (L, H) = (16, 32), P = 8, head 0's logits sit about 130 above
    head 1's at every query position, in one packed group. JAX's kernel
    subtracts one max over the packed row, so head 1's exponentials
    underflow and its output collapses; the port's plain version takes
    each head's own max and equals attention_reference (1e-4: logits near
    70 carry roundings of up to 1e-5)."""
    q, k, v, bias = _operands(2, 32, 16, True, seed=3)
    bias[0, 0] += 65.0
    bias[0, 1] -= 65.0
    ref = attention_reference(*map(_t, (q, k, v, bias))).numpy()
    port = attention_dense_reference(*map(_t, (q, k, v, bias))).numpy()
    np.testing.assert_allclose(port, ref, atol=1e-4, rtol=0)
    jax_out = np.asarray(ap.fused_attention(q, k, v, bias))
    assert jax_dense_calls
    np.testing.assert_allclose(jax_out[:, 0], ref[:, 0], atol=1e-4, rtol=0)
    gap = np.abs(jax_out[:, 1] - ref[:, 1]).max()
    assert gap > 0.1, gap  # the low head collapsed toward zero
    assert np.abs(jax_out[:, 1]).max() < 1e-3 * np.abs(ref[:, 1]).max()
