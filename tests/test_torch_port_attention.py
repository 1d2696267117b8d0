"""The port's attention and rel-pos bias against the JAX package's.

`attention_reference` — the plain version of the Hopper kernel, and what
`fused_attention` runs for CPU tensors — is held against the JAX XLA path
and against the JAX Pallas kernel run in interpret mode (as
tests/test_pallas_attention.py runs it), at the five RA-LENet stage shapes
(L, H) with D = 4, with and without the (1, H, L, L) bias. Tolerance 1e-5
at float32: all three compute float32 logits and softmax.
"""

import numpy as np
import pytest
import torch
torch.set_num_threads(1)  # six test workers share the host's cores: one intra-op thread each
import jax

import ecg_denoise_tpu.kernels.attention_pallas as ap
import ecg_denoise_tpu.ops.attention as jatt
from ecg_denoise_tpu_torch.kernels.attention import (
    attention_reference,
    fused_attention,
)
from ecg_denoise_tpu_torch.ops import attention as patt

ATOL = 1e-5
STAGES = [(256, 2), (128, 4), (64, 8), (32, 16), (16, 32)]


def _operands(B, H, L, with_bias, seed=0):
    rng = np.random.default_rng(seed)
    q, k, v = (rng.standard_normal((B, H, L, 4)).astype(np.float32)
               for _ in range(3))
    bias = (rng.standard_normal((1, H, L, L)).astype(np.float32)
            if with_bias else None)
    return q, k, v, bias


def _t(a):
    return None if a is None else torch.from_numpy(a)


@pytest.mark.parametrize("L,H", STAGES)
@pytest.mark.parametrize("with_bias", [True, False])
def test_reference_matches_jax_xla(L, H, with_bias):
    q, k, v, bias = _operands(2, H, L, with_bias)
    ref = jatt.multi_head_attention(q, k, v, bias)
    out = attention_reference(*map(_t, (q, k, v, bias)))
    np.testing.assert_allclose(out.numpy(), np.asarray(ref), atol=ATOL, rtol=0)


@pytest.mark.parametrize("L,H", STAGES)
@pytest.mark.parametrize("with_bias", [True, False])
def test_reference_matches_pallas_interpret(monkeypatch, L, H, with_bias):
    monkeypatch.setattr(ap, "_INTERPRET", True)
    q, k, v, bias = _operands(3, H, L, with_bias, seed=1)
    ref = ap.fused_attention(q, k, v, bias)
    out = attention_reference(*map(_t, (q, k, v, bias)))
    np.testing.assert_allclose(out.numpy(), np.asarray(ref), atol=ATOL, rtol=0)


def test_cpu_tensors_take_the_plain_version():
    q, k, v, bias = map(_t, _operands(2, 4, 32, True))
    before = fused_attention.launches
    out = patt.multi_head_attention(q, k, v, bias)
    torch.testing.assert_close(out, attention_reference(q, k, v, bias),
                               atol=0, rtol=0)
    assert fused_attention.launches == before  # no kernel on the CPU


def test_large_logits_subtract_the_row_max():
    """Trained logits reach ~190 at the L=16 stage; exp without the row
    max would overflow float32. Tolerance 1e-4: a float32 logit near 256
    carries a rounding of up to 1.5e-5, which exp passes on as a relative
    error of that size, on outputs of |v| up to ~4."""
    q, k, v, bias = map(_t, _operands(2, 32, 16, True))
    q, bias = q * 30.0, bias * 60.0
    assert torch.einsum("bhld,bhmd->bhlm", q, k).add(bias).max() > 150
    out = fused_attention(q, k, v, bias)
    assert torch.isfinite(out).all()
    ref = jatt.multi_head_attention(*(a.numpy() for a in (q, k, v, bias)))
    np.testing.assert_allclose(out.numpy(), np.asarray(ref), atol=1e-4, rtol=0)


# On the CPU any head dim and length are in the contract (JAX's kernels
# take them; the card's limits are `kernel_head_dim`'s,
# test_torch_port_long.py): what still raises is a shape, bias or dtype
# outside it.
@pytest.mark.parametrize("shape,bias_shape,dtype,err", [
    ((4, 32, 8), None, torch.float32, ValueError),              # no head axis
    ((1, 2, 512, 4), (1, 2, 512, 256), torch.float32, ValueError),  # bias for another L
    ((2, 4, 32, 4), (2, 4, 32, 32), torch.float32, ValueError),  # per-window bias
    ((2, 4, 32, 4), None, torch.float16, TypeError),
])
def test_contract_violations_raise(shape, bias_shape, dtype, err):
    q = torch.zeros(shape, dtype=dtype)
    bias = None if bias_shape is None else torch.zeros(bias_shape, dtype=dtype)
    with pytest.raises(err):
        fused_attention(q, q, q, bias)


def _jax_relpos(W, L, H, table, r_pos):
    m = jatt.RelativePositionEmbedding(length=W, whole_length=L, num_heads=H)
    return np.asarray(m.apply(
        {"params": {"relative_position_bias_table": table}}, r_pos))


@pytest.mark.parametrize("W,L,H", [(32, 256, 2), (8, 64, 8), (4, 32, 16)])
@pytest.mark.parametrize("r_pos", ["none", "zero", "last"])
def test_relative_position_embedding(W, L, H, r_pos):
    """Centred window, and R peaks at both edges (window truncated)."""
    table = np.random.default_rng(3).standard_normal((2 * W - 1, H)).astype(np.float32)
    rp = {"none": None, "zero": 0, "last": L - 1}[r_pos]
    m = patt.RelativePositionEmbedding(W, L, H)
    with torch.no_grad():
        m.relative_position_bias_table.copy_(torch.from_numpy(table))
    out = m(rp)
    assert out.shape == (1, H, L, L) and out.is_contiguous()
    np.testing.assert_array_equal(out.detach().numpy(),
                                  _jax_relpos(W, L, H, table, rp))
    if rp is not None:  # truncated at the edge: fewer nonzero rows than W
        rows = (out[0, 0].abs().sum(-1) > 0).sum().item()
        assert rows == W - W // 2 if rp == 0 else rows == W // 2 + 1


def test_relative_position_table_starts_at_zero():
    m = patt.RelativePositionEmbedding(4, 32, 16)
    assert not m().any()
    per_window = m(torch.tensor([3, 5]))  # the per-window form, RPosBias
    assert isinstance(per_window, patt.RPosBias) and not per_window.toep.any()
    assert per_window.offsets.tolist() == [1.0, 3.0]
