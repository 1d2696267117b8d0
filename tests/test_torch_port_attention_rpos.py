"""The port's per-window R-peak attention against the JAX package's, on
the CPU.

* The per-window `RelativePositionEmbedding` returns JAX's `RPosBias`:
  toep, offsets and `materialize()` to 1e-6, on the same nonzero table.
* `fused_attention_rpos` on CPU tensors runs its plain version
  (`attention_rpos_reference`), which is held against the JAX package's
  `fused_attention_rpos` with the Pallas pair (`_fwd_rpos_kernel`,
  `_bwd_rpos_kernel`) run in interpret mode, as
  tests/test_pallas_attention.py runs it: the output to 1e-5 (`:65`) and
  the gradients of q, k, v and toep, through autograd, to 1e-4 (`:85`).
* `attention_rpos_backward_reference`, the plain version of the backward
  kernel (flash form, from the forward's lse), equals autograd through the
  plain forward to 1e-5.

Shapes are the four biased stages of RA-LENet as (L, W, H), D = 4, with
R peaks at 0, 5, L/2 and L - 1 so that windows hang off both ends.
"""

import numpy as np
import pytest
import torch
torch.set_num_threads(1)  # six test workers share the host's cores: one intra-op thread each
import jax
import jax.numpy as jnp

import ecg_denoise_tpu.kernels.attention_pallas as ap
from ecg_denoise_tpu.ops.attention import RelativePositionEmbedding as JaxRPE
from ecg_denoise_tpu_torch.kernels.attention_rpos import (
    attention_rpos_backward_reference,
    attention_rpos_reference,
    fused_attention_rpos,
    materialize_rpos_bias,
)
from ecg_denoise_tpu_torch.ops.attention import RelativePositionEmbedding, RPosBias

STAGES = [(256, 32, 2), (128, 16, 4), (64, 8, 8), (32, 4, 16)]
FWD_ATOL = 1e-5
JAX_GRAD_ATOL = 1e-4
ATOL = 1e-5


def _r_pos(L):
    return np.array([0, 5, L // 2, L - 1])


def _toep(table, L, W):
    """(1, H, L, L) Toeplitz expansion of a (2W-1, H) table."""
    pos = np.arange(L)
    rel = pos[:, None] - pos[None, :]
    t = table[np.clip(rel + W - 1, 0, 2 * W - 2)] * (np.abs(rel) < W)[..., None]
    return np.ascontiguousarray(t.transpose(2, 0, 1)[None]).astype(np.float32)


def _operands(L, W, H, seed=0):
    """q, k, v, the output gradient g, toep and offsets, as numpy."""
    rng = np.random.default_rng(seed)
    q, k, v, g = (rng.standard_normal((4, H, L, 4)).astype(np.float32)
                  for _ in range(4))
    toep = _toep(rng.standard_normal((2 * W - 1, H)), L, W)
    offsets = (_r_pos(L) - W // 2).astype(np.float32)
    return q, k, v, g, toep, offsets


@pytest.mark.parametrize("L,W,H", STAGES)
def test_per_window_embedding_matches_jax_rposbias(L, W, H):
    table = np.random.default_rng(L).standard_normal((2 * W - 1, H)).astype(np.float32)
    r_pos = _r_pos(L)
    ref = JaxRPE(length=W, whole_length=L, num_heads=H).apply(
        {"params": {"relative_position_bias_table": jnp.asarray(table)}},
        jnp.asarray(r_pos, jnp.int32))
    mod = RelativePositionEmbedding(W, L, H)
    with torch.no_grad():
        mod.relative_position_bias_table.copy_(torch.from_numpy(table))
    got = mod(torch.from_numpy(r_pos))
    assert isinstance(got, RPosBias) and got.W == ref.W == W
    assert got.offsets.dtype == torch.float32 and got.toep.shape == (1, H, L, L)
    for a, b in ((got.toep, ref.toep), (got.offsets, ref.offsets),
                 (got.materialize(), ref.materialize())):
        np.testing.assert_allclose(a.detach().numpy(), np.asarray(b), atol=1e-6, rtol=0)


def test_materialized_bias_equals_the_scalar_embedding_per_window():
    """Each window's slice of the per-window bias is the (1, H, L, L) bias
    the scalar r_pos path builds, edge truncation included."""
    W, L, H = 8, 64, 2
    mod = RelativePositionEmbedding(W, L, H)
    with torch.no_grad():
        mod.relative_position_bias_table.normal_(generator=torch.Generator().manual_seed(0))
        r_pos = torch.tensor([0, 3, 32, 60, 63])
        full = mod(r_pos).materialize()
        for i, rp in enumerate(r_pos.tolist()):
            torch.testing.assert_close(full[i], mod(rp)[0], atol=0, rtol=0)


@pytest.mark.parametrize("L,W,H", STAGES)
def test_forward_and_grads_match_pallas_interpret(monkeypatch, L, W, H):
    monkeypatch.setattr(ap, "_INTERPRET", True)
    q, k, v, g, toep, offsets = _operands(L, W, H, seed=L)
    off = jnp.asarray(offsets)
    ref_out, vjp = jax.vjp(
        lambda q, k, v, t: ap.fused_attention_rpos(q, k, v, t, W, off),
        *map(jnp.asarray, (q, k, v, toep)))
    ref = vjp(jnp.asarray(g))
    ins = [torch.from_numpy(a).requires_grad_() for a in (q, k, v, toep)]
    out = fused_attention_rpos(*ins, W, torch.from_numpy(offsets))
    np.testing.assert_allclose(out.detach().numpy(), np.asarray(ref_out),
                               atol=FWD_ATOL, rtol=0)
    grads = torch.autograd.grad(out, ins, torch.from_numpy(g))
    for name, a, b in zip(("dq", "dk", "dv", "dtoep"), grads, ref):
        np.testing.assert_allclose(a.numpy(), np.asarray(b), atol=JAX_GRAD_ATOL,
                                   rtol=0, err_msg=name)


@pytest.mark.parametrize("L,W,H", STAGES)
def test_backward_reference_matches_autograd(L, W, H):
    q, k, v, g, toep, offsets = map(torch.from_numpy, _operands(L, W, H, seed=7))
    o, lse = attention_rpos_reference(q, k, v, toep, W, offsets, return_lse=True)
    ins = [t.requires_grad_() for t in (q, k, v, toep)]
    auto = torch.autograd.grad(attention_rpos_reference(*ins, W, offsets), ins, g)
    flash = attention_rpos_backward_reference(q, k, v, toep, W, offsets, o, lse, g)
    for name, a, b in zip(("dq", "dk", "dv", "dtoep"), flash, auto):
        torch.testing.assert_close(a, b, atol=ATOL, rtol=0, msg=name)
    # dtoep is zero wherever no window holds both l and m.
    reach = materialize_rpos_bias(torch.ones_like(toep), W, offsets).sum(0, keepdim=True)
    assert torch.all(flash[3][reach == 0] == 0)


def test_forward_lse_is_the_rows_logsumexp():
    q, k, v, _, toep, offsets = map(torch.from_numpy, _operands(64, 8, 8))
    out, lse = attention_rpos_reference(q, k, v, toep, 8, offsets, return_lse=True)
    logits = (torch.einsum("bhld,bhmd->bhlm", q, k)
              + materialize_rpos_bias(toep, 8, offsets))
    assert lse.shape == (4, 8, 64) and lse.dtype == torch.float32
    torch.testing.assert_close(lse, torch.logsumexp(logits.double(), -1).float(),
                               atol=ATOL, rtol=0)
    torch.testing.assert_close(out, attention_rpos_reference(q, k, v, toep, 8, offsets),
                               atol=0, rtol=0)


def test_cpu_tensors_never_reach_the_kernels():
    q, k, v, g, toep, offsets = map(torch.from_numpy, _operands(32, 4, 16))
    ins = [t.requires_grad_() for t in (q, k, v, toep)]
    before = (fused_attention_rpos.launches, fused_attention_rpos.bwd_launches)
    fused_attention_rpos(*ins, 4, offsets).backward(g)
    assert all(t.grad is not None for t in ins)
    assert (fused_attention_rpos.launches, fused_attention_rpos.bwd_launches) == before


@pytest.mark.parametrize("change,error", [
    (dict(offsets=torch.zeros(3)), ValueError),                    # not (B,)
    (dict(offsets=torch.zeros(4, dtype=torch.int64)), ValueError),  # not float32
    (dict(W=0), ValueError),
    (dict(toep=None), ValueError),
    (dict(toep=torch.zeros(1, 16, 32, 32, dtype=torch.bfloat16)), TypeError),
])
def test_bad_arguments_raise(change, error):
    q, k, v, _, toep, offsets = map(torch.from_numpy, _operands(32, 4, 16))
    args = dict(toep=toep, W=4, offsets=offsets) | change
    with pytest.raises(error):
        fused_attention_rpos(q, k, v, **args)
