"""The port's attention gradients against the JAX package's, on the CPU.

`fused_attention` on CPU tensors runs the plain version, and autograd runs
through it. Its gradients are held against `jax.vjp` of the JAX package's
`fused_attention` with the Pallas kernel pair (`_fwd_kernel`, `_bwd_kernel`)
run in interpret mode, as tests/test_pallas_attention.py runs it, at the
five RA-LENet stage shapes (L, H), D = 4, with and without the bias: atol
1e-4, the JAX package's own bar for the kernel's gradients
(tests/test_pallas_attention.py:125).

`attention_backward_reference`, the plain version of the backward kernel
(flash form, from the forward's lse), is held against autograd through
`attention_reference` at 1e-5, and the forward's lse against logsumexp.
"""

import numpy as np
import pytest
import torch
torch.set_num_threads(1)  # six test workers share the host's cores: one intra-op thread each
import jax
import jax.numpy as jnp

import ecg_denoise_tpu.kernels.attention_pallas as ap
from ecg_denoise_tpu_torch.kernels.attention import (
    attention_backward_reference,
    attention_reference,
    fused_attention,
)

STAGES = [(256, 2), (128, 4), (64, 8), (32, 16), (16, 32)]
JAX_GRAD_ATOL = 1e-4
ATOL = 1e-5


def _operands(B, H, L, with_bias, seed=0):
    """q, k, v, bias and the output gradient g, as numpy float32."""
    rng = np.random.default_rng(seed)
    q, k, v, g = (rng.standard_normal((B, H, L, 4)).astype(np.float32)
                  for _ in range(4))
    bias = (rng.standard_normal((1, H, L, L)).astype(np.float32)
            if with_bias else None)
    return q, k, v, bias, g


def _port_grads(q, k, v, bias, g):
    ins = [torch.from_numpy(a).requires_grad_() for a in (q, k, v)]
    if bias is not None:
        ins.append(torch.from_numpy(bias).requires_grad_())
    out = fused_attention(*ins[:3], ins[3] if bias is not None else None)
    return out, torch.autograd.grad(out, ins, torch.from_numpy(g))


@pytest.mark.parametrize("L,H", STAGES)
@pytest.mark.parametrize("with_bias", [True, False])
def test_grads_match_pallas_interpret(monkeypatch, L, H, with_bias):
    monkeypatch.setattr(ap, "_INTERPRET", True)
    q, k, v, bias, g = _operands(2, H, L, with_bias, seed=L)
    args = tuple(map(jnp.asarray, (q, k, v) + ((bias,) if with_bias else ())))
    f = ((lambda q, k, v, b: ap.fused_attention(q, k, v, b)) if with_bias
         else (lambda q, k, v: ap.fused_attention(q, k, v)))
    ref_out, vjp = jax.vjp(f, *args)
    ref = vjp(jnp.asarray(g))
    out, grads = _port_grads(q, k, v, bias, g)
    np.testing.assert_allclose(out.detach().numpy(), np.asarray(ref_out),
                               atol=ATOL, rtol=0)
    assert len(grads) == len(ref)
    for name, a, b in zip("q k v bias".split(), grads, ref):
        np.testing.assert_allclose(a.numpy(), np.asarray(b), atol=JAX_GRAD_ATOL,
                                   rtol=0, err_msg=f"d{name}")


@pytest.mark.parametrize("L,H", STAGES)
@pytest.mark.parametrize("with_bias", [True, False])
def test_backward_reference_matches_autograd(L, H, with_bias):
    q, k, v, bias, g = map(lambda a: None if a is None else torch.from_numpy(a),
                           _operands(3, H, L, with_bias, seed=7))
    o, lse = attention_reference(q, k, v, bias, return_lse=True)
    ins = [t.requires_grad_() for t in (q, k, v, bias) if t is not None]
    auto = torch.autograd.grad(attention_reference(q, k, v, bias), ins, g)
    flash = attention_backward_reference(q, k, v, bias, o, lse, g)
    assert (flash[3] is None) == (bias is None)
    for name, a, b in zip("q k v bias".split(), flash, auto):
        torch.testing.assert_close(a, b, atol=ATOL, rtol=0, msg=f"d{name}")


def test_forward_lse_is_the_rows_logsumexp():
    q, k, v, bias, _ = map(torch.from_numpy, _operands(2, 4, 32, True))
    out, lse = attention_reference(q, k, v, bias, return_lse=True)
    logits = torch.einsum("bhld,bhmd->bhlm", q, k) + bias
    assert lse.shape == (2, 4, 32) and lse.dtype == torch.float32
    torch.testing.assert_close(lse, torch.logsumexp(logits.double(), -1).float(),
                               atol=ATOL, rtol=0)
    torch.testing.assert_close(out, attention_reference(q, k, v, bias), atol=0, rtol=0)


def test_bias_gradient_only_when_asked():
    """No bias gradient is formed for a bias that does not need one, and
    CPU tensors never reach the kernels, forward or backward."""
    q, k, v, bias, g = map(torch.from_numpy, _operands(2, 4, 32, True))
    q.requires_grad_()
    before = (fused_attention.launches, fused_attention.bwd_launches)
    fused_attention(q, k, v, bias).backward(torch.from_numpy(g.numpy()))
    assert q.grad is not None and bias.grad is None
    assert (fused_attention.launches, fused_attention.bwd_launches) == before

