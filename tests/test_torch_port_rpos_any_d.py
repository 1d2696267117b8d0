"""R-peak attention (B3, B4) at every head dim and length, against the JAX
package, on the CPU.

JAX's `fused_attention_rpos` takes any head dim D and length L (its
kernels take a whole packed row), and so does the port: on the CPU
`fused_attention_rpos` runs its plain version at every shape, and on the
card D = 4 at L <= 256 keeps the D = 4 kernels while every other shape
goes to B3's and B4's window kernels (D <= 64, D = 4 unpadded) or B1's and
B2's wide kernels in their window mode, the operands zero-padded along D
(`rpos_head_dim`, `forward_at`, `backward_at`).

* The port's `multi_head_attention` with an `RPosBias` at (L, D) = (64, 8)
  and (512, 4), B = 2, H = 2, W = 16, offsets (3, 10), against JAX's
  `multi_head_attention` on its XLA path (`use_pallas=False`) and against
  JAX's `fused_attention_rpos` with the Pallas pair run in interpret mode:
  the output within 1e-5, the gradients of q, k, v and toep within 1e-4
  (tests/test_pallas_attention.py:65,85). Before, the port raised there.
* The plain versions against JAX's Pallas pair in interpret mode at D = 8,
  16, 32, 64, 128 (L = 64) and D = 4, 16 (L = 300), q scaled by D^-1/2,
  R peaks at 0, 5, L/2 and L - 1 so that windows hang off both ends: the
  same bars; and `attention_rpos_backward_reference` (the flash form)
  against autograd through the plain forward within 1e-5.
* One `BasicLayer` (depth 1) at (L, W, H, D) = (64, 8, 2, 32) with the
  per-window `RelativePositionEmbedding`, against the JAX layer: the output
  and the rel-pos table's gradient within 1e-4 (of its largest for the
  gradient).
* The card's routing: `kernel_head_dim` keeps (D, L) = (4, 256) on the D = 4
  kernels and pads (4, 300), (8, 64) stays, (128, 64) stays on the wide
  kernels; B3 and B4 (`rpos_head_dim`) keep D = 4 unpadded at any L (past 256 keys on their window kernels),
  f32 and bf16, and take `kernel_head_dim`'s at every other D; the card
  wrappers, their launches replaced by the plain versions, call them at
  those head dims and slice the results back. At (B, H, L, D, W) = (2, 2,
  300, 4, 40), with an offset negative, one past L - W or one NaN, the
  unpadded forward's o and lse, and B4's unpadded gradients from them,
  equal the padded route's within 1e-6.
* The kernel build's hash covers the headers a source includes (the
  templates B1-B4 share live in `csrc/*.cuh`), so an edited header never
  loads a stale library.
"""

import numpy as np
import pytest
import torch
torch.set_num_threads(1)  # six test workers share the host's cores: one intra-op thread each
import jax
import jax.numpy as jnp

import ecg_denoise_tpu.kernels.attention_pallas as ap
import ecg_denoise_tpu.ops.attention as jatt
from ecg_denoise_tpu_torch.interop.jax_weights import state_dict_from_variables
from ecg_denoise_tpu_torch.kernels import attention_rpos, build
from ecg_denoise_tpu_torch.kernels.attention import backward_at, forward_at, kernel_head_dim
from ecg_denoise_tpu_torch.kernels.attention_rpos import (
    attention_rpos_backward_reference,
    attention_rpos_reference,
    fused_attention_rpos,
    rpos_head_dim,
)
from ecg_denoise_tpu_torch.ops import attention as patt
from test_torch_port_layers import random_variables

FWD_ATOL = 1e-5
GRAD_ATOL = 1e-4
FLASH_ATOL = 1e-5
LAYER_ATOL = 1e-4
# (L, D) of the plain versions' cases: every width class of the card's
# kernels at L = 64, and two lengths past the D = 4 kernels' 256.
SHAPES = [(64, 8), (64, 16), (64, 32), (64, 64), (64, 128), (300, 4), (300, 16)]


@pytest.fixture(autouse=True)
def _interpret_mode(monkeypatch):
    monkeypatch.setattr(ap, "_INTERPRET", True)


def _toep(table, L, W):
    """(1, H, L, L) Toeplitz expansion of a (2W-1, H) table."""
    pos = np.arange(L)
    rel = pos[:, None] - pos[None, :]
    t = table[np.clip(rel + W - 1, 0, 2 * W - 2)] * (np.abs(rel) < W)[..., None]
    return np.ascontiguousarray(t.transpose(2, 0, 1)[None]).astype(np.float32)


def _operands(B, H, L, D, W, offsets, seed):
    """q (scaled by D^-1/2), k, v, the output gradient g and toep, as numpy."""
    rng = np.random.default_rng(seed)
    q, k, v, g = (rng.standard_normal((B, H, L, D)).astype(np.float32) for _ in range(4))
    q = (q * D ** -0.5).astype(np.float32)
    toep = _toep(rng.standard_normal((2 * W - 1, H)), L, W)
    return q, k, v, g, toep, np.asarray(offsets, np.float32)


def _windows(L):
    """W = L / 8 (RA-LENet's rule) and the offsets of R peaks at 0, 5, L/2
    and L - 1: windows cut at both ends."""
    W = L // 8
    return W, np.array([0, 5, L // 2, L - 1]) - W // 2


def _port_grads(q, k, v, g, toep, W, offsets, attend):
    ins = [torch.from_numpy(a).requires_grad_() for a in (q, k, v, toep)]
    out = attend(*ins, W, torch.from_numpy(offsets))
    return out.detach().numpy(), [t.numpy() for t in torch.autograd.grad(
        out, ins, torch.from_numpy(g))]


def _jax_grads(q, k, v, g, toep, attend):
    out, vjp = jax.vjp(attend, *map(jnp.asarray, (q, k, v, toep)))
    return np.asarray(out), [np.asarray(t) for t in vjp(jnp.asarray(g))]


def _assert_close(got, want):
    np.testing.assert_allclose(got[0], want[0], atol=FWD_ATOL, rtol=0, err_msg="out")
    for name, a, b in zip(("dq", "dk", "dv", "dtoep"), got[1], want[1]):
        np.testing.assert_allclose(a, b, atol=GRAD_ATOL, rtol=0, err_msg=name)


@pytest.mark.parametrize("L,D", [(64, 8), (512, 4)])
def test_rpos_multi_head_attention_takes_what_jax_takes(L, D):
    """C6: the port's `multi_head_attention` with an `RPosBias` at a head
    dim other than 4 and at D = 4 past 256 keys returns, as JAX's does."""
    W = 16
    q, k, v, g, toep, offsets = _operands(2, 2, L, D, W, (3, 10), seed=L + D)
    off = jnp.asarray(offsets)

    def port(q, k, v, toep, W, offsets):
        return patt.multi_head_attention(q, k, v, patt.RPosBias(toep=toep, offsets=offsets, W=W))

    got = _port_grads(q, k, v, g, toep, W, offsets, port)
    xla = _jax_grads(q, k, v, g, toep, lambda q, k, v, t: jatt.multi_head_attention(
        q, k, v, jatt.RPosBias(toep=t, offsets=off, W=W)))
    pallas = _jax_grads(q, k, v, g, toep,
                        lambda q, k, v, t: ap.fused_attention_rpos(q, k, v, t, W, off))
    _assert_close(got, xla)
    _assert_close(got, pallas)


@pytest.mark.parametrize("L,D", SHAPES)
def test_plain_versions_match_pallas_interpret(L, D):
    W, offsets = _windows(L)
    q, k, v, g, toep, offsets = _operands(4, 2, L, D, W, offsets, seed=L * D)
    off = jnp.asarray(offsets)
    got = _port_grads(q, k, v, g, toep, W, offsets, fused_attention_rpos)
    want = _jax_grads(q, k, v, g, toep,
                      lambda q, k, v, t: ap.fused_attention_rpos(q, k, v, t, W, off))
    _assert_close(got, want)


@pytest.mark.parametrize("L,D", SHAPES)
def test_backward_reference_matches_autograd(L, D):
    W, offsets = _windows(L)
    q, k, v, g, toep, offsets = map(torch.from_numpy,
                                    _operands(4, 2, L, D, W, offsets, seed=L + D))
    o, lse = attention_rpos_reference(q, k, v, toep, W, offsets, return_lse=True)
    ins = [t.clone().requires_grad_() for t in (q, k, v, toep)]
    auto = torch.autograd.grad(attention_rpos_reference(*ins, W, offsets), ins, g)
    flash = attention_rpos_backward_reference(q, k, v, toep, W, offsets, o, lse, g)
    for name, a, b in zip(("dq", "dk", "dv", "dtoep"), flash, auto):
        torch.testing.assert_close(a, b, atol=FLASH_ATOL, rtol=0, msg=name)


def test_basic_layer_with_the_per_window_embedding_matches_jax():
    """RA-LENet's first stage with 32-wide heads at a quarter of its length:
    BasicLayer(dim 64, depth 1, 2 heads) behind the per-window embedding,
    R peaks from windows hanging off both ends."""
    B, L, W, H, D = 4, 64, 8, 2, 32
    rng = np.random.default_rng(64)
    x = rng.standard_normal((B, L, H * D)).astype(np.float32)
    table = rng.standard_normal((2 * W - 1, H)).astype(np.float32)
    r_pos = np.array([0, 5, L // 2, L - 1])

    def jax_out(table):
        mask = jatt.RelativePositionEmbedding(length=W, whole_length=L, num_heads=H).apply(
            {"params": {"relative_position_bias_table": table}}, jnp.asarray(r_pos, jnp.int32))
        return jm.apply(variables, jnp.asarray(x), mask)

    jm = jatt.BasicLayer(H * D, 1, H, local_enhence=True)
    mask0 = jatt.RelativePositionEmbedding(length=W, whole_length=L, num_heads=H).apply(
        {"params": {"relative_position_bias_table": jnp.asarray(table)}},
        jnp.asarray(r_pos, jnp.int32))
    variables = random_variables(jm, jnp.asarray(x), mask0)
    ref, vjp = jax.vjp(jax_out, jnp.asarray(table))
    g = rng.standard_normal(ref.shape).astype(np.float32)
    ref_table_grad = np.asarray(vjp(jnp.asarray(g))[0])

    layer = patt.BasicLayer(H * D, 1, H, local_enhence=True)
    layer.load_state_dict(state_dict_from_variables(variables))
    layer.eval()
    rpe = patt.RelativePositionEmbedding(W, L, H)
    with torch.no_grad():
        rpe.relative_position_bias_table.copy_(torch.from_numpy(table))
    out = layer(torch.from_numpy(x), rpe(torch.from_numpy(r_pos)))
    np.testing.assert_allclose(out.detach().numpy(), np.asarray(ref), atol=LAYER_ATOL, rtol=0)
    (table_grad,) = torch.autograd.grad(out, rpe.relative_position_bias_table,
                                        torch.from_numpy(g))
    bar = LAYER_ATOL * np.abs(ref_table_grad).max()
    assert np.abs(table_grad.numpy() - ref_table_grad).max() <= bar


def test_kernel_head_dim_routes_rpos_calls():
    """(D, L) = (4, 256) stays on the D = 4 kernels; (4, 300) takes the
    template at 8 (bf16 16), (8, 64) the template as it is and (128, 64)
    the wide kernels as they are."""
    assert kernel_head_dim(4, 256, torch.float32) == 4
    assert kernel_head_dim(4, 300, torch.float32) == 8
    assert kernel_head_dim(4, 300, torch.bfloat16) == 16
    assert kernel_head_dim(8, 64, torch.float32) == 8
    assert kernel_head_dim(128, 64, torch.float32) == 128


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_forward_head_dim_keeps_d4_unpadded_past_256_keys(dtype):
    """B3 (and B4) take D = 4 as it is at any L (the D = 4 kernels to 256
    keys, the window kernels past them) and every other D at
    `kernel_head_dim`'s, which pads D = 4 past 256 keys for B1 and B2."""
    for L in (1, 256, 257, 300, 1000):
        assert rpos_head_dim(4, L, dtype) == 4
    assert kernel_head_dim(4, 300, dtype) == (8 if dtype == torch.float32 else 16)
    for D, L in ((3, 300), (8, 64), (24, 300), (64, 1000), (72, 64), (128, 64)):
        assert rpos_head_dim(D, L, dtype) == kernel_head_dim(D, L, dtype)


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("D,L", [(4, 1), (4, 256), (4, 257), (4, 300), (4, 1000), (3, 300),
                                 (8, 64), (12, 1000), (24, 300), (64, 1000), (72, 64),
                                 (128, 64)])
def test_rpos_head_dim_at_each_shape(D, L, dtype):
    """The head dim of a (D, L) call on the card, case by case: D = 4 as it
    is at every L, 8/16/32/64 (bf16 from 16) or the next multiple of 64
    otherwise (4 at L = 300 would be 8, bf16 16, under `kernel_head_dim`)."""
    want = {(4, 1): 4, (4, 256): 4, (4, 257): 4, (4, 300): 4, (4, 1000): 4, (3, 300): 8,
            (8, 64): 8, (12, 1000): 16, (24, 300): 32, (64, 1000): 64, (72, 64): 128,
            (128, 64): 128}[D, L]
    if dtype == torch.bfloat16 and want < 16:
        want = 4 if D == 4 else 16
    assert rpos_head_dim(D, L, dtype) == want


def _plain_kernels(monkeypatch, calls):
    """The card wrappers' launches replaced by the plain versions, each
    call's kernel and head dim recorded in `calls`: the two plain
    launches."""

    def plain_fwd(q, k, v, toep, *, W, offsets, with_lse):
        calls.append(("fwd", q.shape[-1], with_lse))
        return attention_rpos_reference(q, k, v, toep, W, offsets, return_lse=with_lse)

    def plain_bwd(q, k, v, toep, o, lse, g, *, W, offsets):
        calls.append(("bwd", q.shape[-1]))
        return attention_rpos_backward_reference(q, k, v, toep, W, offsets, o, lse, g)

    monkeypatch.setattr(attention_rpos, "_launch_kernel", plain_fwd)
    monkeypatch.setattr(attention_rpos, "_launch_bwd_kernel", plain_bwd)
    return plain_fwd, plain_bwd


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_b3_runs_d4_unpadded_past_256_keys_while_b4_pads(monkeypatch, dtype):
    """Through the autograd Function's wrappers at (L, D) = (300, 4): the
    forward kernel and, since B4 has a window kernel of its own, the
    backward are called at D = 4 (`kernel_head_dim`, B1's and B2's rule,
    would pad it to 8, bf16 16)."""
    calls = []
    _plain_kernels(monkeypatch, calls)
    W, offsets = _windows(300)
    q, k, v, g, toep, offsets = (torch.from_numpy(a) for a in
                                 _operands(4, 2, 300, 4, W, offsets, seed=7))
    q, k, v, g, toep = (t.to(dtype) for t in (q, k, v, g, toep))
    out, lse = attention_rpos._launch(q, k, v, toep, W, offsets, with_lse=True)
    grads = attention_rpos._launch_bwd(q, k, v, toep, W, offsets, out, lse, g)
    assert calls == [("fwd", 4, True), ("bwd", 4)]
    assert kernel_head_dim(4, 300, dtype) == (8 if dtype == torch.float32 else 16)
    assert out.shape == q.shape and out.dtype == dtype
    assert [t.shape for t in grads] == [q.shape, k.shape, v.shape, toep.shape]


@pytest.mark.parametrize("offsets", [(-17.0, 150.0), (100.0, 280.0), (float("nan"), 5.0)],
                         ids=["negative", "past_L_minus_W", "nan"])
def test_unpadded_forward_equals_the_padded_route(monkeypatch, offsets):
    """At (B, H, L, D, W) = (2, 2, 300, 4, 40) with the plain versions as the
    kernels: B3's unpadded forward (o, lse) and B4's unpadded gradients
    from it equal the padded route's (both kernels at `kernel_head_dim`)
    within 1e-6 of each tensor's largest (1 where that is below 1)."""
    calls = []
    plain_fwd, plain_bwd = _plain_kernels(monkeypatch, calls)
    W = 40
    q, k, v, g, toep, offsets = (torch.from_numpy(a) for a in
                                 _operands(2, 2, 300, 4, W, offsets, seed=23))
    got = attention_rpos._launch(q, k, v, toep, W, offsets, with_lse=True)
    want = forward_at(kernel_head_dim(4, 300, q.dtype), plain_fwd, q, k, v, toep, W=W,
                      offsets=offsets, with_lse=True)
    assert [c[1] for c in calls] == [4, 8]
    got_grads = attention_rpos._launch_bwd(q, k, v, toep, W, offsets, *got, g)
    want_grads = backward_at(kernel_head_dim(4, 300, q.dtype), plain_bwd, q, k, v, toep,
                             *want, g, W=W, offsets=offsets)
    assert [c[1] for c in calls[2:]] == [4, 8]
    for name, a, b in zip("out lse q k v toep".split(), (*got, *got_grads),
                          (*want, *want_grads)):
        assert a.shape == b.shape and bool(torch.isfinite(a).all()), name
        bar = 1e-6 * max(1.0, b.abs().max().item())
        assert (a - b).abs().max().item() <= bar, name


@pytest.mark.parametrize("L,d,padded", [(256, 4, 4), (300, 4, 8), (40, 12, 16), (24, 72, 128)])
def test_card_wrappers_pad_and_slice_back(monkeypatch, L, d, padded):
    """The r-pos card wrappers call their kernels at their head dims (B3
    and B4 at `rpos_head_dim`'s; `padded` is `kernel_head_dim`'s, which
    both take but at D = 4) on zero-padded
    operands and slice the results back; with the plain versions as the
    kernels the results are the unpadded calls', within 1e-6 of each
    tensor's largest."""
    calls = []
    _plain_kernels(monkeypatch, calls)
    W, offsets = _windows(L)
    q, k, v, g, toep, offsets = map(torch.from_numpy,
                                    _operands(4, 2, L, d, W, offsets, seed=L + d))
    out, lse = attention_rpos._launch(q, k, v, toep, W, offsets, with_lse=True)
    grads = attention_rpos._launch_bwd(q, k, v, toep, W, offsets, out, lse, g)
    assert calls == [("fwd", rpos_head_dim(d, L, q.dtype), True),
                     ("bwd", rpos_head_dim(d, L, q.dtype))]
    assert kernel_head_dim(d, L, q.dtype) == padded
    if d != 4:
        assert rpos_head_dim(d, L, q.dtype) == padded
    ref, ref_lse = attention_rpos_reference(q, k, v, toep, W, offsets, return_lse=True)
    ref_grads = attention_rpos_backward_reference(q, k, v, toep, W, offsets, ref, ref_lse, g)
    for name, got, want in zip("out lse q k v toep".split(), (out, lse, *grads),
                               (ref, ref_lse, *ref_grads)):
        assert got.shape == want.shape and got.is_contiguous(), name
        bar = 1e-6 * want.abs().max().item()
        assert (got - want).abs().max().item() <= bar, name


def test_build_hash_covers_included_headers(tmp_path):
    """`build.sources` follows quoted includes through the headers, once
    each; `_target` changes when any of them does, and not otherwise."""
    (tmp_path / "k.cu").write_text('#include <cuda_runtime.h>\n#include "a.cuh"\n'
                                   '#include "b.cuh"\n')
    (tmp_path / "a.cuh").write_text('#pragma once\n  #  include "b.cuh"\n')
    (tmp_path / "b.cuh").write_text("#pragma once\n")
    assert [p.name for p in build.sources("k", tmp_path)] == ["k.cu", "a.cuh", "b.cuh"]
    before = build._target("k", tmp_path)
    assert build._target("k", tmp_path) == before
    (tmp_path / "b.cuh").write_text("#pragma once\n// edited\n")
    assert build._target("k", tmp_path) != before
    names = [p.name for p in build.sources("attention_rpos_bwd", build.CSRC)]
    assert names == ["attention_rpos_bwd.cu", "attention_bwd_mma.cuh",
                     "attention_rpos_bwd_mma.cuh", "attention_window.cuh",
                     "attention_rpos_fwd_mma.cuh", "attention_fwd_mma.cuh"]
    names = [p.name for p in build.sources("attention_rpos_fwd", build.CSRC)]
    assert names == ["attention_rpos_fwd.cu", "attention_fwd_mma.cuh",
                     "attention_rpos_fwd_mma.cuh", "attention_window.cuh"]
