"""B4's dtoep past the D = 4 kernels, built from the dq pass's ds, against
the JAX package on the CPU.

On the card every r-pos backward but D = 4 at L <= 256 runs B4's window
kernel (D <= 64) or B2's wide passes in their window mode; their dq pass
leaves each head's ds inside its batch
element's window in a float32 (B, H, W', W') scratch, W' = min(W, L), and a
second kernel sums it over the batch, b ascending, into dtoep. The plain
versions of the two steps, `window_ds` and `dtoep_from_window_ds`
(kernels/attention_rpos.py), are held here:

* on ds from seeded numpy operands (the flash form's ds on the plain
  forward's o and lse), against dtoep from JAX's `fused_attention_rpos`
  with its Pallas pair (`_bwd_rpos_kernel`) in interpret mode and against
  `attention_rpos_backward_reference`'s dtoep, within 1e-4 of the largest
  |dtoep| (tests/test_pallas_attention.py:85's dbias bar): windows cut at
  both ends (negative offsets, offsets past L - W), W >= L, B = 1 and 3, at
  (L, W, H, D) = (64, 16, 2, 8), (300, 37, 1, 8) and (24, 32, 2, 8);
* the card wrapper with the kernels' launches replaced by the plain
  versions: the scratch it allocates is (B, H, W', W') float32 past the
  D = 4 kernels and absent at D = 4, the second pass is reached exactly
  there, and the gradients equal the plain backward's.
"""

import numpy as np
import pytest
import torch
torch.set_num_threads(1)  # six test workers share the host's cores: one intra-op thread each
import jax
import jax.numpy as jnp

import ecg_denoise_tpu.kernels.attention_pallas as ap
from ecg_denoise_tpu_torch.kernels import attention_rpos
from ecg_denoise_tpu_torch.kernels.attention import flash_backward_terms
from ecg_denoise_tpu_torch.kernels.attention_rpos import (
    attention_rpos_backward_reference,
    attention_rpos_reference,
    dtoep_from_window_ds,
    materialize_rpos_bias,
    window_bounds,
    window_ds,
)

DTOEP_TOL_OF_MAX = 1e-4
# (L, W, H, D, offsets): windows cut at the start (negative offsets) and at
# the end (offsets past L - W), B = 3 and 1, and W >= L.
CASES = [
    (64, 16, 2, 8, (-5, 20, 56)),
    (64, 16, 2, 8, (-3,)),
    (300, 37, 1, 8, (-18, 140, 281)),
    (300, 37, 1, 8, (270,)),
    (24, 32, 2, 8, (-16, -4, 0)),
    (24, 40, 2, 8, (-10,)),
]


@pytest.fixture(autouse=True)
def _interpret_mode(monkeypatch):
    monkeypatch.setattr(ap, "_INTERPRET", True)


def _toep(table, L, W):
    """(1, H, L, L) Toeplitz expansion of a (2W-1, H) table."""
    pos = np.arange(L)
    rel = pos[:, None] - pos[None, :]
    t = table[np.clip(rel + W - 1, 0, 2 * W - 2)] * (np.abs(rel) < W)[..., None]
    return np.ascontiguousarray(t.transpose(2, 0, 1)[None]).astype(np.float32)


def _operands(L, W, H, D, offsets, seed):
    """q (scaled by D^-1/2), k, v, the output gradient g, toep and the
    offsets, as numpy."""
    rng = np.random.default_rng(seed)
    B = len(offsets)
    q, k, v, g = (rng.standard_normal((B, H, L, D)).astype(np.float32) for _ in range(4))
    q = (q * D ** -0.5).astype(np.float32)
    toep = _toep(rng.standard_normal((2 * W - 1, H)), L, W)
    return q, k, v, g, toep, np.asarray(offsets, np.float32)


def _plain_dtoep(q, k, v, g, toep, W, offsets):
    """dtoep through the two plain steps: ds on the plain forward's o and
    lse, windowed as the dq pass leaves it, then summed."""
    q, k, v, g, toep, offsets = map(torch.from_numpy, (q, k, v, g, toep, offsets))
    o, lse = attention_rpos_reference(q, k, v, toep, W, offsets, return_lse=True)
    bias = materialize_rpos_bias(toep, W, offsets)
    ds = flash_backward_terms(q, k, v, bias, o, lse, g)[3]
    scratch = window_ds(ds, offsets, W)
    got = dtoep_from_window_ds(scratch, offsets, W, q.shape[2])
    ref = attention_rpos_backward_reference(q, k, v, toep, W, offsets, o, lse, g)[3]
    return scratch, got, ref


@pytest.mark.parametrize("L,W,H,D,offsets", CASES)
def test_dtoep_from_window_ds_matches_jax_and_the_reference(L, W, H, D, offsets):
    q, k, v, g, toep, off = _operands(L, W, H, D, offsets, seed=L + W + len(offsets))
    scratch, got, ref = _plain_dtoep(q, k, v, g, toep, W, off)
    assert scratch.shape == (len(offsets), H, min(W, L), min(W, L))
    assert scratch.dtype == got.dtype == torch.float32 and got.shape == (1, H, L, L)
    _, vjp = jax.vjp(lambda q, k, v, t: ap.fused_attention_rpos(q, k, v, t, W, jnp.asarray(off)),
                     *map(jnp.asarray, (q, k, v, toep)))
    want = np.asarray(vjp(jnp.asarray(g))[3])
    bar = DTOEP_TOL_OF_MAX * np.abs(want).max()
    assert np.abs(got.numpy() - want).max() <= bar
    bar = DTOEP_TOL_OF_MAX * ref.abs().max().item()
    assert (got - ref).abs().max().item() <= bar


def test_window_bounds_and_layout():
    """The windows' first positions and lengths, cut to [0, L), and the
    scratch holding ds[b, h, s_b + i, s_b + j] for i, j below the length,
    0 past it."""
    L, W = 10, 4
    offsets = torch.tensor([-2.0, 3.0, 8.0, 12.0, float("nan")])
    lo, n = window_bounds(offsets, W, L)
    assert lo.tolist()[:4] == [0, 3, 8, 0] and n.tolist() == [2, 4, 2, 0, 0]
    ds = torch.randn(5, 2, L, L, generator=torch.Generator().manual_seed(0))
    got = window_ds(ds, offsets, W)
    assert got.shape == (5, 2, W, W)
    for b, (s, w) in enumerate(zip(lo.tolist(), n.tolist())):
        assert torch.equal(got[b, :, :w, :w], ds[b, :, s:s + w, s:s + w])
        assert not got[b, :, w:].any() and not got[b, :, :, w:].any()


@pytest.mark.parametrize("L,d,W,scratch", [(40, 12, 5, True), (300, 4, 37, True),
                                           (256, 4, 32, False), (24, 72, 32, True)])
def test_card_wrapper_fills_the_scratch_and_reaches_the_sum(monkeypatch, L, d, W, scratch):
    """`_launch_bwd` on the card's path with the kernels' launches replaced
    by the plain versions: past the D = 4 kernels the wrapper allocates a
    float32 (B, H, W', W') scratch, the passes fill it and the second pass
    sums it into dtoep; at D = 4 (L <= 256) there is no scratch and no
    second pass. The gradients equal the plain backward's."""
    calls = []

    def plain_passes(q, k, v, toep, o, lse, g, W, offsets, ds):
        calls.append(("passes", q.shape[-1], None if ds is None else (tuple(ds.shape), ds.dtype)))
        dq, dk, dv, dtoep = attention_rpos_backward_reference(q, k, v, toep, W, offsets, o, lse,
                                                              g)
        if ds is not None:
            bias = materialize_rpos_bias(toep, W, offsets)
            ds.copy_(window_ds(flash_backward_terms(q, k, v, bias, o, lse, g)[3], offsets, W))
            dtoep = torch.full_like(dtoep, float("nan"), dtype=torch.float32)  # not written
        return dq, dk, dv, dtoep.float()

    def plain_sum(ds, offsets, W, dtoep):
        calls.append(("sum", tuple(ds.shape)))
        dtoep.copy_(dtoep_from_window_ds(ds, offsets, W, dtoep.shape[-1]))

    monkeypatch.setattr(attention_rpos, "_bwd_passes", plain_passes)
    monkeypatch.setattr(attention_rpos, "_dtoep_sum", plain_sum)
    B, H = 3, 2
    offsets = (-W // 2, L // 2 - W // 2, L - 1 - W // 2)
    q, k, v, g, toep, off = map(torch.from_numpy, _operands(L, W, H, d, offsets, seed=L + d))
    o, lse = attention_rpos_reference(q, k, v, toep, W, off, return_lse=True)
    before = attention_rpos.fused_attention_rpos.bwd_launches
    got = attention_rpos._launch_bwd(q, k, v, toep, W, off, o, lse, g)
    assert attention_rpos.fused_attention_rpos.bwd_launches == before + 1
    Wp = min(W, L)
    Dk = attention_rpos.rpos_head_dim(d, L, q.dtype)
    if scratch:
        assert calls == [("passes", Dk, ((B, H, Wp, Wp), torch.float32)), ("sum", (B, H, Wp, Wp))]
    else:
        assert calls == [("passes", Dk, None)]
    want = attention_rpos_backward_reference(q, k, v, toep, W, off, o, lse, g)
    for name, a, b in zip(("dq", "dk", "dv", "dtoep"), got, want):
        assert a.shape == b.shape and a.dtype == b.dtype, name
        bar = 1e-6 * b.abs().max().item()
        assert (a - b).abs().max().item() <= bar, name
