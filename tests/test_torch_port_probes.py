"""The null launch and the launch-floor probes, on the CPU.

`null_copy` on a CPU tensor is its plain version, `clone()`, and launches
nothing. `chain_fit` is the JAX probe's two-point fit
(scripts/probe_chain.py:138-142). The probes measure the card only: without
one their `main()` raises and prints no table. chip_smoke.py's `settle`,
which times two kernels in turns and gives the verdict its phases 17 and 18
report, reads in turns and is two-sided. On views off a 16-byte boundary
`null_copy` and `probe_div` take their plain versions too. The B5 probe's
variants are its committed source with one edit each, found exactly once.
The SASS probe's reading of B3's tile loop is held on a listing made by
hand: the body from the first HMMA to the back edge, less a forward branch
that skips a global load.
"""

import numpy as np
import pytest
import torch
torch.set_num_threads(1)  # six test workers share the host's cores: one intra-op thread each

from ecg_denoise_tpu_torch.kernels.null_copy import null_copy
from ecg_denoise_tpu_torch.probes import chain, dense_bound, floor, sass_mix


def _jax_probe_fit(chains, vals):
    """scripts/probe_chain.py:138-142, verbatim but for the names."""
    k0, k1 = chains[0], chains[-1]
    v0, v1 = vals[0], vals[-1]
    E = (v0 - v1) / (1.0 / k0 - 1.0 / k1)
    c = v1 - E / k1
    return E, c


def test_null_copy_on_the_cpu_is_clone():
    x = torch.randn(8, 128, generator=torch.Generator().manual_seed(0))
    before = null_copy.launches
    y = null_copy(x)
    assert torch.equal(y, x) and y.data_ptr() != x.data_ptr()
    assert null_copy.launches == before
    with pytest.raises(TypeError):
        null_copy(x.to(torch.bfloat16))


@pytest.mark.parametrize("E,c", [(5000.0, 12.5), (40.0, 3.0), (0.0, 7.0)])
def test_chain_fit_recovers_intercept_and_slope(E, c):
    chains = [8, 64, 256]
    us = [E / k + c for k in chains]
    got_E, got_c = chain.chain_fit(chains, us)
    assert got_E == pytest.approx(E, rel=1e-12, abs=1e-9)
    assert got_c == pytest.approx(c, rel=1e-12, abs=1e-9)
    assert (got_E, got_c) == pytest.approx(_jax_probe_fit(chains, us), rel=1e-12, abs=1e-12)


def test_chain_fit_uses_the_extremes_only():
    """A middle point off the line changes nothing, as in the JAX probe."""
    assert chain.chain_fit([2, 8, 32], [60.0, 1e9, 15.0]) == _jax_probe_fit(
        [2, 8, 32], [60.0, 1e9, 15.0])


@pytest.mark.parametrize("run", [floor.main, chain.main, dense_bound.main],
                         ids=["floor", "chain", "dense_bound"])
def test_probes_raise_without_a_card(monkeypatch, capsys, run):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        run()
    assert capsys.readouterr().out == ""


@pytest.mark.parametrize("gap,verdict", [(0.125, "level"), (-0.125, "level"),
                                         (0.375, "unsettled"), (-0.375, "unsettled"),
                                         (0.75, "slower"), (-0.75, "faster")])
def test_settle_verdict_is_two_sided(gap, verdict):
    """Level where the medians' gap is inside both spreads (0.25 and 0.5
    here), slower or faster beyond both, unsettled between."""
    import chip_smoke

    first = [10.0 + gap + d for d in (-0.125, 0.0, 0.125)]
    second = [10.0 + d for d in (-0.25, 0.0, 0.25)]
    got = chip_smoke.settle_verdict(first, second)
    assert got["verdict"] == verdict
    assert got["median_us"] == [10.0 + gap, 10.0] and got["spread_us"] == [0.25, 0.5]
    assert got["gap_us"] == gap


def test_settle_reads_in_turns():
    """Each round reads first, second, second, first."""
    import chip_smoke

    order = []
    readings = iter([3.0, 1.0, 1.5, 4.0, 3.5, 2.0, 1.0, 3.0])

    def reading(fn):
        order.append(fn())
        return next(readings)

    got = chip_smoke.settle(("a", lambda: "a"), ("b", lambda: "b"), reading, rounds=2)
    assert order == list("abbaabba")
    assert got["names"] == ["a", "b"] and got["rounds"] == 2
    assert got["median_us"] == [3.25, 1.25] and got["spread_us"] == [1.0, 1.0]
    assert got["verdict"] == "slower"


@pytest.mark.parametrize("kernel", ["null_copy", "probe_div"])
def test_cpu_views_off_a_16_byte_boundary_take_the_plain_version(kernel):
    """On CPU views 4 bytes past a 16-byte boundary (the card's scalar
    path) the wrappers return a copy and IEEE division, bit for bit numpy,
    and launch nothing."""
    from ecg_denoise_tpu_torch.kernels.precision import probe_div

    base = torch.randn(2049, generator=torch.Generator().manual_seed(5)) + 2.0
    n, d = base[1:1025].view(4, 256), base[1025:].view(4, 256)
    assert n.data_ptr() % 16 == 4
    fn, args, want = ((null_copy, (n,), n.numpy()) if kernel == "null_copy" else
                      (probe_div, (n, d), n.numpy() / d.numpy()))
    before = fn.launches
    got = fn(*args)
    assert np.array_equal(got.numpy().view(np.uint32), want.view(np.uint32))
    assert got.data_ptr() not in (n.data_ptr(), d.data_ptr()) and fn.launches == before


@pytest.mark.parametrize("name", sorted(dense_bound.VARIANTS))
def test_dense_bound_variants_edit_the_source_once(name):
    from ecg_denoise_tpu_torch.kernels.build import CSRC

    src = (CSRC / "attention_dense_fwd.cu").read_text()
    old, new = dense_bound.VARIANTS[name]
    got = dense_bound.variant_source(name)
    assert src.count(old) == 1 and got != src
    assert got == src.replace(old, new)


SASS = """
        Function : _ZN4mma_fwd28attention_rpos_fwd_mma_kernelIfLi4EEEvPKT_
        /*0000*/                   MOV R1, c[0x0][0x28] ;
        /*0010*/                   LDS R2, [R3] ;
        /*0020*/                   HMMA.1684.F32.TF32 R4, R8, R12, R4 ;
        /*0030*/                   HMMA.1684.F32.TF32 R4, R8, R12, R4 ;
        /*0040*/                   HMMA.1684.F32.TF32 R4, R8, R12, R4 ;
        /*0050*/              @P0 BRA 0x80 ;
        /*0060*/                   LDG.E R5, desc[UR4][R6.64] ;
        /*0070*/                   FADD R5, R5, R5 ;
        /*0080*/                   MUFU.EX2 R7, R7 ;
        /*0090*/              @P1 BRA 0x10 ;
        /*00a0*/                   EXIT ;
"""


def test_sass_mix_reads_the_loop_body_and_refuses_an_unknown_shape():
    mix = sass_mix.loop_mix(SASS)
    assert mix["pairs_a_tile"] == 2  # 3 HMMA, 2/3 of a pair each
    assert mix["per_pair"] == {"HMMA": 1.5, "BRA": 1.0, "MUFU": 0.5}
    assert mix["total_per_pair"] == 3.0
    assert mix["tile_staging"] == 1
    with pytest.raises(RuntimeError, match="no backward branch"):
        sass_mix.loop_mix(SASS.replace("@P1 BRA 0x10", "@P1 BRA 0xa0"))
    with pytest.raises(RuntimeError, match="0 functions"):
        sass_mix.loop_mix(SASS.replace("IfLi4E", "IfLi8E"))
