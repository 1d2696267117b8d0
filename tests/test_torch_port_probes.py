"""The null launch and the launch-floor probes, on the CPU.

`null_copy` on a CPU tensor is its plain version, `clone()`, and launches
nothing. `chain_fit` is the JAX probe's two-point fit
(scripts/probe_chain.py:138-142). The probes measure the card only: without
one their `main()` raises and prints no table.
"""

import pytest
import torch

from ecg_denoise_tpu_torch.kernels.null_copy import null_copy
from ecg_denoise_tpu_torch.probes import chain, floor


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


@pytest.mark.parametrize("run", [floor.main, chain.main], ids=["floor", "chain"])
def test_probes_raise_without_a_card(monkeypatch, capsys, run):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        run()
    assert capsys.readouterr().out == ""
