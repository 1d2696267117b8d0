"""The port's DWT and FFT baselines against the JAX package's, on the CPU.

`baselines/dwt.py` and `baselines/fft.py` are numpy copies: equal to the
JAX package's outputs. `kernels/dwt.py::wavelet_denoise_device`, the
batched conv1d pyramid, is held within 1e-5 of JAX's
`wavelet_denoise_tpu` (both float32 correlations of the same filters) and
within 1e-4 of the numpy path (the JAX package's bar,
tests/test_dwt.py:101-110), at (6, 2, 256), at a ragged L = 203 and at a
length too short for one level. `cli.dwt_dn` is rehearsed on the CPU, with
`default_device` patched to return it, against the JAX CLI's result line
on the same cache (1e-4).
"""

import os
import re
import runpy
import sys

import numpy as np
import pytest
import torch
torch.set_num_threads(1)  # six test workers share the host's cores: one intra-op thread each
import jax.numpy as jnp

from ecg_denoise_tpu.baselines import dwt as jdwt
from ecg_denoise_tpu.baselines import fft as jfft
from ecg_denoise_tpu.kernels.dwt_tpu import wavelet_denoise_tpu
from ecg_denoise_tpu_torch.baselines import dwt as pdwt
from ecg_denoise_tpu_torch.baselines import fft as pfft
from ecg_denoise_tpu_torch.kernels.dwt import wavelet_denoise_device

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
MINI = os.path.join(REPO, "tests", "data", "mini_physionet")
JAX_TOL = 1e-5
HOST_TOL = 1e-4


def _x(*shape, seed=0):
    return np.random.default_rng(seed).standard_normal(shape).astype(np.float32)


@pytest.mark.parametrize("n_moments", [2, 8])
def test_numpy_dwt_matches_jax(n_moments):
    for got, ref in zip(pdwt.daubechies_filters(n_moments), jdwt.daubechies_filters(n_moments)):
        np.testing.assert_array_equal(got, ref)
    assert [pdwt.dwt_max_level(n, 16) for n in (10, 15, 30, 203, 256)] == \
           [jdwt.dwt_max_level(n, 16) for n in (10, 15, 30, 203, 256)]
    row = _x(203, seed=1).astype(np.float64)
    coeffs, ref = pdwt.wavedec(row, n_moments), jdwt.wavedec(row, n_moments)
    assert len(coeffs) == len(ref)
    for got, want in zip(coeffs, ref):
        np.testing.assert_array_equal(got, want)
    np.testing.assert_array_equal(pdwt.waverec(coeffs, n_moments),
                                  jdwt.waverec(ref, n_moments))
    x = _x(3, 2, 256, seed=2)
    np.testing.assert_array_equal(pdwt.wavelet_denoise(x, n_moments=n_moments),
                                  jdwt.wavelet_denoise(x, n_moments=n_moments))


def test_fft_denoise_matches_jax():
    x = _x(4, 2, 256, seed=3)
    np.testing.assert_array_equal(pfft.fft_denoise(x), jfft.fft_denoise(x))
    rows = [r for r in _x(3, 100, seed=4)]
    np.testing.assert_array_equal(pfft.fft_denoise(rows, 0.1), jfft.fft_denoise(rows, 0.1))


@pytest.mark.parametrize("shape", [(6, 2, 256), (6, 2, 203), (5, 1, 40), (3, 2, 12)],
                         ids=["256", "ragged-203", "40", "no-level"])
def test_wavelet_denoise_device_matches_jax_and_host(shape):
    """Within 1e-5 of JAX's conv pyramid and 1e-4 of the numpy path (at
    odd L the host path returns L + 1 samples, pywt's waverec length; the
    device paths keep the first L); a second call bit-identical."""
    x = _x(*shape, seed=5)
    got = wavelet_denoise_device(torch.from_numpy(x))
    assert got.dtype == torch.float32 and got.shape == shape
    np.testing.assert_allclose(got.numpy(), np.asarray(wavelet_denoise_tpu(jnp.asarray(x))),
                               atol=JAX_TOL, rtol=0)
    host = pdwt.wavelet_denoise(x.astype(np.float64).reshape(-1, shape[-1]))
    np.testing.assert_allclose(got.numpy(), host[:, :shape[-1]].reshape(shape),
                               atol=HOST_TOL, rtol=0)
    torch.testing.assert_close(wavelet_denoise_device(torch.from_numpy(x)), got,
                               rtol=0, atol=0)


def test_symmetric_pad_is_numpys():
    from ecg_denoise_tpu_torch.kernels.dwt import _symmetric_pad

    x = _x(2, 15, seed=6)
    np.testing.assert_array_equal(_symmetric_pad(torch.from_numpy(x), 15).numpy(),
                                  np.pad(x, ((0, 0), (15, 15)), mode="symmetric"))


@pytest.fixture(scope="module")
def cache(tmp_path_factory):
    """A dict_data cache built by the port from the WFDB fixture (128
    windows; the test split is 26)."""
    from ecg_denoise_tpu_torch.data.cache import build_dict_data

    path = str(tmp_path_factory.mktemp("baselines") / "dict_data")
    build_dict_data(path, MINI)
    return path


def _line(path):
    with open(path) as f:
        lines = f.read().splitlines()
    assert len(lines) == 1
    m = re.fullmatch(r"dwt_(\w+)_intensity(-?\d): snr:(\S+), rmse:(\S+)", lines[0])
    assert m is not None, lines[0]
    return m.group(1), int(m.group(2)), float(m.group(3)), float(m.group(4))


def test_dwt_dn_cli_writes_the_jax_line(monkeypatch, tmp_path, cache):
    """`python -m ecg_denoise_tpu_torch.cli.dwt_dn`, on the (patched) card
    and with --host, against the JAX package's `python cli/dwt_dn.py` on
    the same cache and flags: the same result line, SNR and RMSE within
    1e-4."""
    import ecg_denoise_tpu_torch
    import ecg_denoise_tpu.utils.compile_cache as jcache_mod

    monkeypatch.setattr(jcache_mod, "enable_compilation_cache", lambda *a, **k: None)
    monkeypatch.setattr(ecg_denoise_tpu_torch, "default_device", lambda: torch.device("cpu"))
    flags = ["--noise_type_index", "3", "--intensity_index", "1", "--data_path", cache]
    monkeypatch.setattr(sys, "argv", ["dwt_dn.py", *flags, "--result_file",
                                      str(tmp_path / "jax.txt")])
    runpy.run_path(os.path.join(REPO, "cli", "dwt_dn.py"), run_name="__main__")
    ref = _line(tmp_path / "jax.txt")
    assert ref[:2] == ("emb", -2)
    from ecg_denoise_tpu_torch.cli.dwt_dn import main

    for extra, name in (([], "card"), (["--host"], "host")):
        main(flags + extra + ["--result_file", str(tmp_path / f"{name}.txt")])
        got = _line(tmp_path / f"{name}.txt")
        assert got[:2] == ref[:2]
        np.testing.assert_allclose(got[2:], ref[2:], rtol=0, atol=HOST_TOL, err_msg=name)


def test_dwt_dn_cli_raises_without_a_card(monkeypatch, tmp_path):
    """No card and no --host: the CLI raises before it reads anything, as
    cli.main does; it never falls back to the CPU."""
    from ecg_denoise_tpu_torch.cli.dwt_dn import main

    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        main(["--data_path", str(tmp_path / "absent"),
              "--result_file", str(tmp_path / "out.txt")])
    assert not (tmp_path / "out.txt").exists()
