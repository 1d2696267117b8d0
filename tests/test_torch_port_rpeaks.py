"""The port's R-peak detector against the JAX package's, on the CPU.

`detect_r_peaks` must return exactly JAX's positions (the argmax of the
same matched-filter energy; a position is an index, so there is no
tolerance) on seeded synthetic beats — centred, off-centre, inside the
edge guard, under noise and baseline wander — and on pure-noise windows.
Windows are made from a seed with numpy and handed to both.
"""

import numpy as np
import pytest
import torch
torch.set_num_threads(1)  # six test workers share the host's cores: one intra-op thread each
import jax.numpy as jnp

from ecg_denoise_tpu.data.rpeaks import detect_r_peaks as jax_detect
from ecg_denoise_tpu_torch.data.rpeaks import detect_r_peaks

L = 256
T = np.arange(L)


def _beat(centre, width=4.0):
    """A QRS-like spike: a tall Gaussian R wave and a shallow S dip."""
    return (1.5 * np.exp(-0.5 * ((T - centre) / width) ** 2)
            - 0.3 * np.exp(-0.5 * ((T - centre - 8) / 6.0) ** 2))


def _windows(centres, noise, wander, seed, leads=2):
    rng = np.random.default_rng(seed)
    x = np.stack([np.broadcast_to(_beat(c), (leads, L)) for c in centres])
    x = x + noise * rng.standard_normal(x.shape)
    x = x + wander * np.linspace(-1, 1, L) * rng.standard_normal((len(centres), leads, 1))
    return x.astype(np.float32)


CASES = {
    "centred": dict(centres=[128] * 4, noise=0.0, wander=0.0),
    "off_centre": dict(centres=[40, 90, 170, 215], noise=0.05, wander=0.0),
    # Beats inside the guard of min(16, L//8) samples, or at its edge.
    "edge_guard": dict(centres=[3, 10, 16, 239, 245, 252], noise=0.05, wander=0.0),
    "noise_and_wander": dict(centres=[30, 77, 128, 181, 226], noise=0.3, wander=1.0),
}


def _assert_same(x):
    got = detect_r_peaks(torch.from_numpy(x))
    want = np.asarray(jax_detect(jnp.asarray(x)))
    assert got.shape == (x.shape[0],)
    np.testing.assert_array_equal(got.numpy(), want)
    return got


@pytest.mark.parametrize("case", sorted(CASES))
def test_beats_match_jax(case):
    _assert_same(_windows(seed=len(case), **CASES[case]))


def test_clean_beats_are_found_where_they_are():
    x = _windows([40, 128, 200], noise=0.0, wander=0.0, seed=0)
    assert torch.all((_assert_same(x) - torch.tensor([40, 128, 200])).abs() <= 2)


@pytest.mark.parametrize("leads", [1, 2, 12])
def test_pure_noise_matches_jax(leads):
    x = np.random.default_rng(leads).standard_normal((16, leads, L)).astype(np.float32)
    got = _assert_same(x)
    guard = min(16, L // 8)
    assert torch.all((got >= guard) & (got < L - guard))


def test_zero_windows_give_position_zero():
    """The zero-padded rows of a serving bucket: all energy is 0, and the
    first maximum is position 0, on both sides."""
    got = _assert_same(np.zeros((3, 2, L), np.float32))
    assert got.tolist() == [0, 0, 0]
