"""The port's data path against the JAX package's, on the CPU.

The numpy modules (`wfdb_io`, `synth`, the numpy mixers, the iterators,
the normalisers and the three cache builders) are copies, so they are held
to JAX's outputs exactly: equal arrays, and cache files equal byte for
byte, from the library and from each package's `build_data` CLI. The cache
cases are small (the WFDB fixture `tests/data/mini_physionet`, 1 synthetic
record, never the builder's default 8; the 12-lead cache at 1 record and
one intensity; 64 + 16 beats a class).

The torch mixer `snr_noise_add_at` is held to `jax_snr_noise_add` within
1e-6 at float32, on the offsets JAX draws. The augmented epoch runs UNet
at its own widths (10,374 parameters) on 64 windows at batch 16 for two
epochs, on JAX's permutation and offsets, against JAX's
`make_augmented_epoch_fn` at the bars of a training step
(`__graft_entry__.py:120-129`): loss 1e-5 relative, parameters 1e-4, BN
running stats 1e-5. UNet's eight block convs feed a training-mode
BatchNorm, so their biases' exact gradient is 0 at every step and exact
Adam leaves them where they are; float32 Adam moves each by about lr
times the sign of a rounding of that 0 (`chip_smoke.step_bars`), which
differs between the two frameworks and, through the BatchNorms' running
means, would decide the comparison. Both sides freeze those eight biases
(JAX by its own `frozen_mask`, the port by `frozen`), as exact arithmetic
would, and every tensor is held at the bars.
"""

import filecmp
import os
import runpy
import sys

import numpy as np
import pytest
import torch
torch.set_num_threads(1)  # six test workers share the host's cores: one intra-op thread each
import jax
import jax.numpy as jnp

from ecg_denoise_tpu.data import cache as jcache
from ecg_denoise_tpu.data import cls_cache as jcls
from ecg_denoise_tpu.data import iterators as jiter
from ecg_denoise_tpu.data import noise as jnoise
from ecg_denoise_tpu.data import normalize as jnorm
from ecg_denoise_tpu.data import synth as jsynth
from ecg_denoise_tpu.data import wfdb_io as jwfdb
from ecg_denoise_tpu.models import UNet as JaxUNet
from ecg_denoise_tpu.train import create_train_state as jax_train_state
from ecg_denoise_tpu.train.steps import make_augmented_epoch_fn as jax_augmented_epoch_fn
from ecg_denoise_tpu_torch import data as pdata_pkg
from ecg_denoise_tpu_torch.data import cache as pcache
from ecg_denoise_tpu_torch.data import cls_cache as pcls
from ecg_denoise_tpu_torch.data import iterators as piter
from ecg_denoise_tpu_torch.data import noise as pnoise
from ecg_denoise_tpu_torch.data import normalize as pnorm
from ecg_denoise_tpu_torch.data import synth as psynth
from ecg_denoise_tpu_torch.data import wfdb_io as pwfdb
from ecg_denoise_tpu_torch.data.dataset import EcgDataset
from ecg_denoise_tpu_torch.interop.jax_weights import unet_state_dict
from ecg_denoise_tpu_torch.models import build_model
from ecg_denoise_tpu_torch.train import (
    augmented_epoch,
    create_train_state,
    make_augmented_epoch_fn,
)
from test_torch_port_layers import random_variables

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
MINI = os.path.join(REPO, "tests", "data", "mini_physionet")
ARR = os.path.join(MINI, "mit-bih-arrhythmia-database-1.0.0")
NST = os.path.join(MINI, "mit-bih-noise-stress-test-database-1.0.0")
MIX_TOL = 1e-6
LOSS_TOL = 1e-5
PARAM_TOL = 1e-4
STATS_TOL = 1e-5
STATS = ("running_mean", "running_var")


def _tree_files(root):
    return sorted(os.path.relpath(os.path.join(d, f), root)
                  for d, _, files in os.walk(root) for f in files)


def assert_same_files(got, ref):
    """Both trees hold the same files, each equal byte for byte."""
    names = _tree_files(ref)
    assert names and _tree_files(got) == names
    for name in names:
        assert filecmp.cmp(os.path.join(got, name), os.path.join(ref, name),
                           shallow=False), name


# --- the cache builders -----------------------------------------------------


@pytest.mark.parametrize("kw", [
    dict(data_root=MINI),  # WFDB: 2 records, 128 windows
    dict(data_root=None, n_synth_records=1),  # 2,528 windows
    dict(data_root=None, n_synth_records=1, n_channels=12, intensities=(-4,)),
], ids=["wfdb", "synthetic", "12-lead"])
def test_build_dict_data_is_byte_identical(tmp_path, kw):
    ref = jcache.build_dict_data(str(tmp_path / "jax"), **kw)
    got = pcache.build_dict_data(str(tmp_path / "port"), **kw)
    assert got["n_windows"] == ref["n_windows"]
    assert_same_files(tmp_path / "port", tmp_path / "jax")


def test_build_dict_data_reads_the_wfdb_records():
    """The fixture's records, not the synthetic fallback, feed the cache."""
    ecgs, noises = pcache.load_source_records(MINI, 8, 2023)
    assert len(ecgs) == 2 and sorted(noises) == ["bw", "em", "ma"]
    np.testing.assert_array_equal(ecgs[0], pwfdb.rdrecord_digital(os.path.join(ARR, "100")))


def test_build_cls_data_is_byte_identical_and_loads(tmp_path):
    ref = jcls.build_cls_data(str(tmp_path / "jax"), n_train=64, n_test=16)
    got = pcls.build_cls_data(str(tmp_path / "port"), n_train=64, n_test=16)
    assert got == {**ref, "out_dir": str(tmp_path / "port")}
    assert_same_files(tmp_path / "port", tmp_path / "jax")
    for train in (True, False):
        for noised in (True, False):
            data, label = pcls.load_cls_arrays(train, noised, path=str(tmp_path / "port"))
            ref_data, ref_label = jcls.load_cls_arrays(train, noised,
                                                       path=str(tmp_path / "jax"))
            n = 64 if train else 16
            assert data.shape == (2 * n, 2, 256) and data.dtype == np.float32
            np.testing.assert_array_equal(data, ref_data)
            np.testing.assert_array_equal(label, ref_label)


def test_load_cls_arrays_raises_without_a_cache(tmp_path, monkeypatch):
    monkeypatch.chdir(tmp_path)
    with pytest.raises(FileNotFoundError, match="cli.build_data --cls"):
        pcls.load_cls_arrays()


def _run_cli(run, argv):
    saved = sys.argv
    sys.argv = argv
    try:
        run()
    finally:
        sys.argv = saved


def test_build_data_cli_is_byte_identical(tmp_path, capsys):
    """The port's `python -m ecg_denoise_tpu_torch.cli.build_data` against
    the JAX package's `python cli/build_data.py`, the same flags; the cache
    loads through the port's EcgDataset."""
    flags = ["--data_root", MINI, "--seed", "7"]
    _run_cli(lambda: runpy.run_path(os.path.join(REPO, "cli", "build_data.py"),
                                    run_name="__main__"),
             ["build_data.py", "--out", str(tmp_path / "jax"), *flags])
    _run_cli(lambda: runpy.run_module("ecg_denoise_tpu_torch.cli.build_data",
                                      run_name="__main__", alter_sys=True),
             ["build_data", "--out", str(tmp_path / "port"), *flags])
    out = capsys.readouterr().out.splitlines()
    assert out == [f"built 128 windows in {tmp_path / 'jax'}",
                   f"built 128 windows in {tmp_path / 'port'}"]
    assert_same_files(tmp_path / "port", tmp_path / "jax")
    ds = EcgDataset("emb", 4, path=str(tmp_path / "port"))
    assert len(ds) == 128 and ds[0][0].shape == ds[0][1].shape == (2, 256)


# --- WFDB and the synthetic records -----------------------------------------


@pytest.mark.parametrize("record", [os.path.join(ARR, "100"), os.path.join(ARR, "101"),
                                    *(os.path.join(NST, k) for k in ("bw", "ma", "em"))])
def test_wfdb_reads_as_jax_does(record):
    assert vars(pwfdb.read_header(record + ".hea")) == vars(jwfdb.read_header(record + ".hea"))
    got = pwfdb.rdrecord_digital(record)
    assert got.shape == (16384, 2)
    np.testing.assert_array_equal(got, jwfdb.rdrecord_digital(record))
    if os.path.exists(record + ".atr"):
        samples, symbols = pwfdb.rdann(record)
        ref_samples, ref_symbols = jwfdb.rdann(record)
        np.testing.assert_array_equal(samples, ref_samples)
        assert symbols == ref_symbols and len(symbols) > 0


def test_wfdb_writes_round_trip(tmp_path):
    """wrsamp_212 and wrann write what rdrecord_digital and rdann read
    back, as the JAX package's writers write them, byte for byte; the
    record lists are the same."""
    rng = np.random.default_rng(3)
    sig = rng.integers(-2048, 2048, (1001, 3))  # an odd sample count
    samples = np.sort(rng.choice(5000, 40, replace=False)) + np.arange(40) * 1000
    symbols = list(rng.choice(["N", "V", "A", "~"], 40))
    for mod, d in ((pwfdb, "port"), (jwfdb, "jax")):
        os.makedirs(tmp_path / d)
        mod.wrsamp_212(str(tmp_path / d / "rec"), sig)
        mod.wrann(str(tmp_path / d / "rec"), samples, symbols)
    assert_same_files(tmp_path / "port", tmp_path / "jax")
    np.testing.assert_array_equal(pwfdb.rdrecord_digital(str(tmp_path / "port" / "rec")), sig)
    got_samples, got_symbols = pwfdb.rdann(str(tmp_path / "port" / "rec"))
    np.testing.assert_array_equal(got_samples, samples)
    assert got_symbols == symbols
    assert pwfdb.MITBIH_RECORDS == jwfdb.MITBIH_RECORDS
    assert pwfdb.NSTDB_NOISE_RECORDS == jwfdb.NSTDB_NOISE_RECORDS


@pytest.mark.parametrize("fn,args,kw", [
    ("synth_ecg_record", (5,), dict(length=20_000)),
    ("synth_ecg_record", (6,), dict(length=20_000, n_channels=12, pvc_prob=0.2,
                                    fixed_leads=True)),
    ("synth_ecg_record_annotated", (7,), dict(length=20_000)),
    ("synth_beat_windows", ("N", 5, 8), {}),
    ("synth_beat_windows", ("V", 5, 9), dict(n_channels=3, window=200)),
    ("synth_noise_record", ("bw", 10), dict(length=20_000)),
    ("synth_noise_record", ("ma", 11), dict(length=20_000)),
    ("synth_noise_record", ("em", 12), dict(length=20_000, n_channels=12)),
])
def test_synth_matches_jax(fn, args, kw):
    got, ref = getattr(psynth, fn)(*args, **kw), getattr(jsynth, fn)(*args, **kw)
    for g, r in zip(got if isinstance(got, tuple) else (got,),
                    ref if isinstance(ref, tuple) else (ref,)):
        assert g.dtype == r.dtype
        np.testing.assert_array_equal(g, r)


# --- the numpy mixers, the iterators and the normalisers ---------------------


def _x(*shape, seed=1):
    return np.random.default_rng(seed).standard_normal(shape).astype(np.float32)


def test_numpy_mixers_match_jax():
    x, y = _x(300, 2), _x(300, 2, seed=2)
    for got, ref in zip(pnoise.gnoisegen(x, y, -2.0), jnoise.gnoisegen(x, y, -2.0)):
        np.testing.assert_array_equal(got, ref)
    np.testing.assert_array_equal(pnoise.single_snr_noise_add(x, y, 3.0),
                                  jnoise.single_snr_noise_add(x, y, 3.0))
    data, record = _x(6, 256, 2, seed=3), _x(5000, 2, seed=4)
    got = pnoise.batch_snr_noise_add(data, record, 0.0, np.random.default_rng(5))
    ref = jnoise.batch_snr_noise_add(data, record, 0.0, np.random.default_rng(5))
    assert got.dtype == np.float32
    np.testing.assert_array_equal(got, ref)


def test_iterators_match_jax():
    clean, noisy = _x(4 * 64 * 3 + 17, 2, seed=5), _x(4 * 64 * 3 + 17, 2, seed=6)
    noises = {k: _x(2000, 2, seed=7 + i) for i, k in enumerate(("bw", "ma", "em"))}

    def same(got, ref):
        got, ref = list(got), list(ref)
        assert len(got) == len(ref) == 3
        for g, r in zip(got, ref):
            for a, b in zip(g, r):
                assert a.dtype == b.dtype
                np.testing.assert_array_equal(a, b)

    same(piter.window_batches(noisy, clean, 4, 64), jiter.window_batches(noisy, clean, 4, 64))
    for normalize in (False, True):
        same(piter.arrhythmia_window_batches(clean, noises, 4, 64, seed=3,
                                             normalize=normalize),
             jiter.arrhythmia_window_batches(clean, noises, 4, 64, seed=3,
                                             normalize=normalize))
    same(piter.norm_snr_window_batches(clean, noises["ma"], 2.0, 4, 64, seed=4),
         jiter.norm_snr_window_batches(clean, noises["ma"], 2.0, 4, 64, seed=4))
    windows = _x(3, 2, 64, seed=9)
    np.testing.assert_array_equal(
        piter.random_alpha_noise_add(windows, noises, 0.7, np.random.default_rng(8)),
        jiter.random_alpha_noise_add(windows, noises, 0.7, np.random.default_rng(8)))
    with pytest.raises(ValueError, match="noise record too short"):
        next(piter.norm_snr_window_batches(clean, noises["ma"][:100], 0.0, 4, 64))


@pytest.mark.parametrize("axis", [-1, 0])
def test_normalizers_match_jax(axis):
    """numpy in, numpy out, equal to JAX's numpy path; a torch tensor in,
    a tensor out, within 1e-6 of max|out| of JAX's jnp path; a constant
    line passes through unscaled (its std is 0)."""
    x = _x(5, 40, seed=10)
    const = (2, slice(None)) if axis == -1 else (slice(None), 7)
    x[const] = 3.0
    for name in ("znorm", "minmax_norm"):
        pfn, jfn = getattr(pnorm, name), getattr(jnorm, name)
        got = pfn(x, axis=axis)
        assert isinstance(got, np.ndarray)
        np.testing.assert_array_equal(got, jfn(x, axis=axis))
        np.testing.assert_array_equal(got[const], 0.0)
        got = pfn(torch.from_numpy(x), axis=axis)
        assert isinstance(got, torch.Tensor) and got.dtype == torch.float32
        ref = np.asarray(jfn(jnp.asarray(x), axis=axis))
        np.testing.assert_allclose(got.numpy(), ref, atol=MIX_TOL * np.abs(ref).max(), rtol=0)
        np.testing.assert_array_equal(got.numpy()[const], 0.0)
    np.testing.assert_array_equal(pnorm.znorm(x, eps=0.1), jnorm.znorm(x, eps=0.1))
    assert pdata_pkg.np_norm is pnorm.znorm and pdata_pkg.Gnoisegen is pnoise.gnoisegen
    assert pdata_pkg.Ecg_Dataset is EcgDataset


# --- the on-device mixer ----------------------------------------------------


@pytest.mark.parametrize("snr", [-4.0, 0.0, 6.0])
def test_snr_noise_add_at_matches_jax_on_its_offsets(snr):
    """`snr_noise_add_at` on the offsets `jax_snr_noise_add` draws from its
    key (randint in [0, N - L - 1)), recomputed here, within 1e-6."""
    B, C, L, N = 9, 2, 256, 3000
    data, record = _x(B, C, L, seed=11), _x(N, C, seed=12)
    key = jax.random.PRNGKey(int(snr) + 10)
    ref = np.asarray(jnoise.jax_snr_noise_add(jnp.asarray(data), jnp.asarray(record),
                                              snr, key))
    starts = np.asarray(jax.random.randint(key, (B,), 0, N - L - 1))
    got = pnoise.snr_noise_add_at(torch.from_numpy(data), torch.from_numpy(record), snr,
                                  torch.from_numpy(starts))
    assert got.dtype == torch.float32
    np.testing.assert_allclose(got.numpy(), ref, atol=MIX_TOL * np.abs(ref).max(), rtol=0)


def test_snr_noise_add_draws_from_its_generator():
    """The generator path is `snr_noise_add_at` at offsets drawn in
    [0, N - L - 1), and every window sits at the target SNR."""
    B, C, L, N = 64, 2, 256, 260  # offsets 0, 1 or 2
    data, record = torch.from_numpy(_x(B, C, L, seed=13)), torch.from_numpy(_x(N, C, seed=14))
    got = pnoise.snr_noise_add(data, record, 3.0, torch.Generator().manual_seed(5))
    starts = torch.randint(0, N - L - 1, (B,), generator=torch.Generator().manual_seed(5))
    assert set(starts.tolist()) == {0, 1, 2}
    torch.testing.assert_close(got, pnoise.snr_noise_add_at(data, record, 3.0, starts),
                               rtol=0, atol=0)
    snr = 10 * torch.log10((data ** 2).mean((1, 2)) / ((got - data) ** 2).mean((1, 2)))
    torch.testing.assert_close(snr, torch.full((B,), 3.0), rtol=0, atol=1e-4)


# --- the augmented epoch ----------------------------------------------------


def _clean_windows(n, seed=0):
    rng = np.random.default_rng(seed)
    t = np.linspace(0, 6 * np.pi, 256)
    return np.sin(t + rng.uniform(0, 6, (n, 2, 1))).astype(np.float32)


def _jax_draws(n, batch, n_record, L, epochs):
    """Each epoch's permutation and per-step offsets as JAX's augmented
    epoch draws them from its key (train/steps.py:177-178, 194-195)."""
    out = []
    for e in range(epochs):
        k, perm_key = jax.random.split(jax.random.PRNGKey(e))
        n_batches = n // batch
        perm = np.asarray(jax.random.permutation(perm_key, n))[:n_batches * batch]
        starts = []
        for _ in range(n_batches):
            k, mix_key = jax.random.split(k)
            starts.append(np.asarray(jax.random.randint(mix_key, (batch,), 0,
                                                        n_record - L - 1)))
        out.append((perm, np.stack(starts)))
    return out


# UNet's biases before a training-mode BatchNorm (see the module docstring).
BN_FED_BIASES = [f"{blocks}.{i}.conv.bias" for blocks in ("EncList", "DecList")
                 for i in range(4)]


def _jax_mask(variables, port_keys):
    """A bool tree over `variables["params"]`, True at the leaves that the
    port names `port_keys` (each leaf tagged by its index through the
    port's own map)."""
    leaves, treedef = jax.tree_util.tree_flatten(variables["params"])
    tagged = jax.tree_util.tree_unflatten(
        treedef, [np.full(np.shape(x), i, np.float32) for i, x in enumerate(leaves)])
    sd = unet_state_dict({"params": tagged, "batch_stats": variables["batch_stats"]})
    picked = {int(sd[k].flatten()[0]) for k in port_keys}
    return jax.tree_util.tree_unflatten(treedef, [i in picked for i in range(len(leaves))])


def test_augmented_epoch_matches_jax():
    """UNet, 64 windows, batch 16, two epochs at 0 dB, the port on JAX's
    permutations and offsets: each epoch's loss within 1e-5 relative, then
    every parameter within 1e-4 and every BN running stat within 1e-5; the
    biases before a training-mode BatchNorm frozen on both sides."""
    n, batch, epochs, snr = 64, 16, 2, 0.0
    clean = _clean_windows(n)
    record = psynth.synth_noise_record("ma", 3, length=4000)
    jm = JaxUNet()
    v = random_variables(jm, jnp.zeros((2, 2, 256)), seed=2)
    jstate, tx = jax_train_state(jm, jax.random.PRNGKey(0), jnp.zeros((2, 2, 256)),
                                 variables=v, frozen_mask=_jax_mask(v, BN_FED_BIASES))
    j_epoch = jax_augmented_epoch_fn(jm, tx, record, snr, donate=False)
    pm = build_model("unet", device="cpu")
    pm.load_state_dict(unet_state_dict(v))
    state = create_train_state(pm, device="cpu", frozen=BN_FED_BIASES)
    p_record = torch.as_tensor(record, dtype=torch.float32)
    draws = _jax_draws(n, batch, record.shape[0], 256, epochs)
    for e, (perm, starts) in enumerate(draws):
        jstate, ref = j_epoch(jstate, jnp.asarray(clean), jax.random.PRNGKey(e), batch)
        got = augmented_epoch(state, torch.from_numpy(clean), p_record, snr,
                              torch.from_numpy(perm.copy()), torch.from_numpy(starts))
        np.testing.assert_allclose(got["loss"], float(ref["loss"]), rtol=LOSS_TOL)
        np.testing.assert_allclose([got["snr"], got["rmse"]],
                                   [float(ref["snr"]), float(ref["rmse"])], rtol=1e-4)
    assert state.step == int(jstate.step) == epochs * n // batch
    ref_sd = unet_state_dict({"params": jstate.params, "batch_stats": jstate.batch_stats})
    held = {**{k: (p, PARAM_TOL) for k, p in state.model.named_parameters()},
            **{k: (b, STATS_TOL) for k, b in state.model.named_buffers() if k.endswith(STATS)}}
    assert held.keys() == {k for k in ref_sd if not k.endswith("num_batches_tracked")}
    for key, (val, tol) in held.items():
        np.testing.assert_allclose(val.detach().numpy(), ref_sd[key].numpy(), atol=tol,
                                   rtol=0, err_msg=key)
    for key in BN_FED_BIASES:  # frozen on both sides
        np.testing.assert_array_equal(ref_sd[key].numpy(), unet_state_dict(v)[key].numpy())


def test_make_augmented_epoch_fn_trains():
    """The generator path trains: the loss falls over four epochs (as
    tests/test_train.py's JAX case), and the epoch drops the ragged tail."""
    clean = torch.from_numpy(_clean_windows(70, seed=1))
    record = np.random.default_rng(2).standard_normal((10_000, 2)).astype(np.float32)
    torch.manual_seed(0)
    state = create_train_state(build_model("unet", device="cpu"), learning_rate=3e-3,
                               device="cpu")
    train_epoch = make_augmented_epoch_fn(state.model, state.optimizer, record, 0.0)
    gen = torch.Generator().manual_seed(0)
    losses = [train_epoch(clean, gen, 16)["loss"] for _ in range(4)]
    assert state.step == 4 * 4
    assert np.isfinite(losses).all() and losses[-1] < losses[0]
