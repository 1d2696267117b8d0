"""The port's training slice against the JAX package's, on the CPU.

RA-LENet 'full' at depth 1 (its real widths), batch 4. Weights are random
numpy variables of the JAX model, handed to the port through
`interop.jax_weights.ralenet_state_dict`; inputs are made from a seed with
numpy. JAX runs its plain XLA path (`use_pallas=False`); the port's
attention on CPU tensors is its plain version, with autograd through it.

Tolerances at float32 (the bars of __graft_entry__.py:120-129): loss 1e-5,
BatchNorm running stats 1e-5, parameters after Adam 1e-4. An epoch whose
batch is the whole split makes the two frameworks' permutations only
reorder a mean, so one and two epochs compare step for step.
"""

import os
import re

import numpy as np
import pytest
import torch
torch.set_num_threads(1)  # six test workers share the host's cores: one intra-op thread each
import jax
import jax.numpy as jnp

from ecg_denoise_tpu.data import dataset as jdata
from ecg_denoise_tpu.metrics import denoise as jmetrics
from ecg_denoise_tpu.models.ralenet import RaleNet as JaxRaleNet
from ecg_denoise_tpu.train import create_train_state as jax_train_state
from ecg_denoise_tpu.train import make_epoch_fns as jax_epoch_fns
from ecg_denoise_tpu_torch import metrics as pmetrics
from ecg_denoise_tpu_torch.data import dataset as pdata
from ecg_denoise_tpu_torch.interop.jax_weights import (
    adam_state_from_optax,
    ralenet_state_dict,
)
from ecg_denoise_tpu_torch.models.ralenet import RaleNet
from ecg_denoise_tpu_torch.train import (
    create_train_state,
    find_model,
    fit,
    make_epoch_fns,
    train_step,
)
from test_torch_port_layers import random_variables

DEPTH = 1
BATCH = 4
LOSS_TOL = 1e-5
PARAM_TOL = 1e-4
STATS_TOL = 1e-5
STATS = ("running_mean", "running_var")


def _data(n, seed=0):
    """Noisy and clean (n, 2, 256) float32 windows: sines plus noise."""
    rng = np.random.default_rng(seed)
    t = np.linspace(0, 6 * np.pi, 256)
    clean = np.sin(t + rng.uniform(0, 6, (n, 2, 1)))
    noisy = clean + 0.5 * rng.standard_normal(clean.shape)
    return noisy.astype(np.float32), clean.astype(np.float32)


def _jax_model(dtype=torch.float32):
    jdtype = jnp.bfloat16 if dtype == torch.bfloat16 else jnp.float32
    return JaxRaleNet(variant="full", depth=DEPTH, dtype=jdtype)


@pytest.fixture(scope="module")
def jax_epochs():
    """JAX's float32 (train_epoch, eval_epoch), compiled once for the file."""
    jm = _jax_model()
    _, tx = jax_train_state(jm, jax.random.PRNGKey(0), jnp.zeros((2, 2, 256)))
    return jax_epoch_fns(jm, tx, donate=False)


@pytest.fixture(scope="module")
def jax_rpos_epochs():
    """JAX's float32 epoch functions with on-device R-peak detection."""
    jm = _jax_model()
    _, tx = jax_train_state(jm, jax.random.PRNGKey(0), jnp.zeros((2, 2, 256)))
    return jax_epoch_fns(jm, tx, donate=False, detect_r_pos=True)


def _pair(dtype=torch.float32, seed=3):
    """The JAX model's state from random variables, and the port's train
    state: the model with the same weights and a fresh Adam."""
    jm = _jax_model(dtype)
    x = jnp.zeros((2, 2, 256))
    variables = random_variables(jm, x, seed=seed)
    jstate, _ = jax_train_state(jm, jax.random.PRNGKey(0), x, variables=variables)
    pm = RaleNet(variant="full", depth=DEPTH, dtype=dtype)
    pm.load_state_dict(ralenet_state_dict(variables, "full"))
    return jstate, create_train_state(pm, device="cpu")


def _jax_state_dict(jstate):
    return ralenet_state_dict({"params": jstate.params,
                               "batch_stats": jstate.batch_stats}, "full")


def _assert_state_close(model, jstate, param_tol=PARAM_TOL):
    ref = _jax_state_dict(jstate)
    for key, val in model.state_dict().items():
        if key.endswith("num_batches_tracked"):
            continue
        tol = STATS_TOL if key.endswith(STATS) else param_tol
        np.testing.assert_allclose(val.numpy(), ref[key].numpy(), atol=tol,
                                   rtol=0, err_msg=key)


def _assert_metrics_close(port, ref):
    np.testing.assert_allclose(port["loss"], float(ref["loss"]), rtol=LOSS_TOL)
    # SNR in dB and RMSE from the same forward, per-sample means.
    np.testing.assert_allclose(port["snr"], float(ref["snr"]), atol=1e-4)
    np.testing.assert_allclose(port["rmse"], float(ref["rmse"]), rtol=1e-5)


def test_metrics_match_jax():
    rng = np.random.default_rng(0)
    y, y_pred, y_noisy = (rng.standard_normal((5, 2, 256)).astype(np.float32)
                          for _ in range(3))
    t = [torch.from_numpy(a) for a in (y, y_pred, y_noisy)]
    pairs = [(pmetrics.SNR(t[0], t[1]), jmetrics.SNR(y, y_pred)),
             (pmetrics.RMSE(t[0], t[1]), jmetrics.RMSE(y, y_pred)),
             (pmetrics.PRD(t[0], t[1]), jmetrics.PRD(y, y_pred)),
             (pmetrics.snr_improvement(t[0], t[2], t[1]),
              jmetrics.snr_improvement(y, y_noisy, y_pred)),
             (pmetrics.second_order_difference_loss(t[1]),
              jmetrics.second_order_difference_loss(y_pred))]
    for port, ref in pairs:
        assert port.shape == np.shape(ref)
        np.testing.assert_allclose(port.numpy(), np.asarray(ref), rtol=1e-5, atol=1e-6)


@pytest.mark.parametrize("epochs", [1, 2])
def test_epochs_match_jax(jax_epochs, epochs):
    """Whole-split batches: each epoch is one Adam step on both sides."""
    jstate, state = _pair()
    noisy, clean = _data(BATCH)
    j_train, _ = jax_epochs
    p_train, _ = make_epoch_fns(state.model, state.optimizer)
    tn, tc = torch.from_numpy(noisy), torch.from_numpy(clean)
    for epoch in range(epochs):
        jstate, ref = j_train(jstate, jnp.asarray(noisy), jnp.asarray(clean),
                              jax.random.PRNGKey(epoch), BATCH)
        got = p_train(tn, tc, torch.Generator().manual_seed(epoch), BATCH)
        _assert_metrics_close(got, ref)
    assert state.step == int(jstate.step) == epochs
    _assert_state_close(state.model, jstate)


def _beats(n, seed):
    """Noisy windows holding one beat each, at a seeded position, and the
    clean beats."""
    rng = np.random.default_rng(seed)
    t = np.arange(256)
    centres = rng.integers(20, 236, (n, 1, 1))
    clean = np.exp(-0.5 * ((t - centres) / 4.0) ** 2) * np.ones((1, 2, 1))
    noisy = clean + 0.2 * rng.standard_normal(clean.shape)
    return noisy.astype(np.float32), clean.astype(np.float32)


def test_epochs_with_r_peak_detection_match_jax(jax_rpos_epochs):
    """One f32 training epoch (one whole-split step) and one eval epoch
    with per-batch R-peak detection, against JAX's
    make_epoch_fns(detect_r_pos=True), at the bars of the file."""
    from ecg_denoise_tpu.data.rpeaks import detect_r_peaks as jax_detect
    from ecg_denoise_tpu_torch.data.rpeaks import detect_r_peaks

    jstate, state = _pair(seed=7)
    noisy, clean = _beats(BATCH, seed=3)
    r_pos = detect_r_peaks(torch.from_numpy(noisy))
    np.testing.assert_array_equal(r_pos.numpy(), np.asarray(jax_detect(jnp.asarray(noisy))))
    assert len(set(r_pos.tolist())) == BATCH
    j_train, j_eval = jax_rpos_epochs
    p_train, p_eval = make_epoch_fns(state.model, state.optimizer, detect_r_pos=True)
    tn, tc = torch.from_numpy(noisy), torch.from_numpy(clean)
    jstate, ref = j_train(jstate, jnp.asarray(noisy), jnp.asarray(clean),
                          jax.random.PRNGKey(0), BATCH)
    got = p_train(tn, tc, torch.Generator().manual_seed(0), BATCH)
    _assert_metrics_close(got, ref)
    _assert_state_close(state.model, jstate)
    eval_noisy, eval_clean = _beats(BATCH + 1, seed=4)  # a ragged tail of 1
    ref = j_eval(jstate, jnp.asarray(eval_noisy), jnp.asarray(eval_clean), BATCH)
    got = p_eval(torch.from_numpy(eval_noisy), torch.from_numpy(eval_clean), BATCH)
    _assert_metrics_close(got, ref)


def test_train_epoch_drops_the_ragged_tail():
    _, state = _pair()
    noisy, clean = _data(BATCH + 3)
    p_train, _ = make_epoch_fns(state.model, state.optimizer)
    got = p_train(torch.from_numpy(noisy), torch.from_numpy(clean),
                  torch.Generator().manual_seed(0), BATCH)
    assert state.step == 1 and np.isfinite(list(got.values())).all()


SHORT_SPLIT, SHORT_BATCH = 4, 32  # a training split shorter than one batch


def test_train_epoch_on_a_split_shorter_than_a_batch_matches_jax(jax_epochs):
    """N < batch_size: JAX's scan runs no step and returns NaN means at
    step 0; the port takes no step, returns NaN, and leaves every
    parameter, BN buffer and the Adam state as they were."""
    jstate, state = _pair()
    noisy, clean = _data(SHORT_SPLIT)
    j_train, _ = jax_epochs
    jstate, ref = j_train(jstate, jnp.asarray(noisy), jnp.asarray(clean),
                          jax.random.PRNGKey(0), SHORT_BATCH)
    before = {k: v.clone() for k, v in state.model.state_dict().items()}
    opt_before = repr(state.optimizer.state_dict())
    p_train, _ = make_epoch_fns(state.model, state.optimizer)
    got = p_train(torch.from_numpy(noisy), torch.from_numpy(clean),
                  torch.Generator().manual_seed(0), SHORT_BATCH)
    assert int(jstate.step) == 0 and state.step == 0
    for key in ("loss", "snr", "rmse"):
        assert np.isnan(float(ref[key])) and np.isnan(got[key]), key
    for key, val in state.model.state_dict().items():
        assert torch.equal(val, before[key]), key
    assert repr(state.optimizer.state_dict()) == opt_before


@pytest.mark.parametrize("resume", [False, True])
def test_fit_on_a_split_shorter_than_a_batch(tmp_path, resume):
    """fit on such a split runs fresh and resumed without raising: no step
    is taken, the train metrics are NaN and the test metrics finite; a
    resume starts from epoch 0."""
    noisy, clean = _data(SHORT_SPLIT + 4, seed=8)
    kw = dict(epochs=2, batch_size=SHORT_BATCH, model_name="ralenet", seed=5,
              checkpoint_every=1, verbose=False, device="cpu")
    resume_path = None
    if resume:
        fit(_model(), noisy[:SHORT_SPLIT], clean[:SHORT_SPLIT], noisy[SHORT_SPLIT:],
            clean[SHORT_SPLIT:], model_save_dir=str(tmp_path / "first"),
            output_file=str(tmp_path / "first.txt"), **kw)
        resume_path = find_model(str(tmp_path / "first" / "ralenet"), "ralenet")
    state, hist = fit(_model(), noisy[:SHORT_SPLIT], clean[:SHORT_SPLIT],
                      noisy[SHORT_SPLIT:], clean[SHORT_SPLIT:], resume_path=resume_path,
                      model_save_dir=str(tmp_path / "model_save"),
                      output_file=str(tmp_path / "output.txt"), **kw)
    assert state.step == 0
    assert [len(h) for h in hist] == [2, 2, 2, 2]  # every epoch, from 0
    assert np.isnan(hist[0]).all() and np.isnan(hist[2]).all()
    assert np.isfinite(hist[1]).all() and np.isfinite(hist[3]).all()


def test_eval_epoch_ragged_tail_matches_jax(jax_epochs):
    jstate, state = _pair()
    noisy, clean = _data(2 * BATCH + 1, seed=1)  # a tail of 1 in 3 batches
    _, j_eval = jax_epochs
    _, p_eval = make_epoch_fns(state.model, state.optimizer)
    ref = j_eval(jstate, jnp.asarray(noisy), jnp.asarray(clean), BATCH)
    got = p_eval(torch.from_numpy(noisy), torch.from_numpy(clean), BATCH)
    _assert_metrics_close(got, ref)


def test_step_from_jax_adam_state(jax_epochs):
    """A JAX run's Adam moments and count carry over: the next step of
    both sides agrees."""
    jstate, state = _pair(seed=5)
    noisy, clean = _data(BATCH, seed=2)
    j_train, _ = jax_epochs
    jn, jc = jnp.asarray(noisy), jnp.asarray(clean)
    jstate, _ = j_train(jstate, jn, jc, jax.random.PRNGKey(0), BATCH)
    state.model.load_state_dict(_jax_state_dict(jstate))
    adam = jstate.opt_state[0]
    sd = state.optimizer.state_dict()
    sd["state"] = adam_state_from_optax(adam.mu, adam.nu, adam.count, state.model)
    state.optimizer.load_state_dict(sd)
    assert state.step == 1
    jstate, ref = j_train(jstate, jn, jc, jax.random.PRNGKey(1), BATCH)
    loss, snr, rmse = train_step(state, torch.from_numpy(noisy), torch.from_numpy(clean))
    _assert_metrics_close({"loss": loss.item(), "snr": snr.item(), "rmse": rmse.item()}, ref)
    assert state.step == 2
    _assert_state_close(state.model, jstate)


def test_adam_state_must_cover_the_model():
    jstate, state = _pair()
    adam = jstate.opt_state[0]
    mu = {k: v for k, v in adam.mu.items() if not k.startswith("rwattn")}
    with pytest.raises(ValueError, match="moments"):
        adam_state_from_optax(mu, adam.nu, adam.count, state.model)


def test_bfloat16_step_matches_jax():
    """One step computing in bfloat16 (float32 master weights) against the
    JAX model at dtype=bfloat16 on the same weights.

    Limits: the loss to 2^-6 relative (the forwards part by a few bfloat16
    spacings, test_torch_port_ralenet.test_bfloat16_forward); the running
    stats to 1e-3, the conv stem's bfloat16 output averaged; the
    parameters to lr/2: Adam's first step moves each parameter by about lr
    times the sign of its gradient, so only a parameter whose gradient is
    tiny next to the two frameworks' bfloat16 rounding can differ by more,
    and those must stay few (under 1 %)."""
    jstate, state = _pair(torch.bfloat16)
    noisy, clean = _data(BATCH, seed=4)
    _, tx = jax_train_state(_jax_model(torch.bfloat16), jax.random.PRNGKey(0),
                            jnp.zeros((2, 2, 256)))
    j_train, _ = jax_epoch_fns(_jax_model(torch.bfloat16), tx, donate=False)
    jstate, ref = j_train(jstate, jnp.asarray(noisy), jnp.asarray(clean),
                          jax.random.PRNGKey(0), BATCH)
    loss, _, _ = train_step(state, torch.from_numpy(noisy), torch.from_numpy(clean))
    np.testing.assert_allclose(loss.item(), float(ref["loss"]), rtol=2 ** -6)
    lr = state.optimizer.param_groups[0]["lr"]
    ref_sd = _jax_state_dict(jstate)
    far = total = 0
    for key, val in state.model.state_dict().items():
        if key.endswith("num_batches_tracked"):
            continue
        diff = (val - ref_sd[key]).abs()
        if key.endswith(STATS):
            assert diff.max().item() <= 1e-3, key
            continue
        assert diff.max().item() <= 2 * lr, key
        far += int((diff > lr / 2).sum())
        total += diff.numel()
    assert far <= 0.01 * total, (far, total)


def _write_cache(path, n):
    noisy, clean = _data(n, seed=6)
    os.makedirs(path / "m4")
    np.save(path / "ecg.npy", clean)
    np.save(path / "m4" / "bw.npy", noisy)
    return noisy, clean


def test_sample_and_split_gives_jax_indices():
    for n_total, n_select, seed in [(50, 20, 2023), (1000, 10_000, 7), (37, 37, 0)]:
        for a, b in zip(pdata.sample_and_split(n_total, n_select, seed=seed),
                        jdata.sample_and_split(n_total, n_select, seed=seed)):
            np.testing.assert_array_equal(a, b)


def test_load_split_arrays_gives_jax_arrays(tmp_path):
    _write_cache(tmp_path, 30)
    split = str(tmp_path / "split.json")
    for split_file in (None, split, split):  # computed, then written, then read
        port = pdata.load_split_arrays("bw", -4, path=str(tmp_path), n_select=20,
                                       seed=11, split_file=split_file)
        ref = jdata.load_split_arrays("bw", -4, path=str(tmp_path), n_select=20,
                                      seed=11)
        assert [a.shape for a in port] == [(16, 2, 256), (16, 2, 256), (4, 2, 256),
                                           (4, 2, 256)]
        for a, b in zip(port, ref):
            np.testing.assert_array_equal(a, b)
    assert os.path.exists(split)
    with pytest.raises(FileNotFoundError):
        pdata.EcgDataset("bw", -4, path=str(tmp_path / "missing"))


def test_default_cache_path_stays_in_the_working_directory(tmp_path, monkeypatch):
    _write_cache(tmp_path / "data" / "dict_data", 4)
    monkeypatch.chdir(tmp_path)
    assert len(pdata.EcgDataset("bw", -4)) == 4
    # A cache one directory up is not the working directory's: it is not read.
    (tmp_path / "sub").mkdir()
    monkeypatch.chdir(tmp_path / "sub")
    with pytest.raises(FileNotFoundError):
        pdata.EcgDataset("bw", -4)


def _model(seed=0):
    torch.manual_seed(seed)
    m = RaleNet(variant="full", depth=DEPTH)
    with torch.no_grad():
        for name, p in m.named_parameters():
            if "relative_position_bias_table" in name:
                p.normal_()
    return m


def _fit(model, tmp, epochs, **kw):
    noisy, clean = _data(12, seed=8)
    return fit(model, noisy[:8], clean[:8], noisy[8:], clean[8:], epochs=epochs,
               batch_size=BATCH, model_name="ralenet", noise_name="bw",
               noise_intensity=-4, seed=5, model_save_dir=str(tmp / "model_save"),
               output_file=str(tmp / "output.txt"), checkpoint_every=1,
               verbose=False, device="cpu", **kw)


def test_fit_resumes_exactly_and_writes_the_result_line(tmp_path):
    """A resume trains `epochs` epochs after the checkpoint, counted from 0
    as JAX's `fit` does (ecg_denoise_tpu/train/loop.py:75-76,122,140-141):
    bit for bit `load_checkpoint` followed by `train_epoch` on
    `epoch_generator(seed, e)` for e = 0, 1, with a history of both epochs,
    the step count carried on from the checkpoint's and the checkpoints
    named from epoch 0 again, as JAX names them."""
    from ecg_denoise_tpu.train.checkpoint import checkpoint_path as jax_checkpoint_path
    from ecg_denoise_tpu_torch.train import load_checkpoint
    from ecg_denoise_tpu_torch.train.loop import epoch_generator

    straight, hist = _fit(_model(), tmp_path / "a", 2)
    assert [len(h) for h in hist] == [2, 2, 2, 2]
    assert all(np.isfinite(hist[1]))
    line = (tmp_path / "a" / "output.txt").read_text()
    assert re.fullmatch(r"ralenet_1_bw_intensity-4:snr:[-\d.e]+, rmse:[-\d.e]+\n", line)

    _fit(_model(), tmp_path / "b", 1)
    ckpt = find_model(str(tmp_path / "b" / "model_save" / "ralenet"), "ralenet")
    assert ckpt.endswith("ralenet_0_bw_intensity-4.pth")
    resumed, hist_c = _fit(_model(seed=1), tmp_path / "c", 2, resume_path=ckpt)
    assert [len(h) for h in hist_c] == [2, 2, 2, 2]  # `epochs` epochs, from 0
    assert resumed.step == 2 + 2 * 2  # the checkpoint's 2 steps, then 2 epochs of 2

    noisy, clean = (torch.from_numpy(a) for a in _data(12, seed=8))
    by_hand = create_train_state(_model(seed=2), device="cpu")
    load_checkpoint(ckpt, by_hand)
    train_epoch, eval_epoch = make_epoch_fns(by_hand.model, by_hand.optimizer)
    hist_hand = ([], [], [], [])
    for epoch in range(2):
        tr = train_epoch(noisy[:8], clean[:8], epoch_generator(5, epoch, "cpu"), BATCH)
        te = eval_epoch(noisy[8:], clean[8:], BATCH)
        for h, x in zip(hist_hand, (tr["snr"], te["snr"], tr["rmse"], te["rmse"])):
            h.append(x)
    assert by_hand.step == resumed.step
    for key, val in by_hand.model.state_dict().items():
        torch.testing.assert_close(resumed.model.state_dict()[key], val, atol=0,
                                   rtol=0, msg=key)
    assert repr(resumed.optimizer.state_dict()) == repr(by_hand.optimizer.state_dict())
    np.testing.assert_array_equal(np.asarray(hist_c), np.asarray(hist_hand))
    names = sorted(os.listdir(tmp_path / "c" / "model_save" / "ralenet"))
    jax_names = sorted(os.path.basename(jax_checkpoint_path(
        "d", "ralenet", e, "bw", -4)).replace(".msgpack", ".pth") for e in range(2))
    assert names == jax_names == ["ralenet_0_bw_intensity-4.pth",
                                  "ralenet_1_bw_intensity-4.pth"]
    assert find_model(str(tmp_path / "a" / "model_save" / "ralenet")).endswith(
        "ralenet_1_bw_intensity-4.pth")


def test_fit_with_r_pos_detect_runs_the_detecting_epochs(tmp_path):
    """fit(r_pos_mode="detect") trains exactly as the detecting epoch
    functions do, and differs from training without detection."""
    state, hist = _fit(_model(), tmp_path / "a", 1, r_pos_mode="detect")
    assert all(np.isfinite(h).all() for h in hist)
    assert (tmp_path / "a" / "output.txt").exists()
    plain, _ = _fit(_model(), tmp_path / "b", 1)

    noisy, clean = (torch.from_numpy(a) for a in _data(12, seed=8))
    by_hand = create_train_state(_model(), device="cpu")
    train_epoch, eval_epoch = make_epoch_fns(by_hand.model, by_hand.optimizer,
                                             detect_r_pos=True)
    from ecg_denoise_tpu_torch.train.loop import epoch_generator

    train_epoch(noisy[:8], clean[:8], epoch_generator(5, 0, "cpu"), BATCH)
    # The CPU's threaded sums are not bit-reproducible from run to run.
    np.testing.assert_allclose(eval_epoch(noisy[8:], clean[8:], BATCH)["snr"],
                               hist[1][0], atol=1e-5)
    for key, val in state.model.state_dict().items():
        torch.testing.assert_close(by_hand.model.state_dict()[key], val,
                                   atol=STATS_TOL, rtol=0, msg=key)
    table = "rwattn1.relative_position_bias_table"
    diff = state.model.state_dict()[table] - plain.model.state_dict()[table]
    assert diff.abs().max() > 100 * STATS_TOL


def test_fit_rejects_an_unknown_r_pos_mode(tmp_path):
    with pytest.raises(ValueError, match="r_pos_mode"):
        _fit(_model(), tmp_path, 1, r_pos_mode="centre")


def test_serving_reads_a_training_checkpoint(tmp_path):
    """`Denoiser.from_checkpoint` takes the "model" part of a checkpoint
    that `save_checkpoint` wrote (the bare state_dict case is in
    test_torch_port_serving)."""
    from ecg_denoise_tpu_torch.models import build_model
    from ecg_denoise_tpu_torch.serving import Denoiser
    from ecg_denoise_tpu_torch.train import save_checkpoint

    torch.manual_seed(2)
    state = create_train_state(build_model("ralenet", device="cpu"), device="cpu")
    path = save_checkpoint(str(tmp_path / "ralenet" / "ralenet_9_bw_intensity-4.pth"),
                           state)
    denoiser = Denoiser.from_checkpoint("ralenet", path, max_batch=4, device="cpu")
    x = _data(3, seed=9)[0]
    with torch.no_grad():
        ref = state.model.eval()(torch.from_numpy(x)).numpy()
    np.testing.assert_allclose(denoiser(x), ref, atol=1e-5, rtol=0)


@pytest.mark.parametrize("argv,cards,match", [
    ([], False, "no CUDA device"),
    (["--n_data", "2"], False, "no CUDA device"),
    (["--n_model", "2"], False, "no CUDA device"),
    (["--multihost"], False, "no CUDA device"),
    (["--n_data", "2", "--n_model", "2"], True,
     "--n_data 2 --n_model 2 needs 4 cards, but 0 are visible"),
])
def test_cli_raises_without_a_card_or_enough_cards(monkeypatch, argv, cards, match):
    """Without a card the CLI raises, data or tensor parallel or not (no path
    falls back to the CPU); where the device is there (`default_device`
    patched) but fewer cards are visible than the ('data', 'model') grid
    has ranks, it names the count it needs."""
    import ecg_denoise_tpu_torch
    from ecg_denoise_tpu_torch.cli.main import main

    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    if cards:
        monkeypatch.setattr(ecg_denoise_tpu_torch, "default_device",
                            lambda: torch.device("cpu"))
    with pytest.raises(RuntimeError, match=match):
        main(argv)


def test_config_parses_r_pos_detect():
    from ecg_denoise_tpu_torch.config import build_argparser, config_from_args

    parse = build_argparser().parse_args
    assert config_from_args(parse(["--r_pos", "detect"])).r_pos == "detect"
    assert config_from_args(parse([])).r_pos is None
    with pytest.raises(SystemExit):
        parse(["--r_pos", "centre"])


def test_cli_trains_with_r_pos_detect(monkeypatch, tmp_path):
    """`cli.main --r_pos detect`, rehearsed on the CPU: the flag reaches
    fit as r_pos_mode="detect" and the run writes its checkpoint and
    result line."""
    import ecg_denoise_tpu_torch
    from ecg_denoise_tpu_torch import train
    from ecg_denoise_tpu_torch.cli.main import main

    monkeypatch.setattr(ecg_denoise_tpu_torch, "default_device",
                        lambda: torch.device("cpu"))
    seen = {}

    def spy(*args, **kw):
        seen.update(kw)
        return fit(*args, **kw)

    monkeypatch.setattr(train, "fit", spy)
    _write_cache(tmp_path / "dict_data", 10)
    main(["--model_index", "4", "--dtype", "float32", "--n_select", "10",
          "--epochs", "1", "--batch_size", "4", "--r_pos", "detect",
          "--data_path", str(tmp_path / "dict_data"),
          "--model_save_dir", str(tmp_path / "model_save"),
          "--output_file", str(tmp_path / "output.txt")])
    assert seen["r_pos_mode"] == "detect" and seen["device"].type == "cpu"
    assert (tmp_path / "output.txt").read_text().startswith("ralenet_0_bw_intensity-4:")
