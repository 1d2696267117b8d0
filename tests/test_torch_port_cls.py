"""The port's beat classifier path against the JAX package's, on the CPU.

The cls metrics bit for bit JAX's on fixed logits, 0/0 included. ResNetCls
at its full width (445,122 parameters), B = 4, L = 256: the eval forward
within 1e-4 of JAX's through `resnet_cls_state_dict` at float32 (the bar of
tests/test_torch_parity.py), and at bfloat16 within 2^-5 (the bar of
`test_torch_port_families.test_bfloat16_forward`). One training step on
JAX's permutation at the bars of a step (`__graft_entry__.py:120-129`):
loss 1e-5 relative, parameters 1e-4, BN running stats 1e-5, with the
gradients held to JAX's gradients compiled without XLA's backend
optimisation (see the test for why, and for the few parameters whose step
the jitted step's rounding decides); no conv of ResNetCls has a bias, so
no tensor is frozen. `eval_epoch` with a ragged tail against JAX's
logits (1e-4) and metrics. `cli.train_cls` and `cli.test_cls` on a
`build_cls_data(n_train=64, n_test=16)` cache with `device="cpu"`.
"""

import os
import re

import numpy as np
import pytest
import torch
torch.set_num_threads(1)  # six test workers share the host's cores: one intra-op thread each
import jax
import jax.numpy as jnp
import optax

import ecg_denoise_tpu.metrics.cls as jmet
from ecg_denoise_tpu.models import ResNetCls as JaxResNetCls
from ecg_denoise_tpu.train.cls_steps import make_cls_epoch_fns as jax_cls_epoch_fns
from ecg_denoise_tpu.train.state import create_train_state as jax_train_state
from ecg_denoise_tpu_torch import MODEL_NAMES
from ecg_denoise_tpu_torch.interop.jax_weights import resnet_cls_state_dict
from ecg_denoise_tpu_torch.metrics import accuracy, f1_score, precision
from ecg_denoise_tpu_torch.models import ResNetCls
from ecg_denoise_tpu_torch.train import cls_epoch, create_train_state, make_cls_epoch_fns
from test_torch_port_layers import random_variables

ATOL = 1e-4
BF16_ATOL = 2 ** -5
LOSS_TOL = 1e-5
PARAM_TOL = 1e-4
STATS_TOL = 1e-5
STATS = ("running_mean", "running_var")
GRAD_TOL_OF_MAX = 1e-4
LR = 1e-3  # Adam's, both sides
GRAD_FLOOR_OF_MAX = 1e-6  # the rounding floor of `chip_smoke.step_bars`


def _x(*shape, seed=1):
    return np.random.default_rng(seed).standard_normal(shape).astype(np.float32)


def _pair(dtype=torch.float32, seed=0):
    """JAX ResNetCls, random variables of it, and the port's with them."""
    jm = JaxResNetCls(dtype=jnp.bfloat16 if dtype == torch.bfloat16 else jnp.float32)
    v = random_variables(jm, jnp.zeros((2, 2, 256)), seed=seed)
    pm = ResNetCls(dtype=dtype)
    pm.load_state_dict(resnet_cls_state_dict(v))
    return jm, v, pm


# Logits and labels: random, none predicted positive (precision 0/0), all
# right, all wrong, and ties (argmax takes the first).
METRIC_CASES = {
    "random": (_x(37, 2, seed=3), np.random.default_rng(4).integers(0, 2, 37)),
    "none_positive": (np.tile([[1.0, -1.0]], (6, 1)), np.array([0, 1, 0, 1, 1, 0])),
    "all_right": (np.array([[0.0, 2.0], [3.0, 1.0]]), np.array([1, 0])),
    "all_wrong": (np.array([[0.0, 2.0], [3.0, 1.0]]), np.array([0, 1])),
    "ties": (np.zeros((4, 2)), np.array([0, 1, 1, 0])),
}


@pytest.mark.parametrize("case", METRIC_CASES)
@pytest.mark.parametrize("metric", ["accuracy", "precision", "f1_score"])
def test_metrics_equal_jax(case, metric):
    logits, label = METRIC_CASES[case]
    logits, label = logits.astype(np.float32), label.astype(np.int32)
    ref = np.asarray(getattr(jmet, metric)(jnp.asarray(logits), jnp.asarray(label)))
    got = {"accuracy": accuracy, "precision": precision, "f1_score": f1_score}[metric](
        torch.from_numpy(logits), torch.from_numpy(label))
    assert got.dtype == torch.float32 and ref.dtype == np.float32
    np.testing.assert_array_equal(got.numpy(), ref)
    if case == "none_positive" and metric == "precision":
        assert np.isnan(got.item())


def test_resnet_cls_forward_matches_jax():
    jm, v, pm = _pair()
    assert sum(p.numel() for p in pm.parameters()) == 445_122
    x = _x(4, 2, 256)
    ref = np.asarray(jax.jit(lambda v, x: jm.apply(v, x, train=False))(v, x))
    with torch.no_grad():
        y = pm.eval()(torch.from_numpy(x))
    assert y.shape == (4, 2) and y.dtype == torch.float32
    np.testing.assert_allclose(y.numpy(), ref, atol=ATOL, rtol=0)


def test_resnet_cls_bfloat16_forward():
    """bfloat16 compute from float32 parameters against JAX at
    dtype=bfloat16: the output dtype is JAX's and the values within 2^-5."""
    jm, v, pm = _pair(torch.bfloat16, seed=2)
    assert all(p.dtype == torch.float32 for p in pm.parameters())
    x = _x(4, 2, 256, seed=5)
    ref = jax.jit(lambda v, x: jm.apply(v, x, train=False))(v, x)
    with torch.no_grad():
        y = pm.eval()(torch.from_numpy(x))
    assert y.dtype == torch.bfloat16 and str(ref.dtype) == "bfloat16"
    np.testing.assert_allclose(y.float().numpy(), np.asarray(ref).astype(np.float32),
                               atol=BF16_ATOL, rtol=0)


def _jax_reference_grads(jm, variables, data, label):
    """JAX's gradients of one step's loss (`cls_steps.loss_fn`'s: the
    training-mode forward and the mean cross-entropy on float32 logits),
    compiled with XLA's backend optimisation off. They agree with JAX's
    un-jitted gradients (`jax.disable_jit()`, many times slower to run) to
    float32 rounding; the gradients of the optimised jitted step lie
    further off, enough to flip the step of a few elements whose gradient
    is near 0."""

    def loss_fn(params):
        logits, _ = jm.apply({"params": params, "batch_stats": variables["batch_stats"]},
                             data, train=True, mutable=["batch_stats"])
        return jnp.mean(optax.softmax_cross_entropy_with_integer_labels(
            logits.astype(jnp.float32), label))

    grad = jax.jit(jax.grad(loss_fn)).lower(variables["params"]).compile(
        {"xla_backend_optimization_level": 0})
    return resnet_cls_state_dict({"params": jax.tree.map(
        np.asarray, grad(variables["params"]))})


def test_train_step_on_jax_permutation_matches_jax():
    """One step (12 samples at batch 8: the permutation picks which 8) on
    JAX's permutation against JAX's jitted step: the loss, the accuracy and
    every BN running stat at the bars of a step. The port's gradients are
    held to JAX's reference gradients (`_jax_reference_grads`) within 1e-4
    of each tensor's largest, or the rounding floor (1e-6 of the largest
    gradient) where that is larger, and every parameter to JAX's step within
    1e-4 wherever Adam's first step (lr times the gradient's sign) is
    decided on both sides: above the floor, and where the jitted step's
    gradient has the reference's sign. A few elements with a gradient near 0
    step the other way in the jitted step, whose gradients lie further from
    the reference (see `_jax_reference_grads`); there the port's parameter
    is held to the reference's step."""
    jm, v, pm = _pair(seed=6)
    n, batch = 12, 8
    data = _x(n, 2, 256, seed=7)
    label = np.random.default_rng(8).integers(0, 2, n).astype(np.int32)
    jstate, tx = jax_train_state(jm, jax.random.PRNGKey(0), jnp.zeros((2, 2, 256)),
                                 variables=v)
    j_train, _ = jax_cls_epoch_fns(jm, tx)
    key = jax.random.PRNGKey(3)
    perm = np.array(jax.random.permutation(key, n))
    ref_grads = _jax_reference_grads(jm, v, data[perm[:batch]], label[perm[:batch]])
    jstate, ref = j_train(jstate, jnp.asarray(data), jnp.asarray(label), key, batch)
    before = {k: p.detach().clone() for k, p in pm.named_parameters()}
    state = create_train_state(pm, device="cpu")
    got = cls_epoch(state, torch.from_numpy(data), torch.from_numpy(label),
                    torch.from_numpy(perm).long(), batch)
    np.testing.assert_allclose(got["loss"], float(ref["loss"]), rtol=LOSS_TOL)
    assert got["acc"] == float(ref["acc"])
    assert state.step == int(jstate.step) == 1
    ref_sd = resnet_cls_state_dict({"params": jstate.params,
                                    "batch_stats": jstate.batch_stats})
    for key, val in state.model.state_dict().items():
        if key.endswith(STATS):
            np.testing.assert_allclose(val.numpy(), ref_sd[key].numpy(), atol=STATS_TOL,
                                       rtol=0, err_msg=key)
    # The jitted step's gradients from Adam's first moment, mu = (1 - b1) g
    # after one step.
    step_grads = resnet_cls_state_dict({"params": jax.tree.map(
        lambda mu: np.asarray(mu) / 0.1, jstate.opt_state[0].mu)})
    floor = GRAD_FLOOR_OF_MAX * max(g.abs().max().item() for g in ref_grads.values())
    flipped = 0
    for key, p in state.model.named_parameters():
        g_ref = ref_grads[key]
        bar = max(GRAD_TOL_OF_MAX * g_ref.abs().max().item(), floor)
        assert (p.grad - g_ref).abs().max().item() <= bar, key
        above = g_ref.abs() > floor
        held = above & (torch.sign(step_grads[key]) == torch.sign(g_ref))
        np.testing.assert_allclose(p.detach()[held].numpy(), ref_sd[key][held].numpy(),
                                   atol=PARAM_TOL, rtol=0, err_msg=key)
        # Where the jitted step's rounding flipped the step, the port took
        # the reference's: Adam's first step is lr g / (|g| + eps), lr times
        # the sign here.
        flip = above & ~held
        flipped += int(flip.sum())
        np.testing.assert_allclose(p.detach()[flip].numpy(), (before[key] - LR * torch.sign(
            g_ref))[flip].numpy(), atol=PARAM_TOL, rtol=0, err_msg=key)
    assert flipped <= 1e-3 * sum(p.numel() for p in state.model.parameters()), flipped


def test_eval_epoch_with_a_ragged_tail_matches_jax():
    """10 samples at batch 4 (a tail of 2, padded with zeros on both
    sides): the logits within 1e-4 of JAX's, loss and accuracy too."""
    jm, v, pm = _pair(seed=9)
    data = _x(10, 2, 256, seed=10)
    label = np.random.default_rng(11).integers(0, 2, 10).astype(np.int32)
    jstate, tx = jax_train_state(jm, jax.random.PRNGKey(0), jnp.zeros((2, 2, 256)),
                                 variables=v)
    _, j_eval = jax_cls_epoch_fns(jm, tx)
    ref, ref_logits = j_eval(jstate, jnp.asarray(data), jnp.asarray(label), 4)
    state = create_train_state(pm, device="cpu")
    _, p_eval = make_cls_epoch_fns(state.model, state.optimizer)
    got, logits = p_eval(torch.from_numpy(data), torch.from_numpy(label), 4)
    assert logits.shape == (10, 2)
    np.testing.assert_allclose(logits.numpy(), np.asarray(ref_logits), atol=ATOL, rtol=0)
    np.testing.assert_allclose(got["loss"], float(ref["loss"]), rtol=LOSS_TOL)
    assert got["acc"] == float(ref["acc"])


def test_train_epoch_on_a_split_shorter_than_a_batch_takes_no_step():
    """A split shorter than one batch takes no step and returns NaN metrics,
    as JAX's scan over no steps gives."""
    state = create_train_state(ResNetCls(), device="cpu")
    train_epoch, _ = make_cls_epoch_fns(state.model, state.optimizer)
    got = train_epoch(torch.zeros(3, 2, 256), torch.zeros(3, dtype=torch.int32),
                      torch.Generator().manual_seed(0), 4)
    assert np.isnan(got["loss"]) and np.isnan(got["acc"]) and state.step == 0


@pytest.fixture(scope="module")
def cls_cache(tmp_path_factory):
    from ecg_denoise_tpu_torch.data.cls_cache import build_cls_data

    path = tmp_path_factory.mktemp("cls")
    build_cls_data(str(path), n_train=64, n_test=16)
    return str(path)


def test_cli_train_cls_then_test_cls(cls_cache, tmp_path, capsys):
    """`cli.train_cls` trains one epoch and saves; `cli.test_cls` loads the
    classifier, reports clean and noisy, the one denoiser whose checkpoint
    is there (UNet, found by the reference's naming), a skip line for each
    other denoiser, and dwt and fft, in the JAX CLI's order and line form."""
    from ecg_denoise_tpu_torch.cli import test_cls, train_cls
    from ecg_denoise_tpu_torch.models import build_model

    save = str(tmp_path / "model_save" / "cls_model.pth")
    train_cls.main(["--epochs", "1", "--batch_size", "16", "--data_path", cls_cache,
                    "--save", save], device="cpu")
    out = capsys.readouterr().out.splitlines()
    assert re.fullmatch(r"epoch 01/1 train_loss=\d+\.\d{4} train_acc=\d\.\d{4} "
                        r"test_loss=\d+\.\d{4} test_acc=\d\.\d{4}", out[0]), out
    assert out[1] == f"saved {save}" and os.path.exists(save)

    os.makedirs(tmp_path / "model_save" / "unet")
    torch.save(build_model("unet", device="cpu").state_dict(),
               tmp_path / "model_save" / "unet" / "unet_99_emb_intensity-4.pth")
    test_cls.main(["--cls_ckpt", save, "--model_save_dir", str(tmp_path / "model_save"),
                   "--data_path", cls_cache], device="cpu")
    lines = capsys.readouterr().out.splitlines()
    assert [line.split()[0] for line in lines] == ["clean", "noisy", *MODEL_NAMES,
                                                   "dwt", "fft"]
    metric = r"acc=\d\.\d{4} precision=(\d\.\d{4}|nan) f1=\d\.\d{4}"
    for line in lines:
        name = line.split()[0]
        if name in MODEL_NAMES and name != "unet":
            assert line == (f"{name:24s} (no checkpoint under "
                            f"{tmp_path / 'model_save' / name} — skipped)")
        else:
            assert re.fullmatch(rf"{re.escape(f'{name:24s}')} {metric}", line), line


def test_cli_test_cls_warns_without_a_classifier(cls_cache, tmp_path, capsys):
    from ecg_denoise_tpu_torch.cli import test_cls

    missing = str(tmp_path / "none.pth")
    test_cls.main(["--cls_ckpt", missing, "--model_save_dir", str(tmp_path),
                   "--data_path", cls_cache], device="cpu")
    out = capsys.readouterr().out.splitlines()
    assert out[0] == (f"WARNING: classifier checkpoint {missing} missing — "
                      "using untrained weights (run cli.train_cls first)")
    assert len(out) == 1 + 2 + len(MODEL_NAMES) + 2
