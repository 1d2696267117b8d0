"""The port's UNet, DANet (Seq2Seq2) and ACDAE, and the layers only they
use, against the JAX package's, on the CPU.

The models run at their own widths (about 10k, 18k and 152k parameters)
on small batches. Weights go both ways: random numpy variables of the JAX
model (`random_variables`: nonzero biases and BN statistics) reach the
port through its maps in `interop.jax_weights`, and a port module's
weights reach the JAX model through the JAX package's own
`unet_variables`, `seq2seq2_variables` and `acdae_variables`. Tolerances:
eval outputs 1e-4 at float32 (the bar of tests/test_torch_parity.py); a
train step's loss 1e-5 relative, parameters 1e-4, BN running stats 1e-5
(`__graft_entry__.py:120-129`), gradients 1e-4 of each tensor's largest,
and where JAX's gradient is at the rounding floor `chip_smoke.step_bars`'
rule; bfloat16 forwards at the bar of
`test_torch_port_ralenet.py::test_bfloat16_forward`, and bfloat16 layers
at the bar of `test_torch_port_layers.py::test_bfloat16_rounds_where_jax_does`.
"""

import os

import numpy as np
import pytest
import torch
torch.set_num_threads(1)  # six test workers share the host's cores: one intra-op thread each
import jax
import jax.numpy as jnp

import ecg_denoise_tpu.ops.layers as jlay
from ecg_denoise_tpu.interop.torch_weights import (
    acdae_variables,
    seq2seq2_variables,
    unet_variables,
)
from ecg_denoise_tpu.models import ACDAE as JaxACDAE
from ecg_denoise_tpu.models import UNet as JaxUNet
from ecg_denoise_tpu.models import Seq2Seq2 as JaxSeq2Seq2
from ecg_denoise_tpu.models.dam import DAM as JaxDAM
from ecg_denoise_tpu.models.dam import APReLU as JaxAPReLU
from ecg_denoise_tpu.train import create_train_state as jax_train_state
from ecg_denoise_tpu.train import make_epoch_fns as jax_epoch_fns
from ecg_denoise_tpu_torch.interop.jax_weights import (
    acdae_state_dict,
    seq2seq2_state_dict,
    state_dict_from_variables,
    unet_state_dict,
)
from ecg_denoise_tpu_torch.models import build_model
from ecg_denoise_tpu_torch.models.dam import DAM, APReLU
from ecg_denoise_tpu_torch.ops import layers as play
from ecg_denoise_tpu_torch.train import create_train_state, make_epoch_fns
from test_torch_port_layers import random_variables

ATOL = 1e-4
LOSS_TOL = 1e-5
STATS_TOL = 1e-5
STATS = ("running_mean", "running_var")
BF16 = jnp.bfloat16
BATCH = 4

# name -> (JAX module class, the port's map, the JAX package's map).
FAMILIES = {
    "unet": (JaxUNet, unet_state_dict, unet_variables),
    "DANet": (JaxSeq2Seq2, seq2seq2_state_dict, seq2seq2_variables),
    "ACDAE": (JaxACDAE, acdae_state_dict, acdae_variables),
}


def _x(*shape, seed=1):
    return np.random.default_rng(seed).standard_normal(shape).astype(np.float32)


def _pair(name, dtype=torch.float32, seed=0, length=256):
    """The JAX model, random variables of it, and the port's model with
    the same weights."""
    jax_cls, to_port, _ = FAMILIES[name]
    jm = jax_cls(dtype=BF16 if dtype == torch.bfloat16 else jnp.float32)
    v = random_variables(jm, jnp.zeros((2, 2, length)), seed=seed)
    pm = build_model(name, dtype=dtype, device="cpu")
    pm.load_state_dict(to_port(v))
    return jm, v, pm


def _jax_eval(jm):
    return jax.jit(lambda v, x: jm.apply(v, x, train=False))


def _port_eval(pm, x):
    with torch.no_grad():
        return pm.eval()(torch.from_numpy(x))


# --- the layers -------------------------------------------------------------


@pytest.mark.parametrize("c_in,c_out,k,stride,pad,L", [
    (32, 16, 4, 2, 1, 16),   # UNet's and DANet's first decoder stage
    (8, 4, 18, 2, 8, 64),    # DANet's third
    (128, 64, 7, 1, 3, 16),  # ACDAE's first
    (16, 2, 13, 1, 6, 128),  # ACDAE's last
])
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_conv_transpose(c_in, c_out, k, stride, pad, L, dtype):
    """torch's ConvTranspose1d against the JAX layer (a flipped kernel
    over a dilated input), weight (k, in, out) -> (in, out, k); bfloat16
    rounds the product before the bias, as the JAX layer does."""
    x = _x(2, c_in, L)
    jdtype = BF16 if dtype == torch.bfloat16 else jnp.float32
    jm = jlay.ConvTranspose1d(c_out, k, stride=stride, padding=pad, dtype=jdtype)
    v = random_variables(jm, jnp.asarray(x))
    pm = play.ConvTranspose1d(c_in, c_out, k, stride=stride, padding=pad)
    pm.load_state_dict(state_dict_from_variables(v, transposed=lambda path: True))
    ref = np.asarray(jm.apply(v, jnp.asarray(x, jdtype)))
    with torch.no_grad():
        y = pm(torch.from_numpy(x).to(dtype))
    assert y.dtype == dtype and y.shape == ref.shape
    assert y.shape[-1] == (L - 1) * stride - 2 * pad + k
    _assert_layer_close(y, ref, dtype)


def _assert_layer_close(y, ref, dtype):
    y, ref = y.float().numpy(), np.asarray(ref).astype(np.float32)
    if dtype == torch.float32:
        np.testing.assert_allclose(y, ref, atol=1e-5, rtol=0)
        return
    assert (y != ref).mean() <= 0.01, (y != ref).mean()
    np.testing.assert_allclose(y, ref, atol=2 ** -7 * np.abs(ref).max(), rtol=0)


@pytest.mark.parametrize("fn,L", [(fn, L) for fn in ("max_pool1d", "adaptive_avg_pool1d",
                                                     "linear_upsample2x")
                                   for L in (64, 33, 1) if (fn, L) != ("max_pool1d", 1)])
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_pools_and_upsample(fn, L, dtype):
    """The output and its dtype as JAX's: a bfloat16 input comes back
    float32 from the upsample (its weights are float32) and bfloat16 from
    the pools. (A window of 2 does not fit a length of 1.)"""
    x = _x(2, 3, L)
    jdtype = BF16 if dtype == torch.bfloat16 else jnp.float32
    ref = getattr(jlay, fn)(jnp.asarray(x, jdtype))
    y = getattr(play, fn)(torch.from_numpy(x).to(dtype))
    assert str(y.dtype)[6:] == str(ref.dtype) and y.shape == ref.shape
    _assert_layer_close(y, ref, dtype)


def test_batchnorm_at_one_value_per_channel_matches_jax():
    """Training with one value per channel (APReLU's gates at batch 1):
    torch.nn raises; the port normalises with variance 0, as JAX does."""
    x = _x(1, 6)
    jm = jlay.BatchNorm1d()
    v = random_variables(jm, jnp.asarray(x))
    ref, upd = jm.apply(v, jnp.asarray(x), mutable=["batch_stats"])
    pm = play.BatchNorm1d(6)
    pm.load_state_dict(state_dict_from_variables(v))
    y = pm.train()(torch.from_numpy(x))
    np.testing.assert_allclose(y.detach().numpy(), np.asarray(ref), atol=1e-6, rtol=0)
    for name, key in (("running_mean", "mean"), ("running_var", "var")):
        np.testing.assert_allclose(getattr(pm, name).numpy(),
                                   np.asarray(upd["batch_stats"][key]), atol=1e-7, rtol=0)
    with pytest.raises(ValueError, match="more than 1 value"):
        torch.nn.BatchNorm1d(6).train()(torch.from_numpy(x))


@pytest.mark.parametrize("batch", [1, 3])
def test_aprelu_and_dam_train_mode_match_jax(batch):
    """APReLU's and DAM's train-mode forward and BN stats against JAX's:
    DAM's one FCN runs twice a forward and its BatchNorms update twice."""
    for jax_cls, port_cls in ((JaxAPReLU, APReLU), (JaxDAM, DAM)):
        x = _x(batch, 8, 32, seed=batch)
        jm = jax_cls(8)
        v = random_variables(jm, jnp.asarray(x))
        ref, upd = jm.apply(v, jnp.asarray(x), train=True, mutable=["batch_stats"])
        renames = {"fc1": "fcn.0", "bn1": "fcn.1", "fc2": "fcn.3", "bn2": "fcn.4",
                   "fcn_fc1": "fcn1.0", "fcn_bn1": "fcn1.1", "fcn_fc2": "fcn1.3",
                   "fcn_bn2": "fcn1.4"}
        pm = port_cls(8)
        pm.load_state_dict(state_dict_from_variables(v, renames), strict=False)
        y = pm.train()(torch.from_numpy(x))
        np.testing.assert_allclose(y.detach().numpy(), np.asarray(ref), atol=1e-5, rtol=0)
        got = state_dict_from_variables({"batch_stats": upd["batch_stats"]}, renames)
        sd = pm.state_dict()
        for key, val in got.items():
            if key.endswith(STATS):
                np.testing.assert_allclose(sd[key].numpy(), val.numpy(), atol=STATS_TOL,
                                           rtol=0, err_msg=key)


def test_dam_shares_one_fcn():
    """fcn1 and fcn2 are one module: both key sets in the state_dict, each
    tensor once among the parameters, and loading either key set fills
    both."""
    m = DAM(8)
    assert m.fcn1 is m.fcn2
    sd = m.state_dict()
    assert {k for k in sd if k.startswith("fcn1.")} == {
        k.replace("fcn2.", "fcn1.") for k in sd if k.startswith("fcn2.")}
    names = [n for n, _ in m.named_parameters()]
    assert not any(n.startswith("fcn2.") for n in names) and len(names) == 10
    model = build_model("DANet", device="cpu")
    n_unique = len({id(p) for p in model.parameters()})
    assert n_unique == len(list(model.parameters())) == len(
        [k for k in model.state_dict() if k.endswith(("weight", "bias"))
         and ".fcn2." not in k])


# --- the models -------------------------------------------------------------


@pytest.mark.parametrize("name", list(FAMILIES))
def test_forward_matches_jax_both_ways(name):
    """Eval forward within 1e-4 at float32: JAX variables -> the port's
    map -> the port; and the port's weights -> the JAX package's map ->
    the JAX model, which inverts the port's map exactly."""
    x = _x(3, 2, 256)
    jm, v, pm = _pair(name)
    run = _jax_eval(jm)
    y = _port_eval(pm, x)
    assert y.dtype == torch.float32 and y.shape == x.shape
    np.testing.assert_allclose(y.numpy(), np.asarray(run(v, x)), atol=ATOL, rtol=0)
    torch.manual_seed(5)  # fresh port weights, nonzero BN stats
    pm = build_model(name, device="cpu")
    with torch.no_grad():
        for key, t in pm.state_dict().items():
            if key.endswith("running_mean"):
                t.normal_(0, 0.1)
            elif key.endswith("running_var"):
                t.uniform_(0.5, 1.5)
    variables = FAMILIES[name][2](pm)
    sd = FAMILIES[name][1](variables)
    assert sd.keys() == pm.state_dict().keys()
    for key, val in pm.state_dict().items():
        if not key.endswith("num_batches_tracked"):
            torch.testing.assert_close(sd[key], val, atol=0, rtol=0, msg=key)
    np.testing.assert_allclose(_port_eval(pm, x).numpy(), np.asarray(run(variables, x)),
                               atol=ATOL, rtol=0)


@pytest.mark.parametrize("name", list(FAMILIES))
def test_bfloat16_forward(name):
    """Computing in bfloat16 from float32 parameters against the JAX model
    at dtype=bfloat16: the output dtype is JAX's (ACDAE's float32, the
    upsample's), and the values within 2^-5 (four bfloat16 spacings at
    |y| < 2, asserted; `test_torch_port_ralenet.test_bfloat16_forward`
    says why no tighter model-level bar holds)."""
    x = _x(3, 2, 256, seed=2)
    jm, v, pm = _pair(name, torch.bfloat16, seed=3)
    assert all(p.dtype == torch.float32 for p in pm.parameters())
    ref = _jax_eval(jm)(v, x)
    y = _port_eval(pm, x)
    assert str(y.dtype)[6:] == str(ref.dtype)
    assert y.dtype == (torch.float32 if name == "ACDAE" else torch.bfloat16)
    ref = np.asarray(ref).astype(np.float32)
    assert np.abs(ref).max() < 2
    np.testing.assert_allclose(y.float().numpy(), ref, atol=2 ** -5, rtol=0)


def _noisy_clean(n, seed=0, channels=2):
    rng = np.random.default_rng(seed)
    t = np.linspace(0, 6 * np.pi, 256)
    clean = np.sin(t + rng.uniform(0, 6, (n, channels, 1)))
    noisy = clean + 0.5 * rng.standard_normal(clean.shape)
    return noisy.astype(np.float32), clean.astype(np.float32)


@pytest.mark.parametrize("name", list(FAMILIES))
def test_train_step_matches_jax(name):
    """One Adam step (an epoch whose batch is the whole split, so the two
    frameworks' permutations only reorder a mean) against JAX's: loss
    1e-5 relative, BN running stats 1e-5 (DANet's DAM BNs updated twice,
    under both of their names), and the gradients and parameters at the
    bars of `chip_smoke.step_bars`, with JAX's step as the reference: each
    tensor's gradients within 1e-4 of its largest and the parameters
    within 1e-4, except where JAX's gradient is at the rounding floor (at
    most 1e-6 of its largest). There the gradient is held to the larger of
    that floor and its tensor's bar, and the parameter not at all, since
    Adam's first step moves it by lr times the sign of a rounding; only a
    bias may sit at the floor whole (a bias that feeds a training-mode
    BatchNorm has gradient 0 in exact arithmetic)."""
    import chip_smoke

    jm, v, pm = _pair(name, seed=4)
    jstate, tx = jax_train_state(jm, jax.random.PRNGKey(0), jnp.zeros((2, 2, 256)),
                                 variables=v)
    j_train, _ = jax_epoch_fns(jm, tx, donate=False)
    state = create_train_state(pm, device="cpu")
    p_train, _ = make_epoch_fns(state.model, state.optimizer)
    noisy, clean = _noisy_clean(BATCH, seed=1)
    jstate, ref = j_train(jstate, jnp.asarray(noisy), jnp.asarray(clean),
                          jax.random.PRNGKey(0), BATCH)
    got = p_train(torch.from_numpy(noisy), torch.from_numpy(clean),
                  torch.Generator().manual_seed(0), BATCH)
    np.testing.assert_allclose(got["loss"], float(ref["loss"]), rtol=LOSS_TOL)
    assert state.step == int(jstate.step) == 1

    # The gradients each side's Adam took: the port's .grad, and JAX's from
    # its first moment, mu = (1 - b1) g after one step.
    to_port = FAMILIES[name][1]
    ref_grads = to_port({"params": jax.tree.map(lambda mu: np.asarray(mu) / 0.1,
                                                jstate.opt_state[0].mu)})
    ref_sd = to_port({"params": jstate.params, "batch_stats": jstate.batch_stats})
    params = dict(state.model.named_parameters())
    bars = chip_smoke.step_bars({k: p.grad for k, p in params.items()}, ref_grads,
                                {k: p.detach() for k, p in params.items()}, ref_sd)
    assert bars["ok"], chip_smoke.describe_bars(bars)
    for key, val in state.model.state_dict().items():
        if key.endswith(STATS):
            np.testing.assert_allclose(val.numpy(), ref_sd[key].numpy(), atol=STATS_TOL,
                                       rtol=0, err_msg=key)


def test_unet_serves_other_lengths_as_jax_does():
    """Denoiser windows and denoise_record at length 512 (UNet takes any
    multiple of 16) against the JAX package's Denoiser on the same
    weights; warmup at that length."""
    from ecg_denoise_tpu.serving import Denoiser as JaxDenoiser
    from ecg_denoise_tpu_torch.serving import Denoiser

    jm, v, pm = _pair("unet", seed=6, length=512)
    port = Denoiser(pm, max_batch=4, device="cpu")
    port.warmup(length=512, limit=2)
    ref = JaxDenoiser(jm, v, max_batch=4)
    assert port.channels == ref.channels == 2
    x = _x(3, 2, 512, seed=7)
    np.testing.assert_allclose(port(x), ref(x), atol=ATOL, rtol=0)
    record = _x(2, 1500, seed=8)
    got = port.denoise_record(record, stride=200, length=512)
    assert got.shape == record.shape
    np.testing.assert_allclose(got, ref.denoise_record(record, stride=200, length=512),
                               atol=ATOL, rtol=0)
    stream = port.streaming(stride=200, length=512)
    pieces = [stream.push(record[:, i:i + 400]) for i in range(0, 1500, 400)]
    np.testing.assert_allclose(np.concatenate(pieces + [stream.flush()], axis=1), got,
                               atol=1e-5, rtol=0)


def test_ralenet_refuses_a_length_it_cannot_take():
    """RA-LENet's biases are built for 256 samples: a 512-sample record
    raises in the port, as the JAX model raises."""
    from ecg_denoise_tpu.models.ralenet import RaleNet as JaxRaleNet
    from ecg_denoise_tpu_torch.serving import Denoiser

    port = Denoiser(build_model("ralenet", device="cpu"), max_batch=2, device="cpu")
    with pytest.raises(ValueError, match=r"bias must be \(1, 2, 512, 512\), got "
                                         r"\(1, 2, 256, 256\)"):
        port.denoise_record(_x(2, 600), length=512)
    jm = JaxRaleNet(depth=1)
    with pytest.raises(Exception):
        jax.eval_shape(jm.init, jax.random.PRNGKey(0), jnp.zeros((1, 2, 512)))


def _write_cache(path, n, channels=2):
    noisy, clean = _noisy_clean(n, seed=6, channels=channels)
    os.makedirs(path / "m4")
    np.save(path / "ecg.npy", clean)
    np.save(path / "m4" / "bw.npy", noisy)


@pytest.mark.parametrize("argv,name", [([], "unet"), (["--model_index", "1"], "DANet"),
                                       (["--model_index", "5"], "ACDAE")])
def test_cli_trains_the_families(monkeypatch, tmp_path, capsys, argv, name):
    """`cli.main` with no --model_index trains UNet, and 1 and 5 train
    DANet and ACDAE, rehearsed on the CPU: the run reaches fit, `--r_pos
    detect` is printed and ignored, as on the JAX side, and the run writes
    its checkpoint and result line."""
    import ecg_denoise_tpu_torch
    from ecg_denoise_tpu_torch import train
    from ecg_denoise_tpu_torch.cli.main import main

    monkeypatch.setattr(ecg_denoise_tpu_torch, "default_device",
                        lambda: torch.device("cpu"))
    seen = {}
    real_fit = train.fit

    def spy(model, *args, **kw):
        seen.update(kw, model=model)
        return real_fit(model, *args, **kw)

    monkeypatch.setattr(train, "fit", spy)
    _write_cache(tmp_path / "dict_data", 10)
    main(argv + ["--dtype", "float32", "--n_select", "10", "--epochs", "10",
                 "--batch_size", "4", "--r_pos", "detect",
                 "--data_path", str(tmp_path / "dict_data"),
                 "--model_save_dir", str(tmp_path / "model_save"),
                 "--output_file", str(tmp_path / "output.txt")])
    assert type(seen["model"]).__name__ == {"unet": "UNet", "DANet": "Seq2Seq2",
                                            "ACDAE": "ACDAE"}[name]
    assert seen["r_pos_mode"] is None and seen["device"].type == "cpu"
    assert f"ignored for {name}" in capsys.readouterr().out
    assert (tmp_path / "output.txt").read_text().startswith(f"{name}_9_bw_intensity-4:")
    assert (tmp_path / "model_save" / name / f"{name}_9_bw_intensity-4.pth").exists()
