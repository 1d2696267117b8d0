"""The port's 12-lead transfer path (NewRale on a frozen RA-LENet core)
against the JAX package's, on the CPU.

NewRale at its own widths, its RA-LENet 'full' core at depth 2 (the JAX
module fixes it). Weights go both ways: random numpy variables of the JAX
model reach the port through `interop.jax_weights.newrale_state_dict`,
and a port module's weights reach the JAX model through the JAX package's
`newrale_variables`. The frozen step is held against JAX's
`create_train_state(frozen_mask=frozen_param_mask(...))`: the core
unchanged bit for bit on both sides, its BatchNorms in eval mode, the
adapters within 1e-4, the loss within 1e-5 relative. Eval output 1e-4
(the bar of tests/test_torch_parity.py). The 12-lead data is synthetic,
written in the dict_data layout.
"""

import os

import numpy as np
import pytest
import torch
torch.set_num_threads(1)  # six test workers share the host's cores: one intra-op thread each
import jax
import jax.numpy as jnp

from ecg_denoise_tpu.interop.torch_weights import newrale_variables
from ecg_denoise_tpu.models import NewRale as JaxNewRale
from ecg_denoise_tpu.models.ralenet_12leads import frozen_param_mask
from ecg_denoise_tpu.train import create_train_state as jax_train_state
from ecg_denoise_tpu.train import make_epoch_fns as jax_epoch_fns
from ecg_denoise_tpu_torch.interop.jax_weights import newrale_state_dict
from ecg_denoise_tpu_torch.models import build_model
from ecg_denoise_tpu_torch.models.ralenet_12leads import NewRale
from ecg_denoise_tpu_torch.serving import Denoiser
from ecg_denoise_tpu_torch.train import create_train_state, make_epoch_fns, save_checkpoint
from test_torch_port_layers import random_variables

ATOL = 1e-4
LOSS_TOL = 1e-5
PARAM_TOL = 1e-4
BATCH = 2


def _windows(n, seed=0):
    """Noisy and clean (n, 12, 256) float32 windows: sines plus noise."""
    rng = np.random.default_rng(seed)
    t = np.linspace(0, 6 * np.pi, 256)
    clean = np.sin(t + rng.uniform(0, 6, (n, 12, 1)))
    noisy = clean + 0.5 * rng.standard_normal(clean.shape)
    return noisy.astype(np.float32), clean.astype(np.float32)


@pytest.fixture(scope="module")
def pair():
    """The JAX NewRale, random variables of it (nonzero rel-pos tables and
    BN stats), and the port's NewRale with the same weights."""
    jm = JaxNewRale()
    v = random_variables(jm, jnp.zeros((2, 12, 256)), seed=1)
    pm = NewRale()
    pm.load_state_dict(newrale_state_dict(v))
    return jm, v, pm


def test_forward_matches_jax_both_ways(pair):
    jm, v, pm = pair
    run = jax.jit(lambda v, x: jm.apply(v, x, train=False))
    x = _windows(2, seed=2)[0]
    with torch.no_grad():
        y = pm.eval()(torch.from_numpy(x)).numpy()
    assert y.shape == x.shape
    np.testing.assert_allclose(y, np.asarray(run(v, x)), atol=ATOL, rtol=0)
    variables = newrale_variables(pm)
    sd = newrale_state_dict(variables)
    assert sd.keys() == pm.state_dict().keys()
    for key, val in pm.state_dict().items():
        torch.testing.assert_close(sd[key], val, atol=0, rtol=0, msg=key)
    np.testing.assert_allclose(y, np.asarray(run(variables, x)), atol=ATOL, rtol=0)


def test_frozen_step_matches_jax(pair):
    """One Adam step with the core frozen, against JAX's multi_transform
    with set_to_zero on the core: the core's parameters and BN running
    stats unchanged bit for bit on both sides, the adapters within 1e-4,
    the loss within 1e-5."""
    jm, v, _ = pair
    pm = NewRale()
    pm.load_state_dict(newrale_state_dict(v))
    before = {k: t.clone() for k, t in pm.state_dict().items()}
    jstate, tx = jax_train_state(jm, jax.random.PRNGKey(0), jnp.zeros((2, 12, 256)),
                                 frozen_mask=frozen_param_mask(v["params"]), variables=v)
    j_train, _ = jax_epoch_fns(jm, tx, donate=False)
    state = create_train_state(pm, device="cpu", frozen=pm.frozen_parameters())
    p_train, _ = make_epoch_fns(state.model, state.optimizer)
    noisy, clean = _windows(BATCH, seed=3)
    jstate, ref = j_train(jstate, jnp.asarray(noisy), jnp.asarray(clean),
                          jax.random.PRNGKey(0), BATCH)
    got = p_train(torch.from_numpy(noisy), torch.from_numpy(clean),
                  torch.Generator().manual_seed(0), BATCH)
    np.testing.assert_allclose(got["loss"], float(ref["loss"]), rtol=LOSS_TOL)
    assert state.step == int(jstate.step) == 1
    ref_sd = newrale_state_dict({"params": jstate.params, "batch_stats": jstate.batch_stats})
    after = state.model.state_dict()
    for key in after:
        if key.startswith("rale."):
            assert torch.equal(after[key], before[key]), key
            if not key.endswith("num_batches_tracked"):
                assert torch.equal(ref_sd[key], before[key]), key
        else:
            assert not torch.equal(after[key], before[key]), key
            np.testing.assert_allclose(after[key].numpy(), ref_sd[key].numpy(),
                                       atol=PARAM_TOL, rtol=0, err_msg=key)


def test_train_keeps_the_core_in_eval():
    m = NewRale().train()
    assert m.training and m.conv1.training and m.conv4.training
    assert not any(mod.training for mod in m.rale.modules())
    m.eval()
    assert not m.training and not m.conv1.training
    assert m.train(True) is m and not m.rale.training


def test_create_train_state_freezes_by_name():
    m = build_model("newrale", device="cpu")
    frozen = m.frozen_parameters()
    assert frozen == {n for n, _ in m.named_parameters() if n.startswith("rale.")}
    state = create_train_state(m, device="cpu", frozen=frozen)
    trained = {id(p) for g in state.optimizer.param_groups for p in g["params"]}
    for name, p in m.named_parameters():
        assert p.requires_grad == (name not in frozen)
        assert (id(p) in trained) == (name not in frozen)
    assert len(trained) == 8  # conv1..conv4, weight and bias
    with pytest.raises(ValueError, match="no parameters named"):
        create_train_state(NewRale(), device="cpu", frozen={"rale.nope"})


def test_denoiser_serves_twelve_leads(tmp_path):
    """A NewRale checkpoint served: (N, 12, 256) windows and a (12, T)
    record, the buckets warmed at 12 channels, equal to the model."""
    torch.manual_seed(4)
    model = build_model("newrale", device="cpu")
    state = create_train_state(model, device="cpu", frozen=model.frozen_parameters())
    path = save_checkpoint(str(tmp_path / "newrale_9_bw_intensity-4.pth"), state)
    d = Denoiser.from_checkpoint("newrale", path, max_batch=4, device="cpu")
    assert d.channels == 12 and d.inference_path == "torch+attn-plain:cpu"
    d.warmup()
    x = _windows(3, seed=5)[0]
    with torch.no_grad():
        ref = model.eval()(torch.from_numpy(x)).numpy()
    np.testing.assert_allclose(d(x), ref, atol=1e-5, rtol=0)
    record = _windows(1, seed=6)[0][0].repeat(2, axis=1)[:, :400]
    assert d.denoise_record(record).shape == (12, 400)


def test_serve_cli_serves_newrale(monkeypatch, tmp_path):
    import ecg_denoise_tpu_torch
    from ecg_denoise_tpu_torch.cli.serve import build

    monkeypatch.setattr(ecg_denoise_tpu_torch, "default_device",
                        lambda: torch.device("cpu"))
    torch.manual_seed(5)
    path = tmp_path / "newrale.pt"
    torch.save(build_model("newrale", device="cpu").state_dict(), path)
    server, d = build(["--model", "newrale", "--ckpt", str(path), "--port", "0",
                       "--max_batch", "2", "--warmup_max", "2"])
    server.server_close()
    assert isinstance(d.model, NewRale) and d.channels == 12


def _write_cache(path, n):
    noisy, clean = _windows(n, seed=7)
    os.makedirs(path / "m4")
    np.save(path / "ecg.npy", clean)
    np.save(path / "m4" / "bw.npy", noisy)


@pytest.mark.parametrize("with_core", [True, False])
def test_transfer_cli_reaches_fit(monkeypatch, tmp_path, capsys, with_core):
    """`cli.transfer_learning`, rehearsed on the CPU: the full 12-lead
    cache split 80/20 by the seed, the core loaded from --core_ckpt (a
    port RA-LENet training checkpoint) or, with none, the JAX CLI's
    warning; fit gets the core's names as its frozen mask, and the core
    comes out of training as it went in."""
    import ecg_denoise_tpu_torch
    from ecg_denoise_tpu_torch import train
    from ecg_denoise_tpu_torch.cli.transfer_learning import main

    monkeypatch.setattr(ecg_denoise_tpu_torch, "default_device",
                        lambda: torch.device("cpu"))
    seen = {}
    real_fit = train.fit

    def spy(model, tr_n, tr_c, te_n, te_c, **kw):
        seen.update(kw, n=(len(tr_n), len(te_n)),
                    core={k: t.clone() for k, t in model.rale.state_dict().items()})
        result = real_fit(model, tr_n, tr_c, te_n, te_c, **kw)
        seen["core_after"] = model.rale.state_dict()
        return result

    monkeypatch.setattr(train, "fit", spy)
    _write_cache(tmp_path / "ext", 10)
    argv = ["--dtype", "float32", "--epochs", "1", "--batch_size", "4",
            "--external_path", str(tmp_path / "ext"),
            "--model_save_dir", str(tmp_path / "model_save"),
            "--output_file", str(tmp_path / "output.txt")]
    core = None
    if with_core:
        torch.manual_seed(8)
        core = build_model("ralenet", device="cpu")
        path = save_checkpoint(str(tmp_path / "core.pth"),
                               create_train_state(core, device="cpu"))
        argv += ["--core_ckpt", path]
    main(argv)
    out = capsys.readouterr().out
    assert ("loaded frozen core" in out) == with_core
    assert ("WARNING: no pretrained ralenet checkpoint found" in out) != with_core
    assert seen["n"] == (8, 2) and seen["model_name"] == "newrale"
    assert seen["frozen_mask"] == {f"rale.{n}" for n, _ in
                                   build_model("ralenet", device="cpu").named_parameters()}
    for key, val in seen["core"].items():
        assert torch.equal(seen["core_after"][key], val), key
        if with_core:
            assert torch.equal(core.state_dict()[key], val), key
    assert (tmp_path / "output.txt").read_text().startswith("newrale_0_bw_intensity-4:")
