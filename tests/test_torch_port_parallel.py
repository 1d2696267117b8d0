"""The port's data parallelism against the single process and the JAX
package's 2-device mesh, on the CPU.

Two gloo processes (`torch.multiprocessing.spawn`, joined through a file
store under tmp_path) run every data-parallel case once, in one spawn
(`test_torch_port_parallel_ranks.run_ranks`); the tests here read what
each rank wrote. The references are the port in this process, without a
mesh, and the JAX package on two of the 8 virtual CPU devices of
tests/conftest.py (`make_mesh(n_data=2)`, the plain path). Weights are
random numpy variables of the JAX model, mapped into the port
(`interop.jax_weights`), and the inputs come from numpy seeds.

Cases: one RA-LENet 'full' step at depth 1, f32, global batch 8 (4 a
rank), without and with `--r_pos detect`; one UNet epoch through
`fit(mesh=...)` (JAX's `test_dp_matches_single_device`), from random
weights, resumed from the JAX fixture, and on each rank's
`process_shard` (`--multihost`'s feeding), with a ragged eval batch;
`BatchNorm1d` on different data on each rank; `multihost`'s indices and
`initialize`; `Denoiser(n_data=2)` and `cli.serve --n_data`; `cli.main
--n_data 1` and `--multihost` rehearsed on the CPU.

Bars (`__graft_entry__.py:120-129`): loss 1e-5 relative, BN running stats
1e-5, parameters 1e-4, the parameters and gradients by
`chip_smoke.step_bars` (where a gradient sits at the rounding floor, as
UNet's biases before a training-mode BatchNorm do, Adam's first step
moves the parameter by lr times the sign of a rounding, and two ranks sum
in another order than one process); the eval means as the loss, SNR 1e-4
absolute.
"""

import functools
import json

import numpy as np
import pytest
import torch
torch.set_num_threads(1)  # six test workers share the host's cores: one intra-op thread each
import torch.distributed as dist
import jax
import jax.numpy as jnp
import optax

from ecg_denoise_tpu.interop.torch_weights import unet_variables as jax_unet_variables
from ecg_denoise_tpu.models import UNet as JaxUNet
from ecg_denoise_tpu.models.ralenet import RaleNet as JaxRaleNet
from ecg_denoise_tpu.parallel import make_mesh as jax_make_mesh
from ecg_denoise_tpu.parallel import multihost as jax_multihost
from ecg_denoise_tpu.parallel.mesh import replicate_state as jax_replicate
from ecg_denoise_tpu.parallel.mesh import shard_batch as jax_shard_batch
from ecg_denoise_tpu.serving import Denoiser as JaxDenoiser
from ecg_denoise_tpu.serving import _bucket as jax_bucket
from ecg_denoise_tpu.train import create_train_state as jax_train_state
from ecg_denoise_tpu.train import make_epoch_fns as jax_epoch_fns
from ecg_denoise_tpu.train.checkpoint import load_checkpoint as jax_load_checkpoint
from ecg_denoise_tpu_torch.interop.jax_weights import ralenet_state_dict, unet_state_dict
from ecg_denoise_tpu_torch.models import build_model
from ecg_denoise_tpu_torch.models.ralenet import RaleNet
from ecg_denoise_tpu_torch.parallel import multihost
from ecg_denoise_tpu_torch.serving import Denoiser, _bucket
from ecg_denoise_tpu_torch.train import create_train_state, fit, make_epoch_fns
from test_torch_port_layers import random_variables
from test_torch_port_parallel_ranks import (
    BN_CASES,
    FIXTURE_CKPT,
    RALENET_BATCH,
    UNET_BATCH,
    UNET_CASES,
    WORLD,
    beats,
    bn_input,
    bn_layer,
    resume_path,
    run_ranks,
    sines,
    unet_splits,
)

LOSS_TOL = 1e-5
PARAM_TOL = 1e-4
STATS_TOL = 1e-5
SNR_TOL = 1e-4
STATS = ("running_mean", "running_var")
RALENET_CASES = {"plain": (3, sines, 11, False), "rpos": (7, beats, 12, True)}


def _jax_ralenet():
    return JaxRaleNet(variant="full", depth=1)


def _ralenet_variables(case):
    return random_variables(_jax_ralenet(), jnp.zeros((2, 2, 256)),
                            seed=RALENET_CASES[case][0])


def _unet_variables():
    return random_variables(JaxUNet(), jnp.zeros((2, 2, 256)), seed=4)


@pytest.fixture(scope="module")
def ranks(tmp_path_factory):
    """What each of the two ranks wrote, after one spawn of both."""
    workdir = tmp_path_factory.mktemp("dp")
    for case in RALENET_CASES:
        name = "ralenet" if case == "plain" else "ralenet_rpos"
        torch.save(ralenet_state_dict(_ralenet_variables(case), "full"),
                   workdir / f"{name}.pt")
    torch.save(unet_state_dict(_unet_variables()), workdir / "unet.pt")
    torch.multiprocessing.spawn(run_ranks, args=(str(workdir / "store"), str(workdir)),
                                nprocs=WORLD)
    return workdir, [torch.load(workdir / f"rank{r}.pt") for r in range(WORLD)]


def _jax_mesh():
    return jax_make_mesh(n_data=WORLD, n_model=1, devices=jax.devices()[:WORLD])


@functools.cache
def _jax_epochs(jm, detect=False):
    """JAX's (train_epoch, eval_epoch) of model `jm` with its `fit`'s
    optimizer (`optax.adam(1e-3)`, `create_train_state`'s), made once, so
    each compiles once for the file."""
    return jax_epoch_fns(jm, optax.adam(1e-3), donate=False, detect_r_pos=detect)


def _jax_dp_train(jm, variables, noisy, clean, batch_size, detect=False, state=None):
    """JAX's train epoch on a 2-device data mesh, from `variables` or
    `state`: (state, metrics)."""
    mesh = _jax_mesh()
    template, _ = jax_train_state(jm, jax.random.PRNGKey(0), jnp.zeros((2, 2, 256)),
                                  variables=variables)
    train_epoch, _ = _jax_epochs(jm, detect)
    with mesh:
        st = jax_replicate(state if state is not None else template, mesh)
        noisy, clean = (jax_shard_batch(jnp.asarray(a), mesh) for a in (noisy, clean))
        st, metrics = train_epoch(st, noisy, clean, jax.random.PRNGKey(1), batch_size)
    return st, jax.device_get(metrics)


def _jax_dp_eval(jm, variables, noisy, clean, batch_size):
    """JAX's eval epoch of `variables` on a 2-device data mesh."""
    mesh = _jax_mesh()
    state, _ = jax_train_state(jm, jax.random.PRNGKey(0), jnp.zeros((2, 2, 256)),
                               variables=variables)
    _, eval_epoch = _jax_epochs(jm)
    with mesh:
        state = jax_replicate(state, mesh)
        noisy, clean = (jax_shard_batch(jnp.asarray(a), mesh) for a in (noisy, clean))
        return jax.device_get(eval_epoch(state, noisy, clean, batch_size))


def _assert_ranks_agree(results):
    """Every rank stepped identically: the same state, bit for bit."""
    for key, val in results[0]["state"].items():
        assert torch.equal(val, results[1]["state"][key]), key


def _assert_stats_close(state, ref):
    for key, val in state.items():
        if key.endswith(STATS):
            np.testing.assert_allclose(val.numpy(), ref[key].numpy(), atol=STATS_TOL,
                                       rtol=0, err_msg=key)


def _assert_bars(result, ref_grads, ref_state):
    """`chip_smoke.step_bars` on the rank's gradients and parameters."""
    import chip_smoke

    grads = result["grads"]
    bars = chip_smoke.step_bars(grads, ref_grads, {k: result["state"][k] for k in grads},
                                ref_state)
    assert bars["ok"], chip_smoke.describe_bars(bars)


@pytest.mark.parametrize("case", list(RALENET_CASES))
def test_dp_ralenet_step_matches_the_single_process_and_jax(ranks, case):
    """One RA-LENet step at global batch 8 over two ranks (with `--r_pos
    detect`: each rank detects its own windows' R peaks) against the port's
    step on the whole batch in one process and against JAX's step on a
    2-device data mesh: loss 1e-5 relative, BN stats 1e-5, gradients and
    params by `step_bars` (an element whose gradient sits at the rounding
    floor moves by lr times the sign of a rounding in Adam's first step,
    and the summation order differs between one process and two)."""
    _, results = ranks
    key = "ralenet" if case == "plain" else "ralenet_rpos"
    dp = [r[key] for r in results]
    _assert_ranks_agree(dp)
    assert dp[0]["step"] == 1 and dp[0]["metrics"] == dp[1]["metrics"]

    _, make, seed, detect = RALENET_CASES[case]
    variables = _ralenet_variables(case)
    noisy, clean = make(RALENET_BATCH, seed=seed)
    model = RaleNet(variant="full", depth=1)
    model.load_state_dict(ralenet_state_dict(variables, "full"))
    single = create_train_state(model, device="cpu")
    train_epoch, _ = make_epoch_fns(single.model, single.optimizer, detect_r_pos=detect)
    ref = train_epoch(torch.from_numpy(noisy), torch.from_numpy(clean),
                      torch.Generator().manual_seed(0), RALENET_BATCH)
    jstate, jref = _jax_dp_train(_jax_ralenet(), variables, noisy, clean, RALENET_BATCH,
                                 detect)
    jax_sd = ralenet_state_dict({"params": jstate.params,
                                 "batch_stats": jstate.batch_stats}, "full")
    jax_grads = ralenet_state_dict({"params": jax.tree.map(
        lambda mu: np.asarray(mu) / 0.1, jstate.opt_state[0].mu)}, "full")
    got = dp[0]["metrics"]
    for want in (ref, {k: float(v) for k, v in jref.items()}):
        np.testing.assert_allclose(got["loss"], want["loss"], rtol=LOSS_TOL)
        np.testing.assert_allclose(got["snr"], want["snr"], atol=SNR_TOL)
        np.testing.assert_allclose(got["rmse"], want["rmse"], rtol=LOSS_TOL)
    single_grads = {k: p.grad for k, p in single.model.named_parameters()
                    if p.grad is not None}
    for grads, state in ((single_grads, single.model.state_dict()), (jax_grads, jax_sd)):
        _assert_bars(dp[0], grads, state)
        _assert_stats_close(dp[0]["state"], state)


def _single_unet_fit(tmp_path, workdir, case):
    model = build_model("unet", device="cpu")
    model.load_state_dict(unet_state_dict(_unet_variables()))
    return fit(model, *unet_splits(), epochs=1, batch_size=UNET_BATCH,
               model_name="unet", model_save_dir=str(tmp_path / "model_save"),
               output_file=str(tmp_path / "output.txt"), checkpoint_every=1,
               resume_path=resume_path(str(workdir), case), verbose=False, device="cpu")


def _assert_means_close(snr, rmse, want):
    np.testing.assert_allclose(snr, float(want["snr"]), atol=SNR_TOL)
    np.testing.assert_allclose(rmse, float(want["rmse"]), rtol=LOSS_TOL)


@pytest.mark.parametrize("case", UNET_CASES)
def test_dp_unet_epoch_through_fit_matches_the_single_process(ranks, tmp_path, case):
    """One UNet epoch through `fit(mesh=...)`: one step on the 16 training
    windows (8 a rank) and an eval of 10 windows in one padded batch (the
    ragged tail split over the ranks), from random weights ("fit"), from the
    JAX fixture ("resume", Adam's second step), with each rank holding
    only its `process_shard` of the splits ("local"), and from the
    checkpoint rank 0 wrote in "fit" ("resume_dp").

    Against the single process's `fit` on the whole splits: the train SNR
    and RMSE (the step's own forward), the gradients and parameters
    (`step_bars`) and the BN stats. The eval is held on the weights the
    ranks hold (one process's eval would see other weights: Adam moves a
    UNet bias before a BatchNorm by lr times the sign of a rounding, and
    running-stat BatchNorm keeps that shift): its SNR and RMSE equal the
    single process's `eval_epoch` of those weights. Against JAX ("fit",
    "resume"): its train epoch on a 2-device mesh from the same start, and
    its eval epoch of the ranks' weights on that mesh."""
    workdir, results = ranks
    dp = [r[f"unet_{case}"] for r in results]
    _assert_ranks_agree(dp)
    assert dp[0]["lists"] == dp[1]["lists"]
    assert dp[0]["step"] == (2 if case.startswith("resume") else 1)
    train_snr, test_snr, train_rmse, test_rmse = (v for (v,) in dp[0]["lists"])
    state, lists = _single_unet_fit(tmp_path, workdir, case)
    _assert_means_close(train_snr, train_rmse, {"snr": lists[0][0], "rmse": lists[2][0]})
    params = dict(state.model.named_parameters())
    _assert_bars(dp[0], {k: p.grad for k, p in params.items()}, state.model.state_dict())
    _assert_stats_close(dp[0]["state"], state.model.state_dict())
    ranks_model = build_model("unet", device="cpu")
    ranks_model.load_state_dict(dp[0]["state"])
    held = create_train_state(ranks_model, device="cpu")
    _, eval_epoch = make_epoch_fns(held.model, held.optimizer)
    tn, tc = (torch.from_numpy(a) for a in unet_splits()[2:])
    _assert_means_close(test_snr, test_rmse, eval_epoch(tn, tc, UNET_BATCH))

    # Rank 0 alone wrote the result line and the checkpoint, and the
    # checkpoint loads into a model of one process.
    out = workdir / case
    lines = (out / "output.txt").read_text().splitlines()
    assert len(lines) == 1 and lines[0].startswith("unet_0_bw_intensity-4:snr:")
    ckpts = sorted((out / "model_save" / "unet").iterdir())
    assert [p.name for p in ckpts] == ["unet_0_bw_intensity-4.pth"]
    saved = torch.load(ckpts[0])["model"]
    assert not any(k.startswith("module.") for k in saved)
    served = Denoiser.from_checkpoint("unet", str(ckpts[0]), max_batch=4, device="cpu")
    for key, val in served.model.state_dict().items():
        assert torch.equal(val, dp[0]["state"][key]), key

    if case in ("local", "resume_dp"):
        return  # JAX's --multihost feeding needs several processes; a .pth is the port's
    splits = unet_splits()
    if case == "resume":
        template, _ = jax_train_state(JaxUNet(), jax.random.PRNGKey(0),
                                      jnp.zeros((2, 2, 256)))
        jstart = jax_load_checkpoint(FIXTURE_CKPT, template)
        mu1 = jax.tree.map(np.asarray, jstart.opt_state[0].mu)
        jstate, jtrain = _jax_dp_train(JaxUNet(), None, *splits[:2], UNET_BATCH,
                                       state=jstart)
    else:
        mu1 = None
        jstate, jtrain = _jax_dp_train(JaxUNet(), _unet_variables(), *splits[:2],
                                       UNET_BATCH)
    mu2 = jax.tree.map(np.asarray, jstate.opt_state[0].mu)
    # JAX's gradients from its first moments: mu_k = 0.9 mu_(k-1) + 0.1 g.
    jax_grads = unet_state_dict({"params": jax.tree.map(
        lambda a, b: (a - 0.9 * b) / 0.1, mu2, mu1) if mu1 is not None else
        jax.tree.map(lambda a: a / 0.1, mu2)})
    jax_sd = unet_state_dict({"params": jstate.params, "batch_stats": jstate.batch_stats})
    _assert_means_close(train_snr, train_rmse, jtrain)
    _assert_bars(dp[0], jax_grads, jax_sd)
    _assert_stats_close(dp[0]["state"], jax_sd)
    _assert_means_close(test_snr, test_rmse, _jax_dp_eval(
        JaxUNet(), jax_unet_variables(ranks_model), *splits[2:], UNET_BATCH))


@pytest.mark.parametrize("case", list(BN_CASES))
def test_batchnorm_takes_the_global_batch(ranks, case):
    """`BatchNorm1d` with different data on each rank ("2d": one value a
    channel on each, DANet's gates at batch 1 a rank) against the layer
    in one process on the ranks' batches together: the output 1e-5, the
    input's gradient and the affine parameters' gradients (summed over
    the ranks) 1e-5, the running stats 1e-5 on every rank; and the group
    is off the layer after the block."""
    _, results = ranks
    xs, gs = zip(*(bn_input(case, r) for r in range(WORLD)))
    x = torch.cat(xs).requires_grad_(True)
    bn = bn_layer()
    y = bn(x)
    (y * torch.cat(gs)).sum().backward()
    rows = xs[0].shape[0]
    for r, result in enumerate(r[f"bn_{case}"] for r in results):
        sl = slice(r * rows, (r + 1) * rows)
        torch.testing.assert_close(result["y"], y.detach()[sl], atol=1e-5, rtol=0)
        torch.testing.assert_close(result["x_grad"], x.grad[sl], atol=1e-5, rtol=0)
        torch.testing.assert_close(result["weight_grad"], bn.weight.grad, atol=1e-5, rtol=0)
        torch.testing.assert_close(result["bias_grad"], bn.bias.grad, atol=1e-5, rtol=0)
        for stat in STATS:
            torch.testing.assert_close(result[stat], getattr(bn, stat), atol=STATS_TOL,
                                       rtol=0)
        assert result["group_after"] is None


def test_the_ranks_mesh_and_their_default_shards(ranks):
    """Each rank's `make_mesh` describes the group, and `process_shard`
    reads its rank and world size from it: JAX's indices for that process."""
    _, results = ranks
    for r, result in enumerate(results):
        assert result["mesh"] == (WORLD, r, "cpu")
        want = jax_multihost.process_shard_indices(7, process_index=r, process_count=WORLD)
        assert result["shard_indices"] == want.tolist()


@pytest.mark.parametrize("n_total", [1, 3, 7, 8, 100, 101])
def test_process_shard_indices_match_jax(n_total):
    """Every (p, P) of P up to 8, p in and out of range, as JAX's: the same
    indices or the same error."""
    for P in range(1, 9):
        for p in range(-1, P + 1):
            try:
                want = jax_multihost.process_shard_indices(n_total, p, P)
            except ValueError as e:
                with pytest.raises(ValueError) as got:
                    multihost.process_shard_indices(n_total, p, P)
                assert str(got.value) == str(e)
                continue
            np.testing.assert_array_equal(multihost.process_shard_indices(n_total, p, P),
                                          want)
    assert multihost.process_shard_indices(n_total).tolist() == list(range(n_total))
    x, y = np.arange(2 * n_total).reshape(n_total, 2), np.arange(n_total)
    if n_total >= 3:
        for got, want in zip(multihost.process_shard(x, y, process_index=1, process_count=3),
                             jax_multihost.process_shard(x, y, process_index=1,
                                                         process_count=3)):
            np.testing.assert_array_equal(got, want)


def test_initialize_is_a_no_op_without_a_launcher(monkeypatch):
    for var in ("MASTER_ADDR", "MASTER_PORT", "WORLD_SIZE", "RANK", "LOCAL_RANK"):
        monkeypatch.delenv(var, raising=False)
    assert multihost.initialize() is False
    assert multihost.initialize("localhost:1234", num_processes=1) is False
    monkeypatch.setenv("WORLD_SIZE", "1")
    monkeypatch.setenv("MASTER_ADDR", "localhost")
    assert multihost.initialize() is False and not multihost.launched()
    assert not dist.is_initialized()


def _unet_denoiser_pair(n_data, max_batch):
    model = build_model("unet", device="cpu")
    model.load_state_dict(unet_state_dict(_unet_variables()))
    return Denoiser(model, max_batch=max_batch, device="cpu", n_data=n_data,
                    devices=["cpu"] * n_data)


def test_denoiser_on_two_replicas_matches_jax_buckets_and_one_replica():
    """`Denoiser(n_data=2, devices=["cpu", "cpu"])`: JAX's bucket floor,
    max_batch and `+dp2` path on a 2-device mesh, outputs within 1e-6 of
    one replica's (requests of 1, 3, 37 windows, a record and a stream);
    n_data=3 raises JAX's error."""
    jmesh = jax_make_mesh(n_data=WORLD, n_model=1, devices=jax.devices()[:WORLD])
    jd = JaxDenoiser(JaxUNet(), _unet_variables(), max_batch=1, mesh=jmesh)
    one, two = _unet_denoiser_pair(1, 1), _unet_denoiser_pair(2, 1)
    assert two.max_batch == jd.max_batch == 2
    assert two.inference_path == "torch+dp2:cpu" and jd.inference_path.endswith("+dp2:cpu")
    one, two = _unet_denoiser_pair(1, 64), _unet_denoiser_pair(2, 64)
    assert len(two.replicas) == 2 and two.replicas[1][0] is not two.model
    for n in range(1, 70):
        assert _bucket(n, two.max_batch, two.n_data) == jax_bucket(n, 64, jd._bucket_floor)
    rng = np.random.default_rng(5)
    for n in (1, 3, 37):
        x = rng.standard_normal((n, 2, 256)).astype(np.float32)
        np.testing.assert_allclose(two(x), one(x), atol=1e-6, rtol=0)
    assert sorted(two._staging) == [2, 4, 64]
    record = rng.standard_normal((2, 1000)).astype(np.float32)
    np.testing.assert_allclose(two.denoise_record(record), one.denoise_record(record),
                               atol=1e-6, rtol=0)
    streams = [d.streaming() for d in (one, two)]
    got = [np.concatenate([s.push(record[:, :700]), s.push(record[:, 700:]), s.flush()],
                          axis=1) for s in streams]
    np.testing.assert_allclose(got[1], got[0], atol=1e-6, rtol=0)
    with pytest.raises(ValueError) as jax_error:
        JaxDenoiser(JaxUNet(), _unet_variables(),
                    mesh=jax_make_mesh(n_data=3, n_model=1, devices=jax.devices()[:3]))
    with pytest.raises(ValueError) as port_error:
        Denoiser(build_model("unet", device="cpu"), device="cpu", n_data=3)
    assert str(port_error.value) == str(jax_error.value)


def test_cli_serve_takes_n_data(monkeypatch, tmp_path):
    """`cli.serve --n_data 2` (rehearsed on the CPU: two CPU replicas)
    serves through `Denoiser(n_data=2)`; without the flag, one replica."""
    import ecg_denoise_tpu_torch
    from ecg_denoise_tpu_torch.cli.serve import build

    monkeypatch.setattr(ecg_denoise_tpu_torch, "default_device", lambda: torch.device("cpu"))
    path = str(tmp_path / "unet.pth")
    torch.save(unet_state_dict(_unet_variables()), path)
    for argv, n in (([], 1), (["--n_data", "2"], 2)):
        server, denoiser = build(["--model", "unet", "--ckpt", path, "--port", "0", *argv])
        server.server_close()
        assert denoiser.n_data == len(denoiser.replicas) == n
        assert denoiser.inference_path == ("torch:cpu" if n == 1 else "torch+dp2:cpu")


@pytest.mark.parametrize("argv", [["--n_data", "1"], ["--multihost"]])
def test_cli_main_data_parallel_flags(monkeypatch, tmp_path, capsys, argv):
    """`cli.main --n_data 1` (a process group of one, gloo on the CPU) and
    `--multihost` with no launcher (single process, JAX's message),
    rehearsed on the CPU: one result line and one train_log.jsonl record;
    the group is gone after; `--n_data 2` asks for two cards and names the
    count it sees."""
    import ecg_denoise_tpu_torch
    import chip_smoke
    from ecg_denoise_tpu_torch.cli.main import main

    monkeypatch.setattr(ecg_denoise_tpu_torch, "default_device", lambda: torch.device("cpu"))
    monkeypatch.chdir(tmp_path)
    for var in ("MASTER_ADDR", "WORLD_SIZE", "RANK"):
        monkeypatch.delenv(var, raising=False)
    chip_smoke.write_dict_data(str(tmp_path / "dict_data"), 40, seed=7)
    main(["--dtype", "float32", "--n_select", "40", "--epochs", "1", "--batch_size", "16",
          "--data_path", str(tmp_path / "dict_data"), *argv])
    printed = capsys.readouterr().out
    assert ("multihost: distributed=off (single process)" in printed) == (argv == ["--multihost"])
    assert len((tmp_path / "output.txt").read_text().splitlines()) == 1
    record = json.loads((tmp_path / "train_log.jsonl").read_text())
    assert record["fn"] == "fit" and record["status"] == "ok" and record["kwargs"]["epochs"] == 1
    assert not dist.is_initialized()
    with pytest.raises(RuntimeError, match="--n_data 2 needs 2 cards, but 0 are visible"):
        main(["--n_data", "2", "--data_path", str(tmp_path / "dict_data")])
