"""The port's tensor parallelism against the single process and the JAX
package's single-device step, on the CPU.

Four gloo processes on a (n_data, n_model) = (2, 2) grid, JAX's DPxTP
test's grid (`tests/test_mesh.py`), run every multi-rank case once, in one
spawn (`test_torch_port_tensor_parallel_ranks.run_ranks`); the tests here
read what each rank wrote. The references are the port in this process,
without a mesh, and JAX's single-device step on the same numpy weights
(`interop.jax_weights`), which `tests/test_mesh.py` already holds equal to
JAX's own DPxTP step. All at depth 1, f32 but one bf16 forward.

Cases: `tp_param_spec` against JAX's on every parameter of seven models
(shapes by `jax.eval_shape`, no compile); the grid's rank layout against
JAX's `make_mesh`; one RA-LENet 'full' step at a global batch of 8 without
and with `--r_pos detect`; its gathered Adam moments; a checkpoint written
under the grid, loaded by one process and resumed under the grid; NewRale
with its frozen core sharded; a bf16 forward; an eval epoch with a ragged
last batch.

Bars: the gathered gradients 1e-5 absolute of the single process's (the
bar JAX's SGD(0.1) test puts on the parameters is 1e-6, a tenth of a
gradient's); loss 1e-5 relative, BN stats 1e-5, parameters 1e-4
(`chip_smoke.step_bars`, whose rounding-floor rule holds an element whose
gradient is at the floor to the floor instead); the bf16 forward
3 * 2^-8 of max|out|; the eval's SNR 1e-4 absolute.
"""

import functools
import json

import chip_smoke
import numpy as np
import pytest
import torch
torch.set_num_threads(1)  # six test workers share the host's cores: one intra-op thread each
import jax
import jax.numpy as jnp
import optax

from ecg_denoise_tpu.models import build_model as jax_build_model
from ecg_denoise_tpu.models.ralenet import RaleNet as JaxRaleNet
from ecg_denoise_tpu.parallel import make_mesh as jax_make_mesh
from ecg_denoise_tpu.parallel.mesh import tp_param_spec as jax_tp_param_spec
from ecg_denoise_tpu.train import create_train_state as jax_train_state
from ecg_denoise_tpu.train import make_epoch_fns as jax_epoch_fns
from ecg_denoise_tpu_torch.interop.jax_weights import ralenet_state_dict, state_dict_for
from ecg_denoise_tpu_torch.models import NewRale, build_model
from ecg_denoise_tpu_torch.models.ralenet import RaleNet
from ecg_denoise_tpu_torch.parallel import Mesh, tp_param_specs
from ecg_denoise_tpu_torch.train import create_train_state, fit, load_checkpoint, make_epoch_fns
from ecg_denoise_tpu_torch.train.checkpoint import load_model_weights
from test_torch_port_layers import random_variables
from test_torch_port_tensor_parallel_ranks import (
    BATCH,
    BF16_WINDOWS,
    CLI_ARGV,
    CLI_WINDOWS,
    EVAL_WINDOWS,
    N_DATA,
    N_MODEL,
    STEP_CASES,
    WORLD,
    checkpoint_of,
    fit_kwargs,
    fit_splits,
    newrale_data,
    ralenet,
    run_ranks,
    sines,
)

GRAD_TOL = 1e-5
LOSS_TOL = 1e-5
STATS_TOL = 1e-5
SNR_TOL = 1e-4
BF16_TOL_OF_MAX = 3 * 2 ** -8
STATS = ("running_mean", "running_var")
WEIGHT_SEEDS = {"plain": 3, "rpos": 7, "fit": 5}
SPEC_MODELS = ["ralenet", "ralenet_nra", "ralenet_mlp", "newrale", "unet", "DANet", "ACDAE"]


def _variables(case):
    return random_variables(JaxRaleNet(variant="full", depth=1), jnp.zeros((2, 2, 256)),
                            seed=WEIGHT_SEEDS[case])


@pytest.fixture(scope="module")
def ranks(tmp_path_factory):
    """What each of the four ranks wrote, after one spawn of them all."""
    workdir = tmp_path_factory.mktemp("tp")
    for case in STEP_CASES:
        torch.save(ralenet_state_dict(_variables(case), "full"), workdir / f"ralenet_{case}.pt")
    torch.save(ralenet_state_dict(_variables("fit"), "full"), workdir / "ralenet.pt")
    torch.manual_seed(9)
    newrale = NewRale()
    with torch.no_grad():  # nonzero rel-pos tables in the frozen core
        for name, p in newrale.named_parameters():
            if name.endswith("relative_position_bias_table"):
                p.normal_()
    torch.save(newrale.state_dict(), workdir / "newrale.pt")
    chip_smoke.write_dict_data(str(workdir / "dict_data"), CLI_WINDOWS, seed=7)
    torch.multiprocessing.spawn(run_ranks, args=(str(workdir / "store"), str(workdir)),
                                nprocs=WORLD)
    return workdir, [torch.load(workdir / f"rank{r}.pt") for r in range(WORLD)]


# --- the sharding rule and the grid -----------------------------------------

# JAX's PartitionSpecs as the port's sharded axis: a kernel (in, out) on its
# outputs is a Linear weight (out, in) on axis 0, a bias on axis 0, a
# kernel on its inputs a weight on axis 1.
_JAX_SPEC_AXIS = {(): -1, (None, "model"): 0, ("model",): 0, ("model", None): 1}


def _jax_axes(name, n_model):
    """{port parameter name: JAX's sharded axis (None: replicated)} for the
    JAX model `name`, through the port's own weight map."""
    jm = jax_build_model(name)
    x = jnp.zeros((2, 12 if name == "newrale" else 2, 256))
    shapes = jax.eval_shape(jm.init, jax.random.PRNGKey(0), x)
    codes = jax.tree_util.tree_map_with_path(
        lambda path, s: np.full(s.shape, _JAX_SPEC_AXIS[tuple(
            jax_tp_param_spec(path, s, n_model))], np.float32), shapes["params"])
    port = build_model(name, device="cpu")
    coded = state_dict_for(port, {"params": codes})
    axes = {}
    for key, _ in port.named_parameters():
        axis = int(coded[key].reshape(-1)[0])
        axes[key] = None if axis < 0 else axis
    return port, axes


def _port_axes(port, n_model):
    specs = tp_param_specs(port, n_model)
    return {k: specs.get(k) for k, _ in port.named_parameters()}


@pytest.mark.parametrize("name", SPEC_MODELS)
def test_tp_param_spec_shards_what_jax_shards(name):
    """At n_model = 2 every parameter of every model is sharded on the axis
    JAX shards it on (kernels transposed), or replicated where JAX
    replicates it: the conv stems, norms, `reduction`, rel-pos tables,
    `leconv`, `proj`'s bias, and every parameter of UNet, DANet and ACDAE."""
    port, want = _jax_axes(name, 2)
    got = _port_axes(port, 2)
    assert got == want
    sharded = {k for k, a in got.items() if a is not None}
    assert bool(sharded) == name.startswith(("ralenet", "newrale"))
    assert not any("relative_position" in k or "leconv" in k or "reduction" in k
                   for k in sharded)


def test_nra_at_depth_2_shards_jaxs_36_kernels():
    """JAX's count (`tests/test_mesh.py:43-65`): 9 BasicLayers x 2 blocks x
    (to_q + proj) weights."""
    specs = tp_param_specs(build_model("ralenet_nra", device="cpu"), 2)
    assert sum(k.endswith(("to_q.weight", "attn.proj.weight")) for k in specs) == 36
    assert sum(k.endswith("to_kv.weight") for k in specs) == 18


def test_at_n_model_4_only_the_head_aligned_rule_differs():
    """At n_model = 4 RA-LENet's 2-head stage (dtransformer1) has 8-wide
    projections that JAX splits four ways; the port shards whole heads, so
    it replicates that stage's attention, and only that."""
    port, want = _jax_axes("ralenet", 4)
    got = _port_axes(port, 4)
    differ = {k for k in got if got[k] != want[k]}
    two_heads = {f"{n}." for n, m in port.named_modules()
                 if hasattr(m, "qkv_proj") and m.num_heads % 4}
    assert two_heads == {f"dtransformer1.blocks.{i}.attn." for i in range(2)}
    assert differ == {k for k in got if k.startswith(tuple(two_heads)) and want[k] is not None}
    assert all(got[k] is None for k in differ) and len(differ) == 10


@pytest.mark.parametrize("n_data,n_model", [(1, 2), (2, 2), (4, 2), (2, 1)])
def test_grid_puts_each_rank_where_jax_puts_its_device(n_data, n_model):
    """Rank r at (r // n_model, r % n_model): JAX's
    `devices.reshape(n_data, n_model)`."""
    devices = jax.devices()[:n_data * n_model]
    grid = jax_make_mesh(n_data, n_model, devices=devices).devices
    for r, device in enumerate(devices):
        mesh = Mesh(n_data * n_model, r, torch.device("cpu"), None, n_model)
        d, m = (int(i[0]) for i in np.nonzero(grid == device))
        assert (mesh.data_rank, mesh.model_rank, mesh.n_data) == (d, m, n_data)


def test_the_ranks_grid(ranks):
    _, results = ranks
    for r, result in enumerate(results):
        assert result["mesh"] == (WORLD, r, N_DATA, r // N_MODEL, N_MODEL, r % N_MODEL)
        assert result["none_for_the_world"] == 1


# --- the step ---------------------------------------------------------------


@functools.cache
def _jax_train_epoch(detect):
    return jax_epoch_fns(JaxRaleNet(variant="full", depth=1), optax.adam(1e-3),
                         donate=False, detect_r_pos=detect)[0]


def _jax_step(case):
    """JAX's single-device step: (state_dict, gradients, metrics)."""
    make, seed, detect = STEP_CASES[case]
    variables = _variables(case)
    noisy, clean = make(BATCH, seed=seed)
    state, _ = jax_train_state(JaxRaleNet(variant="full", depth=1), jax.random.PRNGKey(0),
                               jnp.zeros((2, 2, 256)), variables=variables)
    state, metrics = _jax_train_epoch(detect)(state, jnp.asarray(noisy), jnp.asarray(clean),
                                              jax.random.PRNGKey(1), BATCH)
    sd = ralenet_state_dict({"params": state.params, "batch_stats": state.batch_stats},
                            "full")
    grads = ralenet_state_dict({"params": jax.tree.map(
        lambda mu: np.asarray(mu) / 0.1, state.opt_state[0].mu)}, "full")
    return sd, grads, {k: float(v) for k, v in jax.device_get(metrics).items()}


def _single_step(workdir, case):
    """The port's step in this process on the whole batch."""
    make, seed, detect = STEP_CASES[case]
    state = create_train_state(ralenet(workdir / f"ralenet_{case}.pt"), device="cpu")
    train_epoch, _ = make_epoch_fns(state.model, state.optimizer, detect_r_pos=detect)
    noisy, clean = (torch.from_numpy(a) for a in make(BATCH, seed=seed))
    metrics = train_epoch(noisy, clean, torch.Generator().manual_seed(0), BATCH)
    return state, metrics


def _grads(model):
    return {k: p.grad for k, p in model.named_parameters() if p.grad is not None}


def _assert_bars(grads, full, ref_grads, ref_state):
    """`chip_smoke.step_bars` on gradients and parameters, and the BN stats."""
    bars = chip_smoke.step_bars(grads, ref_grads, {k: full[k] for k in grads}, ref_state)
    assert bars["ok"], chip_smoke.describe_bars(bars)
    for key, val in full.items():
        if key.endswith(STATS):
            np.testing.assert_allclose(val.numpy(), ref_state[key].numpy(), atol=STATS_TOL,
                                       rtol=0, err_msg=key)


def _assert_replicas_agree(results, key):
    """Every replicated tensor alike on all four ranks, bit for bit, and every
    shard alike on the ranks of its model index."""
    full = results[0][key]["full"]
    for name, val in results[0][key]["local"].items():
        sharded = val.shape != full[name].shape
        for r, result in enumerate(results):
            if sharded and r % N_MODEL:
                continue
            assert torch.equal(result[key]["local"][name], val), (key, name, r)
        if sharded:
            for r in range(N_MODEL + 1, WORLD, N_MODEL):
                assert torch.equal(results[r][key]["local"][name],
                                   results[r - N_MODEL][key]["local"][name]), (key, name, r)


@pytest.mark.parametrize("case", list(STEP_CASES))
def test_tp_ralenet_step_matches_the_single_process_and_jax(ranks, case):
    """One RA-LENet 'full' step at a global batch of 8 on the (2, 2) grid
    (with `--r_pos detect`: each data index detects its own windows' R
    peaks) against the port's step on the whole batch in one process and
    JAX's single-device step: the gathered gradients 1e-5 absolute of the
    single process's, the rel-pos tables' and `leconv`'s (the two
    replicated pieces inside a region) among them and nonzero; loss, BN
    stats and parameters at their bars against both; every replica alike."""
    workdir, results = ranks
    _assert_replicas_agree(results, case)
    got = results[0][case]
    assert got["step"] == 1 and all(r[case]["metrics"] == got["metrics"] for r in results)
    single, metrics = _single_step(workdir, case)
    ref_grads = _grads(single.model)
    assert set(got["grads"]) == set(ref_grads)
    for key, g in ref_grads.items():
        np.testing.assert_allclose(got["grads"][key].numpy(), g.numpy(), atol=GRAD_TOL,
                                   rtol=0, err_msg=key)
    traps = [k for k in ref_grads if "relative_position" in k or "leconv" in k]
    assert len(traps) == 4 + 9 and all(ref_grads[k].abs().max() > 0 for k in traps)
    jax_sd, jax_grads, jax_metrics = _jax_step(case)
    for want_grads, want_state, want in ((ref_grads, single.model.state_dict(), metrics),
                                         (jax_grads, jax_sd, jax_metrics)):
        np.testing.assert_allclose(got["metrics"]["loss"], want["loss"], rtol=LOSS_TOL)
        np.testing.assert_allclose(got["metrics"]["snr"], want["snr"], atol=SNR_TOL)
        _assert_bars(got["grads"], got["full"], want_grads, want_state)


def test_gathered_adam_moments_equal_the_single_process(ranks):
    """Adam's moments after the step, gathered to one process's layout
    (`to_kv` too), against the single process's, by the parameter's name."""
    workdir, results = ranks
    single, _ = _single_step(workdir, "plain")
    names = [k for k, _ in single.model.named_parameters()]
    want = single.optimizer.state_dict()["state"]
    got = results[0]["plain"]["adam"]
    assert sorted(got) == sorted(want) == list(range(len(names)))
    for i, name in enumerate(names):
        for key, tol in (("exp_avg", 0.1 * GRAD_TOL), ("exp_avg_sq", 1e-9)):
            np.testing.assert_allclose(got[i][key].numpy(), want[i][key].numpy(), atol=tol,
                                       rtol=1e-4, err_msg=f"{name} {key}")


# --- checkpoints, frozen cores, bf16, eval --------------------------------------


def test_checkpoint_under_the_grid_serves_and_resumes(ranks, tmp_path):
    """`fit` under the grid writes one checkpoint, from rank 0, in one
    process's layout: it loads into a single-process model equal to the
    gathered state bit for bit, with its Adam state. Resumed under the grid
    it takes the uninterrupted single process's next step (the split is
    one batch, so epoch 0's and epoch 1's permutations differ only in the
    order of rows), at the step's bars, and equals one process resumed
    from it. The epoch's metrics, a ragged eval batch among them, equal the
    single process's."""
    workdir, results = ranks
    path = checkpoint_of(str(workdir))
    got = results[0]["fit"]
    model = load_model_weights(path, ralenet(workdir / "ralenet.pt"))
    for key, val in got["full"].items():
        assert torch.equal(model.state_dict()[key], val), key
    ckpt = torch.load(path)
    assert {k: v.shape for k, v in ckpt["model"].items()} == {
        k: v.shape for k, v in RaleNet(variant="full", depth=1).state_dict().items()}

    single = fit(ralenet(workdir / "ralenet.pt"), *fit_splits(),
                 **fit_kwargs(str(tmp_path / "fit")))
    (train_snr, test_snr, train_rmse, test_rmse) = (v for (v,) in got["lists"])
    np.testing.assert_allclose([train_snr, test_snr],
                               [single[1][0][0], single[1][1][0]], atol=SNR_TOL)
    np.testing.assert_allclose([train_rmse, test_rmse],
                               [single[1][2][0], single[1][3][0]], rtol=LOSS_TOL)
    two = fit(ralenet(workdir / "ralenet.pt"), *fit_splits(),
              **fit_kwargs(str(tmp_path / "two"), epochs=2))[0]
    resumed = fit(ralenet(workdir / "ralenet.pt"), *fit_splits(),
                  **fit_kwargs(str(tmp_path / "resumed"), resume_path=path))[0]
    again = results[0]["resume"]
    assert again["step"] == 2
    for ref in (two, resumed):
        _assert_bars(again["grads"], again["full"], _grads(ref.model), ref.model.state_dict())
    state = create_train_state(ralenet(workdir / "ralenet.pt"), device="cpu")
    load_checkpoint(path, state)
    assert state.step == 1
    _assert_replicas_agree(results, "resume")


def test_frozen_newrale_core_under_the_grid(ranks):
    """NewRale with its RA-LENet core frozen and sharded (JAX:
    `tests/test_mesh.py:150-193`): the core, gathered, bit for bit as it
    went in, the adapters moved, the step equal to the single process's."""
    workdir, results = ranks
    got = results[0]["newrale"]
    start = torch.load(workdir / "newrale.pt")
    model = NewRale()
    model.load_state_dict(start)
    frozen = model.frozen_parameters()
    state = create_train_state(model, device="cpu", frozen=frozen)
    train_epoch, _ = make_epoch_fns(state.model, state.optimizer)
    noisy, clean = (torch.from_numpy(a) for a in newrale_data())
    metrics = train_epoch(noisy, clean, torch.Generator().manual_seed(0), BATCH)
    for key in frozen:
        assert torch.equal(got["full"][key], start[key]), key
    assert set(got["grads"]) == {k for k, _ in model.named_parameters()} - frozen
    assert all(not torch.equal(got["full"][k], start[k]) for k in got["grads"])
    np.testing.assert_allclose(got["metrics"]["loss"], metrics["loss"], rtol=LOSS_TOL)
    _assert_bars(got["grads"], got["full"], _grads(state.model), state.model.state_dict())
    _assert_replicas_agree(results, "newrale")


def test_bf16_forward_under_the_grid(ranks):
    """The bf16 eval forward on every rank within 3 * 2^-8 of max|out| of
    the single process's bf16 forward (the row-parallel partials summed in
    float32 and rounded once)."""
    workdir, results = ranks
    model = ralenet(workdir / "ralenet.pt", torch.bfloat16).eval()
    with torch.no_grad():
        want = model(torch.from_numpy(sines(BF16_WINDOWS, seed=16)[0])).float()
    bar = BF16_TOL_OF_MAX * want.abs().max().item()
    for result in results:
        assert result["bf16"].dtype == torch.bfloat16
        assert (result["bf16"].float() - want).abs().max().item() <= bar


def test_eval_epoch_with_a_ragged_batch_under_the_grid(ranks):
    """The eval epoch over 11 windows at batch 8 (the last batch padded, its
    rows split over the data indices) equals the single process's."""
    workdir, results = ranks
    state = create_train_state(ralenet(workdir / "ralenet.pt"), device="cpu")
    _, eval_epoch = make_epoch_fns(state.model, state.optimizer)
    want = eval_epoch(*(torch.from_numpy(a) for a in sines(EVAL_WINDOWS, seed=17)), BATCH)
    for result in results:
        assert result["eval"] == results[0]["eval"]
        np.testing.assert_allclose(result["eval"]["loss"], want["loss"], rtol=LOSS_TOL)
        np.testing.assert_allclose(result["eval"]["rmse"], want["rmse"], rtol=LOSS_TOL)
        np.testing.assert_allclose(result["eval"]["snr"], want["snr"], atol=SNR_TOL)


def test_cli_training_under_the_grid(ranks):
    """`cli.main`'s worker (`_train`, as under a launcher) with `--n_data 2
    --n_model 2` on a written cache: RA-LENet 'full' sharded over the grid
    (`make_mesh` takes no grid but 2 x 2 on the four ranks) for one epoch,
    rank 0 alone writing the result line and the run's train_log.jsonl
    record, its flags recorded."""
    workdir, _ = ranks
    lines = (workdir / "cli" / "output.txt").read_text().splitlines()
    assert len(lines) == 1 and lines[0].startswith("ralenet_0_bw_intensity-4:snr:")
    assert "nan" not in lines[0]
    (record,) = [json.loads(line) for line in
                 (workdir / "cli" / "train_log.jsonl").read_text().splitlines()]
    assert record["fn"] == "fit" and record["status"] == "ok"
    assert record["kwargs"]["epochs"] == 1 and record["kwargs"]["batch_size"] == 16
