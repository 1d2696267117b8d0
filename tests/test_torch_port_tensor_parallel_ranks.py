"""The ranks of the tensor-parallel CPU tests, and the grid's checks that
need no second process and no JAX.

`run_ranks` is what each of the four gloo processes of
`test_torch_port_tensor_parallel.py` runs, on a (n_data, n_model) = (2, 2)
grid (one `torch.multiprocessing.spawn`, a file store under the test's
tmp_path, so no port is chosen). It imports no JAX. Every case runs in
that one spawn; each rank writes its results to `<workdir>/rank<r>.pt` and
the tests read them. The inputs are made here from numpy seeds
(`test_torch_port_parallel_ranks`' `sines` and `beats`), so the tests make
the same ones for their references.
"""

import os

import numpy as np
import pytest
import torch
torch.set_num_threads(1)  # six test workers share the host's cores: one intra-op thread each
import torch.distributed as dist

from test_torch_port_parallel_ranks import beats, sines

N_DATA, N_MODEL = 2, 2
WORLD = N_DATA * N_MODEL
BATCH = 8  # the global batch: 4 a data index
FIT_TRAIN, FIT_TEST = 8, 11  # one step an epoch; the eval's last batch ragged
EVAL_WINDOWS = 11
BF16_WINDOWS = 4
STEP_CASES = {"plain": (sines, 11, False), "rpos": (beats, 12, True)}
CLI_WINDOWS = 40  # the cache `cli.main`'s training takes: 32 to train at 16, 8 to test
CLI_ARGV = ["--model_index", "4", "--dtype", "float32", "--n_select", str(CLI_WINDOWS),
            "--epochs", "1", "--batch_size", "16", "--n_data", str(N_DATA),
            "--n_model", str(N_MODEL)]


def newrale_data():
    """NewRale's noisy and clean (BATCH, 12, 256) windows."""
    rng = np.random.default_rng(13)
    clean = np.sin(np.linspace(0, 6 * np.pi, 256) + rng.uniform(0, 6, (BATCH, 12, 1)))
    noisy = clean + 0.3 * rng.standard_normal(clean.shape)
    return noisy.astype(np.float32), clean.astype(np.float32)


def fit_splits():
    """RA-LENet's (train noisy, train clean, test noisy, test clean) for `fit`."""
    return (*sines(FIT_TRAIN, seed=14), *sines(FIT_TEST, seed=15))


def fit_kwargs(out, **kw):
    """`fit`'s arguments for the checkpoint cases, writing under `out`."""
    return {"epochs": 1, "batch_size": BATCH, "model_name": "ralenet", "checkpoint_every": 1,
            "model_save_dir": os.path.join(out, "model_save"),
            "output_file": os.path.join(out, "output.txt"), "verbose": False,
            "device": "cpu", **kw}


def checkpoint_of(workdir):
    """The checkpoint rank 0 writes in the "fit" case."""
    return os.path.join(workdir, "fit", "model_save", "ralenet",
                        "ralenet_0_bw_intensity-4.pth")


def ralenet(weights, dtype=torch.float32):
    from ecg_denoise_tpu_torch.models.ralenet import RaleNet

    model = RaleNet(variant="full", depth=1, dtype=dtype)
    model.load_state_dict(torch.load(weights))
    return model


def _result(state, mesh, metrics):
    from ecg_denoise_tpu_torch.parallel import gather_named, gather_state

    full = gather_state(state, mesh)
    grads = {k: p.grad for k, p in state.model.named_parameters() if p.grad is not None}
    return {"metrics": metrics, "local": state.model.state_dict(), "full": full["model"],
            "adam": full["optimizer"]["state"],
            "grads": gather_named(grads, state.model, mesh), "step": state.step}


def _step(mesh, weights, make, seed, detect):
    """One RA-LENet 'full' step of `make_epoch_fns(mesh=...)` at BATCH."""
    from ecg_denoise_tpu_torch.parallel import shard_state_dp_tp
    from ecg_denoise_tpu_torch.train import create_train_state, make_epoch_fns

    state = shard_state_dp_tp(create_train_state(ralenet(weights), device="cpu"), mesh)
    train_epoch, _ = make_epoch_fns(state.model, state.optimizer, detect_r_pos=detect,
                                    mesh=mesh)
    noisy, clean = (torch.from_numpy(a) for a in make(BATCH, seed=seed))
    metrics = train_epoch(noisy, clean, torch.Generator().manual_seed(0), BATCH)
    return _result(state, mesh, metrics)


def _forwards(mesh, weights):
    """The bf16 eval forward, and the f32 eval epoch over EVAL_WINDOWS."""
    from ecg_denoise_tpu_torch.parallel import shard_state_dp_tp
    from ecg_denoise_tpu_torch.train import create_train_state, make_epoch_fns

    state = shard_state_dp_tp(create_train_state(ralenet(weights, torch.bfloat16),
                                                 device="cpu"), mesh)
    x = torch.from_numpy(sines(BF16_WINDOWS, seed=16)[0])
    with torch.no_grad():
        bf16 = state.model.eval()(x)
    state = shard_state_dp_tp(create_train_state(ralenet(weights), device="cpu"), mesh)
    _, eval_epoch = make_epoch_fns(state.model, state.optimizer, mesh=mesh)
    noisy, clean = (torch.from_numpy(a) for a in sines(EVAL_WINDOWS, seed=17))
    return {"bf16": bf16, "eval": eval_epoch(noisy, clean, BATCH)}


def _fit(mesh, weights, workdir, case):
    """`fit` under the grid: "fit" from `weights`, checkpointing; "resume"
    from the checkpoint rank 0 wrote in "fit"."""
    from ecg_denoise_tpu_torch.train import fit

    resume = checkpoint_of(workdir) if case == "resume" else None
    state, lists = fit(ralenet(weights), *fit_splits(),
                       **fit_kwargs(os.path.join(workdir, case), resume_path=resume,
                                    mesh=mesh))
    return {**_result(state, mesh, None), "lists": lists}


def _newrale(mesh, weights):
    """One NewRale step with its RA-LENet core frozen and sharded."""
    from ecg_denoise_tpu_torch.models import NewRale
    from ecg_denoise_tpu_torch.parallel import shard_state_dp_tp
    from ecg_denoise_tpu_torch.train import create_train_state, make_epoch_fns

    model = NewRale()
    model.load_state_dict(torch.load(weights))
    state = shard_state_dp_tp(create_train_state(model, device="cpu",
                                                 frozen=model.frozen_parameters()), mesh)
    train_epoch, _ = make_epoch_fns(state.model, state.optimizer, mesh=mesh)
    noisy, clean = (torch.from_numpy(a) for a in newrale_data())
    metrics = train_epoch(noisy, clean, torch.Generator().manual_seed(0), BATCH)
    return _result(state, mesh, metrics)


def _cli_train(workdir):
    """`cli.main`'s training of a worker under the grid (`_train` with its
    flags, as a launcher's worker runs it) on the cache under `workdir`,
    in `<workdir>/cli`, whose output.txt and train_log.jsonl rank 0 writes."""
    from ecg_denoise_tpu_torch.cli.main import _train
    from ecg_denoise_tpu_torch.config import build_argparser, config_from_args

    out = os.path.join(workdir, "cli")
    os.makedirs(out, exist_ok=True)
    os.chdir(out)  # train_log.jsonl goes to the working directory
    cfg = config_from_args(build_argparser().parse_args(
        [*CLI_ARGV, "--data_path", os.path.join(workdir, "dict_data")]))
    _train(cfg, torch.device("cpu"), mesh=True)


def run_ranks(rank, store, workdir):
    """Rank `rank` of the four: every case, its results to rank<r>.pt."""
    from ecg_denoise_tpu_torch.parallel import make_mesh

    torch.set_num_threads(1)
    dist.init_process_group("gloo", init_method=f"file://{store}", world_size=WORLD,
                            rank=rank)
    try:
        mesh = make_mesh(N_DATA, N_MODEL, device="cpu")
        weights = os.path.join(workdir, "ralenet.pt")
        out = {
            "mesh": (mesh.world_size, mesh.rank, mesh.n_data, mesh.data_rank,
                     mesh.n_model, mesh.model_rank),
            **{case: _step(mesh, os.path.join(workdir, f"ralenet_{case}.pt"), make, seed,
                           detect)
               for case, (make, seed, detect) in STEP_CASES.items()},
            **_forwards(mesh, weights),
            "fit": _fit(mesh, weights, workdir, "fit"),
            "newrale": _newrale(mesh, os.path.join(workdir, "newrale.pt")),
        }
        dist.barrier()  # rank 0's checkpoint of "fit" is written
        out["resume"] = _fit(mesh, weights, workdir, "resume")
        with pytest.raises(ValueError, match="n_data=3 x n_model=2"):
            make_mesh(3, 2, device="cpu")
        out["none_for_the_world"] = make_mesh(None, 4, device="cpu").n_data
        _cli_train(workdir)
        torch.save(out, os.path.join(workdir, f"rank{rank}.pt"))
    finally:
        dist.destroy_process_group()


# --- checks in this process --------------------------------------------------


def test_make_mesh_without_ranks_names_the_processes_a_grid_needs():
    from ecg_denoise_tpu_torch.parallel import make_mesh

    with pytest.raises(ValueError, match=r"\(2, 2\) needs 4 processes"):
        make_mesh(2, n_model=2, device="cpu")
    with pytest.raises(ValueError, match="n_model=0 must be at least 1"):
        make_mesh(1, n_model=0, device="cpu")
    assert not dist.is_initialized()
