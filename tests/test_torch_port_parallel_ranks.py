"""The ranks of the data-parallel CPU tests, and the parallel module's
checks that need no second process and no JAX.

`run_ranks` is what each of the two gloo processes of
`test_torch_port_parallel.py` runs (through `torch.multiprocessing.spawn`,
a file store under the test's tmp_path, so no port is chosen). It imports
no JAX, so a rank starts in the time torch takes to import. Every case of
that file runs in one spawn; each rank writes its results to
`<workdir>/rank<r>.pt` and the tests read them. The inputs are made here
from numpy seeds, so the tests make the same ones for their references.
"""

import os

import numpy as np
import pytest
import torch
torch.set_num_threads(1)  # six test workers share the host's cores: one intra-op thread each
import torch.distributed as dist

WORLD = 2
RALENET_BATCH = 8  # the global batch: 4 a rank
UNET_TRAIN, UNET_TEST, UNET_BATCH = 16, 10, 16  # one step; the eval's tail ragged
UNET_CASES = ("fit", "resume", "local", "resume_dp")
BN_CASES = {"3d": (2, 4, 8), "2d": (1, 4)}  # a rank's input; "2d": one value a channel
FIXTURE_CKPT = os.path.join(os.path.dirname(os.path.abspath(__file__)), "data", "jax_ckpt",
                            "unet", "unet_1_bw_intensity-4.msgpack")


def sines(n, seed):
    """Noisy and clean (n, 2, 256) float32 windows: sines plus noise."""
    rng = np.random.default_rng(seed)
    t = np.linspace(0, 6 * np.pi, 256)
    clean = np.sin(t + rng.uniform(0, 6, (n, 2, 1)))
    noisy = clean + 0.5 * rng.standard_normal(clean.shape)
    return noisy.astype(np.float32), clean.astype(np.float32)


def beats(n, seed):
    """Noisy windows holding one beat each, at a seeded position, and the
    clean beats."""
    rng = np.random.default_rng(seed)
    t = np.arange(256)
    centres = rng.integers(20, 236, (n, 1, 1))
    clean = np.exp(-0.5 * ((t - centres) / 4.0) ** 2) * np.ones((1, 2, 1))
    noisy = clean + 0.2 * rng.standard_normal(clean.shape)
    return noisy.astype(np.float32), clean.astype(np.float32)


def unet_splits():
    """UNet's (train noisy, train clean, test noisy, test clean)."""
    return (*sines(UNET_TRAIN, seed=21), *sines(UNET_TEST, seed=22))


def bn_input(case, rank):
    """Rank `rank`'s BatchNorm input and its output's cotangent."""
    rng = np.random.default_rng(30 + rank)
    shape = BN_CASES[case]
    x = rng.standard_normal(shape) * (1 + rank) + rank
    return (torch.from_numpy(x.astype(np.float32)),
            torch.from_numpy(rng.standard_normal(shape).astype(np.float32)))


def bn_layer():
    from ecg_denoise_tpu_torch.ops.layers import BatchNorm1d

    bn = BatchNorm1d(4)
    with torch.no_grad():
        bn.weight.copy_(torch.tensor([1.0, 0.5, 2.0, -1.0]))
        bn.bias.copy_(torch.tensor([0.1, -0.2, 0.3, 0.0]))
        bn.running_mean.copy_(torch.tensor([0.5, 0.0, -0.5, 1.0]))
        bn.running_var.copy_(torch.tensor([1.5, 0.5, 1.0, 2.0]))
    return bn.train()


def grads_of(model):
    return {k: p.grad.clone() for k, p in model.named_parameters() if p.grad is not None}


def _ralenet_step(mesh, weights, data, detect):
    from ecg_denoise_tpu_torch.models.ralenet import RaleNet
    from ecg_denoise_tpu_torch.train import create_train_state, make_epoch_fns

    model = RaleNet(variant="full", depth=1)
    model.load_state_dict(torch.load(weights))
    state = create_train_state(model, device="cpu")
    train_epoch, _ = make_epoch_fns(state.model, state.optimizer, detect_r_pos=detect,
                                    mesh=mesh)
    noisy, clean = (torch.from_numpy(a) for a in data)
    metrics = train_epoch(noisy, clean, torch.Generator().manual_seed(0), RALENET_BATCH)
    return {"metrics": metrics, "state": state.model.state_dict(),
            "grads": grads_of(state.model), "step": state.step}


def resume_path(workdir, case):
    """The checkpoint UNet's `case` resumes: the JAX fixture ("resume"),
    or the one rank 0 wrote in the "fit" case ("resume_dp")."""
    return {"resume": FIXTURE_CKPT,
            "resume_dp": os.path.join(workdir, "fit", "model_save", "unet",
                                      "unet_0_bw_intensity-4.pth")}.get(case)


def _unet_fit(mesh, weights, workdir, case):
    """UNet's epoch through `fit`: "fit" from `weights`, "resume" from the
    JAX fixture, "local" on this rank's `process_shard` of the splits,
    "resume_dp" from the checkpoint of "fit"."""
    from ecg_denoise_tpu_torch.models import build_model
    from ecg_denoise_tpu_torch.parallel import multihost
    from ecg_denoise_tpu_torch.train import fit

    model = build_model("unet", device="cpu")
    model.load_state_dict(torch.load(weights))
    splits = unet_splits()
    if case == "local":
        splits = (*multihost.process_shard(*splits[:2]), *multihost.process_shard(*splits[2:]))
    out = os.path.join(workdir, case)
    state, lists = fit(model, *splits, epochs=1, batch_size=UNET_BATCH,
                       model_name="unet", model_save_dir=os.path.join(out, "model_save"),
                       output_file=os.path.join(out, "output.txt"), checkpoint_every=1,
                       resume_path=resume_path(workdir, case),
                       verbose=False, device="cpu", mesh=mesh, local_data=case == "local")
    return {"lists": lists, "state": state.model.state_dict(),
            "grads": grads_of(state.model), "step": state.step}


def _bn(mesh, case):
    from ecg_denoise_tpu_torch.ops.layers import global_batch_stats

    bn = bn_layer()
    x, g = bn_input(case, mesh.rank)
    x.requires_grad_(True)
    with global_batch_stats(bn, mesh.group):
        y = bn(x)
    (y * g).sum().backward()
    weight_grad, bias_grad = (dist_sum(p.grad) for p in (bn.weight, bn.bias))
    return {"y": y.detach(), "x_grad": x.grad, "weight_grad": weight_grad,
            "bias_grad": bias_grad, "running_mean": bn.running_mean.clone(),
            "running_var": bn.running_var.clone(), "group_after": bn.group}


def dist_sum(t):
    t = t.clone()
    dist.all_reduce(t)
    return t


def run_ranks(rank, store, workdir):
    """Rank `rank` of the two: every case, its results to rank<r>.pt."""
    from ecg_denoise_tpu_torch.parallel import make_mesh, multihost

    torch.set_num_threads(1)
    dist.init_process_group("gloo", init_method=f"file://{store}", world_size=WORLD,
                            rank=rank)
    try:
        mesh = make_mesh(WORLD, device="cpu")
        out = {
            "mesh": (mesh.world_size, mesh.rank, str(mesh.device)),
            "shard_indices": multihost.process_shard_indices(7).tolist(),
            "ralenet": _ralenet_step(mesh, os.path.join(workdir, "ralenet.pt"),
                                     sines(RALENET_BATCH, seed=11), detect=False),
            "ralenet_rpos": _ralenet_step(mesh, os.path.join(workdir, "ralenet_rpos.pt"),
                                          beats(RALENET_BATCH, seed=12), detect=True),
            **{f"unet_{case}": _unet_fit(mesh, os.path.join(workdir, "unet.pt"), workdir, case)
               for case in UNET_CASES if case != "resume_dp"},
            **{f"bn_{case}": _bn(mesh, case) for case in BN_CASES},
        }
        dist.barrier()  # rank 0's checkpoint of "fit" is written
        out["unet_resume_dp"] = _unet_fit(mesh, os.path.join(workdir, "unet.pt"), workdir,
                                          "resume_dp")
        with pytest.raises(ValueError, match="make_mesh|n_data=3"):
            make_mesh(3, device="cpu")
        torch.save(out, os.path.join(workdir, f"rank{rank}.pt"))
    finally:
        dist.destroy_process_group()


# --- checks in this process --------------------------------------------------


def test_batchnorm_without_a_group_is_torchs_own():
    """With no group the layer is the one it was, bit for bit: torch's
    BatchNorm1d in float32, its running stats too."""
    x, _ = bn_input("3d", 0)
    ours, ref = bn_layer(), bn_layer()
    y = ours(x)
    assert ours.group is None
    assert torch.equal(y, torch.nn.BatchNorm1d.forward(ref, x))
    assert torch.equal(ours.running_mean, ref.running_mean)
    assert torch.equal(ours.running_var, ref.running_var)


def test_shard_batch_takes_contiguous_rows_and_refuses_an_uneven_batch():
    from ecg_denoise_tpu_torch.parallel import Mesh, shard_batch

    x = torch.arange(12).reshape(6, 2)
    for rank in range(3):
        mesh = Mesh(3, rank, torch.device("cpu"), None)
        assert torch.equal(shard_batch(x, mesh), x[2 * rank:2 * rank + 2])
    with pytest.raises(ValueError, match="does not split over 4 ranks"):
        shard_batch(x, Mesh(4, 0, torch.device("cpu"), None))


def test_make_mesh_refuses_tensor_parallelism_and_missing_ranks():
    """Without a process group, a grid of more than one rank, data or model
    parallel, names the processes it needs."""
    from ecg_denoise_tpu_torch.parallel import make_mesh

    with pytest.raises(ValueError, match="needs 2 processes"):
        make_mesh(1, n_model=2, device="cpu")
    with pytest.raises(ValueError, match="needs 2 processes"):
        make_mesh(2, device="cpu")
    assert not dist.is_initialized()
