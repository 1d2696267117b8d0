"""Denoiser training on the card — the port's counterpart of the JAX
package's cli/main.py (reference main.py:24-87).

Seed 2023, (noise type, intensity, model) picked by index, a 10k-window
subsample of the dict_data cache split 80/20, Adam/MSE training with the
splits on the card, a checkpoint every 10 epochs and the output.txt result
line; each run is recorded in ./train_log.jsonl (`utils.run_log`). It runs
on the card and raises without one. Every --model_index trains (0 unet,
the default; 1 DANet; 2-4 the RA-LENet family; 5 ACDAE). `--r_pos detect`
centres each window's R-wave attention bias on its own detected R peak
(RaleNet family; printed and ignored for the others). Example:

    python -m ecg_denoise_tpu_torch.cli.main --model_index 4 \\
        --noise_type_index 0 --intensity_index 0 --data_path ./data/dict_data \\
        --r_pos detect

Data parallel (`parallel/`), one process and one card a rank, NCCL between
them; `--batch_size` stays the global batch:

    # k ranks on this host's first k cards, started by the CLI itself:
    python -m ecg_denoise_tpu_torch.cli.main --n_data k ...
    # or by torchrun (--n_data equal to its WORLD_SIZE, or left out):
    torchrun --nproc_per_node k -m ecg_denoise_tpu_torch.cli.main --n_data k ...
    # several hosts: the launcher's environment, and each process keeps its
    # data index's strided share of the windows (multihost.process_shard):
    torchrun --nnodes N --nproc_per_node k ... -m ecg_denoise_tpu_torch.cli.main --multihost ...

Tensor parallel (`parallel.shard_state_dp_tp`): `--n_model m` shards the
transformer projections over model groups of m ranks, on a ('data',
'model') grid of n_data * m ranks, one card each (--n_data unset: the
visible cards // m), as JAX's `make_mesh(n_data, n_model)`:

    python -m ecg_denoise_tpu_torch.cli.main --model_index 4 --n_data 2 --n_model 2 ...
    torchrun --nproc_per_node 4 -m ecg_denoise_tpu_torch.cli.main --n_model 2 ...

Only rank 0 prints the epochs, writes the checkpoints (one process's
layout, under any grid), output.txt and train_log.jsonl.
"""

from __future__ import annotations

import os
import tempfile

import torch

# The models that take r_pos (JAX counterpart: cli/main.py:79).
_RALE = {"ralenet", "ralenet_mlp", "ralenet_nra"}


def main(argv=None) -> None:
    from ecg_denoise_tpu_torch import default_device
    from ecg_denoise_tpu_torch.config import build_argparser, config_from_args
    from ecg_denoise_tpu_torch.parallel import multihost
    from ecg_denoise_tpu_torch.utils.compile_cache import enable_compilation_cache

    enable_compilation_cache()
    args = build_argparser(__doc__).parse_args(argv)
    cfg = config_from_args(args)
    for k, v in vars(args).items():
        print(k, v)
    device = default_device()  # raises without a card: no path falls back to the CPU

    had_group = torch.distributed.is_initialized()
    try:
        distributed = False
        if cfg.multihost:
            distributed = multihost.initialize()
            print(f"multihost: distributed={'on' if distributed else 'off (single process)'}")
        elif (cfg.n_data or cfg.n_model > 1) and multihost.launched():
            distributed = multihost.initialize()
        if distributed or (cfg.n_data in (None, 1) and cfg.n_model == 1):
            _train(cfg, device, mesh=distributed or cfg.n_data == 1,
                   local_data=cfg.multihost and distributed)
            return
        cards = torch.cuda.device_count()
        n_data = cfg.n_data or max(cards // cfg.n_model, 1)
        n = n_data * cfg.n_model
        if n > cards:
            flags = f"--n_data {n_data}" + (f" --n_model {cfg.n_model}" if cfg.n_model > 1
                                            else "")
            raise RuntimeError(f"{flags} needs {n} cards, but {cards} are visible")
        # One worker process a card, joined through a file store.
        with tempfile.TemporaryDirectory() as tmp:
            torch.multiprocessing.spawn(_rank, args=(cfg, n, os.path.join(tmp, "store")),
                                        nprocs=n)
    finally:
        if torch.distributed.is_initialized() and not had_group:
            torch.distributed.destroy_process_group()


def _rank(rank: int, cfg, world_size: int, store: str) -> None:
    """A worker of `cli.main --n_data k [--n_model m]`: rank `rank` on
    cuda:`rank`."""
    torch.distributed.init_process_group("nccl", init_method=f"file://{store}",
                                         world_size=world_size, rank=rank)
    try:
        _train(cfg, torch.device("cuda", rank), mesh=True)
    finally:
        torch.distributed.destroy_process_group()


def _train(cfg, device, mesh: bool, local_data: bool = False) -> None:
    """Train as `cfg` says on `device`, on the ('data', 'model') grid of
    this process's group (made here for --n_data 1) when `mesh`; rank 0
    records the run."""
    from ecg_denoise_tpu_torch.data.dataset import load_split_arrays
    from ecg_denoise_tpu_torch.models import build_model
    from ecg_denoise_tpu_torch.parallel import make_mesh, multihost
    from ecg_denoise_tpu_torch.train import fit
    from ecg_denoise_tpu_torch.utils.run_log import train_log
    from ecg_denoise_tpu_torch.utils.seed import random_seed

    mesh = make_mesh(cfg.n_data, cfg.n_model, device) if mesh else None
    if mesh is not None:
        device = mesh.device
    tr_n, tr_c, te_n, te_c = load_split_arrays(
        cfg.noise_name, cfg.noise_intensity, path=cfg.data_path,
        n_select=cfg.n_select, seed=cfg.seed, split_file=cfg.split_file)
    if local_data:  # the model ranks of one data index hold the same windows
        shard = {"process_index": mesh.data_rank, "process_count": mesh.n_data}
        tr_n, tr_c = multihost.process_shard(tr_n, tr_c, **shard)
        te_n, te_c = multihost.process_shard(te_n, te_c, **shard)
    random_seed(cfg.seed)  # the model's initial weights (rank 0's, under a mesh)
    dtype = torch.bfloat16 if cfg.dtype == "bfloat16" else torch.float32
    model = build_model(cfg.model_index, dtype=dtype, device=device)
    r_pos_mode = cfg.r_pos
    if r_pos_mode and cfg.model_name not in _RALE:
        print(f"--r_pos is RaleNet-family only; ignored for {cfg.model_name}")
        r_pos_mode = None
    # The run's record, the reference's @train_log() (denoise_train.py:14).
    run = fit if mesh is not None and not mesh.is_primary else train_log()(fit)
    run(model, tr_n, tr_c, te_n, te_c,
        epochs=cfg.epochs, batch_size=cfg.batch_size, learning_rate=cfg.lr,
        model_name=cfg.model_name, noise_name=cfg.noise_name,
        noise_intensity=cfg.noise_intensity, seed=cfg.seed,
        model_save_dir=cfg.model_save_dir, output_file=cfg.output_file,
        r_pos_mode=r_pos_mode, device=device, mesh=mesh, local_data=local_data)


if __name__ == "__main__":
    main()
