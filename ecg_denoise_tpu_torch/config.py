"""Training config and the reference's flag surface (JAX counterpart:
config.py).

The same flag names and defaults as the JAX package's CLI (reference
main.py:31-33 plus the framework's extensions), so an invocation of one
runs on the other. One difference: there is no --use_pallas, since the
attention kernels always run on the card. --n_data and --multihost run
`cli.main` data parallel, --n_model tensor parallel (`parallel/`).
"""

from __future__ import annotations

import argparse
from dataclasses import dataclass

from ecg_denoise_tpu_torch import MODEL_NAMES, NOISE_INTENSITIES, NOISE_TYPES


@dataclass
class TrainConfig:
    batch_size: int = 32
    epochs: int = 100
    lr: float = 1e-3
    intensity_index: int = 0
    noise_type_index: int = 0
    model_index: int = 0
    seed: int = 2023
    n_select: int = 10_000
    data_path: str | None = None
    model_save_dir: str = "./model_save"
    output_file: str = "./output.txt"
    dtype: str = "bfloat16"  # compute dtype; master weights stay float32
    split_file: str | None = None  # pin/export exact train/test indices
    r_pos: str | None = None  # "detect": per-window R-peak attention bias
    n_data: int | None = None  # data-parallel ranks (None: single process)
    n_model: int = 1  # tensor-parallel ranks a model group
    multihost: bool = False  # the process group from the launcher's environment

    @property
    def noise_name(self) -> str:
        return NOISE_TYPES[self.noise_type_index]

    @property
    def noise_intensity(self) -> int:
        return NOISE_INTENSITIES[self.intensity_index]

    @property
    def model_name(self) -> str:
        return MODEL_NAMES[self.model_index]


def build_argparser(description: str = "") -> argparse.ArgumentParser:
    p = argparse.ArgumentParser(description=description)
    # Reference flag surface (TorchArgs + per-script extensions).
    p.add_argument("--batch_size", type=int, default=32)
    p.add_argument("--epochs", type=int, default=100)
    p.add_argument("--lr", type=float, default=1e-3)
    p.add_argument("--intensity_index", type=int, default=0)
    p.add_argument("--noise_type_index", type=int, default=0)
    p.add_argument("--model_index", type=int, default=0)
    # Framework extensions.
    p.add_argument("--seed", type=int, default=2023)
    p.add_argument("--n_select", type=int, default=10_000)
    p.add_argument("--data_path", type=str, default=None)
    p.add_argument("--model_save_dir", type=str, default="./model_save")
    p.add_argument("--output_file", type=str, default="./output.txt")
    p.add_argument("--dtype", type=str, default="bfloat16",
                   choices=["float32", "bfloat16"],
                   help="compute dtype (master weights stay float32); "
                        "--dtype float32 is the reference-parity setting")
    p.add_argument("--split_file", type=str, default=None,
                   help="JSON {'train': [...], 'test': [...]}; created if "
                        "absent — pins exact indices for parity runs")
    p.add_argument("--n_data", type=int, default=None,
                   help="data-parallel ranks, one card each: started by cli.main "
                        "itself, or by torchrun (equal to its WORLD_SIZE, or unset "
                        "to take it)")
    p.add_argument("--n_model", type=int, default=1,
                   help="tensor-parallel ranks, one card each: each model group of "
                        "n_model ranks shards the transformer projections (Megatron "
                        "column/row) and each of --n_data such groups takes its share "
                        "of the batch; n_data * n_model cards in all (--n_data unset: "
                        "the visible cards // n_model)")
    p.add_argument("--multihost", action="store_true",
                   help="join the process group the launcher's environment "
                        "describes (MASTER_ADDR, MASTER_PORT, WORLD_SIZE, RANK, "
                        "LOCAL_RANK) and keep this process's strided share of the "
                        "windows; a no-op on a single process")
    p.add_argument("--r_pos", type=str, default=None, choices=["detect"],
                   help="per-window R-peak-centred attention bias: detect "
                        "each batch's R peaks on the card (RaleNet family)")
    return p


def config_from_args(args: argparse.Namespace) -> TrainConfig:
    """The TrainConfig of parsed flags."""
    if args.n_model < 1:
        raise ValueError(f"--n_model {args.n_model} must be at least 1")
    known = set(TrainConfig.__dataclass_fields__)
    return TrainConfig(**{k: v for k, v in vars(args).items() if k in known})
