"""Training config and the reference's flag surface (JAX counterpart:
config.py).

The same flag names and defaults as the JAX package's CLI (reference
main.py:31-33 plus the framework's extensions), so an invocation of one
runs on the other. Two differences: there is no --use_pallas, since the
attention kernels always run on the card, and the flags of paths not
ported yet (--n_data, --n_model, --multihost) are parsed and raise
NotImplementedError naming their ROADMAP item, never ignored.
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
    # Parsed so that a JAX-package invocation is not silently changed;
    # each raises until its slice lands.
    p.add_argument("--n_data", type=int, default=None,
                   help="data-parallel size: not ported yet (ROADMAP A16)")
    p.add_argument("--n_model", type=int, default=1,
                   help="tensor-parallel size: not ported yet (ROADMAP A16)")
    p.add_argument("--multihost", action="store_true",
                   help="multi-host training: not ported yet (ROADMAP A16)")
    p.add_argument("--r_pos", type=str, default=None, choices=["detect"],
                   help="per-window R-peak-centred attention bias: detect "
                        "each batch's R peaks on the card (RaleNet family)")
    return p


_NOT_PORTED = {"n_data": (None, "A16"), "n_model": (1, "A16"),
               "multihost": (False, "A16")}


def config_from_args(args: argparse.Namespace) -> TrainConfig:
    """The TrainConfig of parsed flags; raises NotImplementedError for a
    flag whose path is not ported yet."""
    for name, (default, item) in _NOT_PORTED.items():
        if getattr(args, name) != default:
            raise NotImplementedError(
                f"--{name} is not ported yet (ROADMAP.md item {item})")
    known = set(TrainConfig.__dataclass_fields__)
    return TrainConfig(**{k: v for k, v in vars(args).items() if k in known})
