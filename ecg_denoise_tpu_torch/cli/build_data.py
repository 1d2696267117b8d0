"""Build the `.npy` data caches with the port (JAX counterpart:
cli/build_data.py; the reference's missing build steps).

Three caches, the same files as the JAX package's from the same flags:
  (default)    dict_data denoising windows    -> cli.main, cli.dwt_dn
  --cls        cls_data N/V beat windows      -> cli.train_cls, cli.test_cls
  --external   12-lead dict_data (LUDB-like)  -> cli.transfer_learning

Uses real PhysioNet records when present under --data_root (the
reference's directory names), else synthetic records (`data/cache.py`,
`data/cls_cache.py`). numpy only: it runs wherever the port is installed.
Unlike the JAX CLI, --data_root defaults to ./data, not ../data: nothing
above the working directory is read, as the port's dataset loader reads
nothing there. Examples:

    python -m ecg_denoise_tpu_torch.cli.build_data --out ./data/dict_data
    python -m ecg_denoise_tpu_torch.cli.build_data --cls --out ./data/cls_data
    python -m ecg_denoise_tpu_torch.cli.build_data --external \\
        --out ./ExternalData/dict_data
"""

from __future__ import annotations

import argparse


def main(argv=None) -> None:
    p = argparse.ArgumentParser(description=__doc__)
    p.add_argument("--out", type=str, default=None)
    p.add_argument("--data_root", type=str, default="./data",
                   help="dir containing mit-bih-*-1.0.0 subdirs (optional)")
    p.add_argument("--n_synth_records", type=int, default=8)
    p.add_argument("--seed", type=int, default=2023)
    p.add_argument("--pvc_prob", type=float, default=0.15,
                   help="fraction of synthetic beats with ventricular (PVC) "
                        "morphology (dict_data/external builders; real "
                        "records ignore this)")
    p.add_argument("--cls", action="store_true", help="build cls_data beat cache")
    p.add_argument("--external", action="store_true",
                   help="build the 12-lead ExternalData cache")
    args = p.parse_args(argv)

    if args.cls:
        from ecg_denoise_tpu_torch.data.cls_cache import build_cls_data

        out = args.out or "./data/cls_data"
        info = build_cls_data(out, seed=args.seed, data_root=args.data_root)
        print(f"built cls_data in {info['out_dir']}: "
              + ", ".join(f"{k}={v}" for k, v in info.items() if k != "out_dir"))
        return

    from ecg_denoise_tpu_torch.data.cache import build_dict_data

    if args.external:
        out = args.out or "./ExternalData/dict_data"
        info = build_dict_data(out, None, args.n_synth_records, args.seed,
                               n_channels=12, pvc_prob=args.pvc_prob)
    else:
        out = args.out or "./data/dict_data"
        info = build_dict_data(out, args.data_root, args.n_synth_records,
                               args.seed, pvc_prob=args.pvc_prob)
    print(f"built {info['n_windows']} windows in {info['out_dir']}")


if __name__ == "__main__":
    main()
