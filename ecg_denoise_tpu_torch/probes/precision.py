"""How the card's arithmetic paths round (JAX counterpart:
scripts/probe_precision.py).

    python -m ecg_denoise_tpu_torch.probes.precision

Prints, on the card only (it raises without one), one line per case with
the JAX script's `report` (max and median elementwise relative error
against float64 on the host) and beside it the max absolute error over
max|exact|, which stays meaningful where an exact value is near 0:

* the host prediction of a product on bf16-rounded inputs;
* `probe_dot` of (256, 256) by (256, 256) at each of `PRECISIONS`;
* `probe_fold` (softmax of (256, 256) logits times a (4, 256) v, the row
  sum folded into the product as a ones row of v) at each precision;
* `probe_tree` (the row sum as a tree, all f32);
* `probe_div` of (8, 256), and whether it equals numpy's f32 divide bit
  for bit.

The operands come from `np.random.default_rng(0)` in the JAX script's
order, so they are the TPU run's bit for bit. Every case runs the card's
kernel; none falls back to a plain version.
"""

from __future__ import annotations

import numpy as np
import torch

from ecg_denoise_tpu_torch.probes.floor import require_card

L = 256
D = 4
SEED = 0


def operands(seed: int = SEED) -> dict:
    """a, b, logits, v, num, den as the JAX script draws them."""
    rng = np.random.default_rng(seed)
    a = rng.standard_normal((L, L), np.float32)
    b = rng.standard_normal((L, L), np.float32)
    logits = 2.0 * rng.standard_normal((L, L), np.float32)
    v = rng.standard_normal((D, L), np.float32)
    num = rng.standard_normal((8, L)).astype(np.float32)
    den = (0.5 + rng.random((8, L))).astype(np.float32)
    return {"a": a, "b": b, "logits": logits, "v": v, "num": num, "den": den}


def softmax_pv64(logits: np.ndarray, v: np.ndarray) -> np.ndarray:
    """(D, L) softmax(logits) . v^T in float64, the script's `out64.T`."""
    l64 = logits.astype(np.float64)
    e64 = np.exp(l64 - l64.max(axis=-1, keepdims=True))
    p64 = e64 / e64.sum(axis=-1, keepdims=True)
    return (p64 @ v.astype(np.float64).T).T


def report(name, got, exact, abs_of_max=False) -> dict:
    """The JAX script's `report` line (scripts/probe_precision.py:34-37);
    with `abs_of_max`, max|got - exact| / max|exact| beside it."""
    got = np.asarray(got, np.float64)
    rel = np.abs(got - exact) / np.maximum(np.abs(exact), 1e-30)
    out = {"max_rel": float(rel.max()), "med_rel": float(np.median(rel))}
    line = f"{name:40s} max_rel={rel.max():.3e} med_rel={np.median(rel):.3e}"
    if abs_of_max:
        out["abs_of_max"] = float(np.abs(got - exact).max() / np.abs(exact).max())
        line += f" max_abs/max|exact|={out['abs_of_max']:.3e}"
    print(line, flush=True)
    return out


def main() -> dict:
    card = require_card()

    from ecg_denoise_tpu_torch.kernels.precision import (
        PRECISIONS,
        probe_div,
        probe_dot,
        probe_fold,
        probe_tree,
    )

    ops = operands()
    on_card = {k: torch.from_numpy(x).cuda() for k, x in ops.items()}
    print(f"[precision] {card}: errors against float64 on the host", flush=True)
    a, b = ops["a"], ops["b"]
    exact = a.astype(np.float64) @ b.astype(np.float64)
    abf, bbf = (torch.from_numpy(x).to(torch.bfloat16).double().numpy() for x in (a, b))
    result = {"card": card,
              "host_bf16": report("host bf16-rounded-inputs prediction", abf @ bbf, exact, True)}
    result["dot"] = {p: report(f"cuda dot f32 precision={p}",
                               probe_dot(on_card["a"], on_card["b"], p).cpu(), exact, True)
                     for p in PRECISIONS}
    out64 = softmax_pv64(ops["logits"], ops["v"])
    result["fold"] = {p: report(f"fold sum+div precision={p}",
                                probe_fold(on_card["logits"], on_card["v"], p).cpu(), out64, True)
                      for p in PRECISIONS}
    result["tree"] = report("tree-sum oracle formulation",
                            probe_tree(on_card["logits"], on_card["v"]).cpu(), out64, True)
    num, den = ops["num"], ops["den"]
    got = probe_div(on_card["num"], on_card["den"]).cpu().numpy()
    result["div"] = report("cuda f32 elementwise divide", got,
                           num.astype(np.float64) / den.astype(np.float64), True)
    result["div"]["bit_exact"] = bool(np.array_equal(got.view(np.uint32),
                                                     (num / den).view(np.uint32)))
    print(f"[precision] divide equals numpy's float32 divide bit for bit: "
          f"{result['div']['bit_exact']}", flush=True)
    return result


if __name__ == "__main__":
    main()
