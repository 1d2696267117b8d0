"""What a launch costs from Python, and what one CUDA graph gives back
(JAX counterpart: scripts/probe_chain.py).

    python -m ecg_denoise_tpu_torch.probes.chain

On the card only (it raises without one), each case runs K times in a
chain, two ways, on the host clock around work that ends in one
synchronize (median of 3):

* "python": K calls issued from Python, then one synchronize;
* "graph": the same K calls captured once in a `torch.cuda.CUDAGraph` and
  replayed: one launch from the host for all K, the counterpart of the JAX
  probe's K calls inside one `jit(fori_loop)`.

For each way it fits the JAX probe's two-point line on the extremes,
per call = E/K + c (`chain_fit`): c is the cost of one call in a long
chain, E the cost paid once per chain (the synchronize and, for a graph,
its launch). The Python way's c against the graph's c is what a CUDA graph
of many small launches would give back.

Cases (float32 unless named): the null launch (`null_copy` of one (8, 128)
tile), the "dma" copy of an attention call's q at (L, H) = (256, 2), batch
2048, B1 at that shape with its bias, and RA-LENet 'full' as a bfloat16
forward at batch 2048 from seeded random weights; the model runs K = 2, 8
and 32 (K = 256 of its forwards would take minutes). A wrapper's launch
count grows once per call issued from Python and once per call captured,
not per replay.
"""

from __future__ import annotations

import statistics
import time

import torch

from ecg_denoise_tpu_torch.probes.floor import attention_operands, capture, require_card

CHAINS = (8, 64, 256)
MODEL_CHAINS = (2, 8, 32)
BATCH = 2048
ITERS = 3


def chain_fit(chains, us):
    """The JAX probe's two-point fit on the extremes of `chains` (the K
    values) and `us` (per-call times): per call = E/K + c. Returns (E, c),
    E in the units of `us` times a call (paid once per chain), c per call."""
    k0, k1 = chains[0], chains[-1]
    v0, v1 = us[0], us[-1]
    E = (v0 - v1) / (1.0 / k0 - 1.0 / k1)
    return E, v1 - E / k1


def python_us(fn, K: int) -> float:
    """µs per call: K calls issued from Python, one synchronize (median of
    ITERS chains)."""
    fn()
    torch.cuda.synchronize()
    walls = []
    for _ in range(ITERS):
        t0 = time.perf_counter()
        for _ in range(K):
            fn()
        torch.cuda.synchronize()
        walls.append(time.perf_counter() - t0)
    return statistics.median(walls) / K * 1e6


def graph_us(fn, K: int) -> float:
    """µs per call: K calls captured in one CUDA graph, replayed with one
    synchronize (median of ITERS replays, after one warm replay)."""
    graph = capture(fn, K)
    walls = []
    for _ in range(ITERS):
        t0 = time.perf_counter()
        graph.replay()
        torch.cuda.synchronize()
        walls.append(time.perf_counter() - t0)
    graph.reset()
    return statistics.median(walls) / K * 1e6


def _cases():
    from ecg_denoise_tpu_torch.kernels import attention
    from ecg_denoise_tpu_torch.kernels.null_copy import null_copy
    from ecg_denoise_tpu_torch.models import build_model

    tile = torch.ones(8, 128, device="cuda")
    q, k, v, bias = attention_operands(BATCH, 2, 256)
    torch.manual_seed(0)
    model = build_model("ralenet", dtype=torch.bfloat16).eval()
    x = torch.randn(BATCH, 2, 256, device="cuda")
    return [
        ("null", "null_copy, one (8, 128) tile", CHAINS, lambda: null_copy(tile)),
        ("dma", f"null_copy of q, (L, H) = (256, 2), batch {BATCH}", CHAINS,
         lambda: null_copy(q)),
        ("B1", f"attention_fwd, (256, 2) with bias, batch {BATCH}", CHAINS,
         lambda: attention._launch(q, k, v, bias)),
        ("model", f"RA-LENet 'full' bf16 forward, batch {BATCH}, K cut to "
                  f"{'/'.join(map(str, MODEL_CHAINS))}", MODEL_CHAINS, lambda: model(x)),
    ]


def main() -> dict:
    card = require_card()
    results = {}
    print(f"[chain] {card}: us per call for K calls in a chain (host clock, median of "
          f"{ITERS}); fit per call = E/K + c on the extremes", flush=True)
    with torch.no_grad():
        for name, what, chains, fn in _cases():
            results[name] = {"what": what, "chains": list(chains)}
            for way, timer in (("python", python_us), ("graph", graph_us)):
                us = [timer(fn, K) for K in chains]
                E, c = chain_fit(chains, us)
                results[name][way] = {"us": us, "E_us": E, "c_us": c}
                print(f"[chain] {name:>6s} {way:>6s} "
                      + " ".join(f"K={K}: {u:.3f}" for K, u in zip(chains, us))
                      + f"   c={c:.3f} us/call  E={E:.1f} us   ({what})", flush=True)
    return {"card": card, "cases": results}


if __name__ == "__main__":
    main()
