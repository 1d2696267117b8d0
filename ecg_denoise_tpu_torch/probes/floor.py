"""What sets an attention call's floor on the card (JAX counterpart:
scripts/probe_floor.py).

    python -m ecg_denoise_tpu_torch.probes.floor

Prints, on the card only (it raises without one):

* the null launch: `null_copy` of one (8, 128) float32 tile, in µs per
  call on the host clock (1,000 calls issued from Python, one synchronize)
  and replayed from one CUDA graph (the card's own gap between launches);
* at (L, H) = (256, 2) and (64, 8), for each batch: B1 (the forward kernel
  without its lse, with the stage's (1, H, L, L) bias), the "dma" floor
  (`null_copy` of the same q: the call's bytes moved and nothing computed)
  and, where the stage packs, B5 (the dense forward), in µs per call and
  GB/s of the bytes each must move (q, k, v, o and the bias for B1 and B5;
  q read and written for the copy). float32 throughout. The copy cycles
  through copies of q that outgrow the card's 50 MB L2 and keeps every
  output, so it moves its bytes to and from HBM; B1 and B5 take the same
  operands every call, as in the model, where q, k and v arrive warm from
  the projection that made them.

Kernel times are the card's: 50 calls captured in one CUDA graph, one
replay timed with CUDA events, the counterpart of the JAX probe's calls
inside one `jit(fori_loop)`. Calls issued one by one from Python would
time the host instead wherever a call is shorter than its launch from
Python (the null launch above). The JAX probe sweeps the TPU kernel's grid
step size through its VMEM budget; on the card the grid grows with the
batch, so the batch sweep takes its place.
"""

from __future__ import annotations

import itertools
import time

import torch

STAGES = ((256, 2), (64, 8))  # (L, H); the dense route packs (64, 8)
BATCHES = (256, 1024, 2048)
NULL_CALLS = 1000
ITERS = 50
L2_BYTES = 50 * 2**20  # the H100's L2 cache


def require_card() -> str:
    """The card's name; raises without one (the probes never fall back)."""
    if not torch.cuda.is_available():
        raise RuntimeError("the probes measure the card: no CUDA device is available")
    return torch.cuda.get_device_name(0)


def host_us(fn, calls: int) -> float:
    """µs per call on the host clock: `calls` calls issued from Python,
    then one synchronize."""
    fn()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    for _ in range(calls):
        fn()
    torch.cuda.synchronize()
    return (time.perf_counter() - t0) / calls * 1e6


def capture(fn, calls: int) -> torch.cuda.CUDAGraph:
    """`calls` calls of fn captured in one CUDA graph (after two warm-up
    calls on a side stream, as PyTorch asks) and replayed once."""
    side = torch.cuda.Stream()
    side.wait_stream(torch.cuda.current_stream())
    with torch.cuda.stream(side):
        for _ in range(2):
            fn()
    torch.cuda.current_stream().wait_stream(side)
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph):
        for _ in range(calls):
            fn()
    graph.replay()
    torch.cuda.synchronize()
    return graph


def graph_us(fn, calls: int) -> float:
    """µs per call on the card's clock: one replay of `calls` captured
    calls between two CUDA events."""
    graph = capture(fn, calls)
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    graph.replay()
    end.record()
    end.synchronize()
    graph.reset()
    return start.elapsed_time(end) / calls * 1e3


def attention_operands(B: int, H: int, L: int, seed: int = 0):
    """float32 q, k, v (B, H, L, 4) and a (1, H, L, L) bias on the card."""
    gen = torch.Generator().manual_seed(seed)
    q, k, v = (torch.randn(B, H, L, 4, generator=gen).cuda() for _ in range(3))
    return q, k, v, torch.randn(1, H, L, L, generator=gen).cuda()


def cold_copy_us(copy, x: torch.Tensor, calls: int) -> float:
    """`graph_us` of copy(x'), where x' cycles through copies of x that
    outgrow the L2 and every call keeps its output: the bytes are read
    from and written to HBM, not the L2."""
    inputs = itertools.cycle([x.clone() for _ in range(
        max(2, L2_BYTES // (x.numel() * x.element_size()) + 1))])
    outputs = []
    us = graph_us(lambda: outputs.append(copy(next(inputs))), calls)
    outputs.clear()
    return us


def _cell(x, width: int, digits: int) -> str:
    return f"{'-':>{width}}" if x is None else f"{x:{width}.{digits}f}"


def main() -> dict:
    card = require_card()

    from ecg_denoise_tpu_torch.kernels import attention
    from ecg_denoise_tpu_torch.kernels.attention_dense import (
        dense_pack_factor,
        fused_attention_dense,
    )
    from ecg_denoise_tpu_torch.kernels.null_copy import null_copy

    tile = torch.ones(8, 128, device="cuda")
    null = {"host_us": host_us(lambda: null_copy(tile), NULL_CALLS),
            "graph_us": graph_us(lambda: null_copy(tile), NULL_CALLS)}
    print(f"[floor] {card}: null launch (null_copy of one (8, 128) float32 tile): "
          f"{null['host_us']:.3f} us/call on the host clock ({NULL_CALLS} calls "
          f"from Python, one synchronize), {null['graph_us']:.3f} us/call replayed "
          f"from one CUDA graph (CUDA events)", flush=True)
    print(f"[floor] {'stage':>9s} {'batch':>6s} {'B1 us':>9s} {'dma us':>9s} "
          f"{'B5 us':>9s} {'B1 GB/s':>8s} {'dma GB/s':>8s} {'B5 GB/s':>8s} "
          f"(float32; {ITERS} calls replayed from one CUDA graph, CUDA events)",
          flush=True)
    rows = []
    with torch.no_grad():
        for L, H in STAGES:
            for B in BATCHES:
                q, k, v, bias = attention_operands(B, H, L)
                nbytes = (4 * q.numel() + bias.numel()) * q.element_size()
                row = {"L": L, "H": H, "batch": B,
                       "b1_us": graph_us(lambda: attention._launch(q, k, v, bias), ITERS),
                       "dma_us": cold_copy_us(null_copy, q, ITERS), "b5_us": None}
                if dense_pack_factor(H, L) > 1:
                    row["b5_us"] = graph_us(
                        lambda: fused_attention_dense(q, k, v, bias), ITERS)
                rates = {key: None if row[f"{key}_us"] is None else
                         (2 * q.numel() * q.element_size() if key == "dma" else nbytes)
                         / row[f"{key}_us"] / 1e3 for key in ("b1", "dma", "b5")}
                row.update({f"{key}_gbs": r for key, r in rates.items()})
                rows.append(row)
                print(f"[floor] {f'L{L}_H{H}':>9s} {B:>6d} "
                      + " ".join(_cell(row[f"{key}_us"], 9, 3) for key in ("b1", "dma", "b5"))
                      + " " + " ".join(_cell(rates[key], 8, 1) for key in ("b1", "dma", "b5")),
                      flush=True)
    return {"card": card, "null": null, "rows": rows}


if __name__ == "__main__":
    main()
