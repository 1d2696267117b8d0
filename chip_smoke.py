#!/usr/bin/env python3
"""Drive the PyTorch/CUDA port (`ecg_denoise_tpu_torch`) on one NVIDIA card.

Run from the root of a checkout, on a machine with the card:

    python3 chip_smoke.py

Phases, each of which fails the run on error (no phase catches a failure,
and nothing falls back to the CPU):

1. Device and build: the card's name and power limit, then nvcc builds the
   attention kernel from the checkout and prints its ptxas report.
2. Kernel vs plain version on the card, at the five RA-LENet stage shapes,
   with and without bias, float32 (tolerance 1e-5, TF32 off for this phase
   only) and bfloat16
   (3 * 2^-8 of max|v|, see BF16_TOL_OF_MAX_V), plus a ragged batch and
   logits near 200.
3. Model: RA-LENet 'full' at full width and depth, seeded weights with
   random nonzero rel-pos tables and BN stats; the card's forward against
   the same model on the CPU (float32, 1e-4) and 18 kernel launches per
   forward. The package, not this script, turns TF32 off for the model.
4. Serving, the main path: the port's HTTP server in a thread answers
   /healthz, /denoise for 1, 37 and 1024 windows and /denoise_record,
   each answer equal to Denoiser called directly. The kernel's launch count
   is set to 0 just before and read just after.
5. Times on the card: Denoiser windows/s at batch 1024 and 2048 in float32
   and bfloat16, the device time of one forward by kernel in each
   (torch.profiler), and per stage shape the kernel's time (CUDA events),
   its bound, the plain version's time and scaled_dot_product_attention's
   as a yardstick (the port never calls it). A call from a fresh thread,
   as the HTTP server makes, is timed and profiled by operator.

The last lines are one JSON object per kernel, the card's name and power
limit, and `{"ok": true, "device": {...}}`. Without a card, or outside a
checkout of the repository, it exits nonzero and prints no result.
"""

import io
import json
import os
import statistics
import subprocess
import sys
import tempfile
import threading
import time
import urllib.request

import numpy as np
import torch
import torch.nn.functional as F

STAGES = [(256, 2), (128, 4), (64, 8), (32, 16), (16, 32)]
# Attention calls of one RA-LENet 'full' forward, by (L, H, with bias).
FORWARD_CALLS = {(256, 2, True): 2, (128, 4, True): 4, (64, 8, True): 4,
                 (32, 16, True): 4, (16, 32, False): 4}
F32_TOL = 1e-5
# bf16, as a fraction of max|v|: the plain version rounds the probabilities
# to bf16 before the pv product and the kernel does not (up to 2^-8 of
# max|v|), and each side rounds its output once to bf16 (up to 2^-8 of
# |out| <= max|v| each).
BF16_TOL_OF_MAX_V = 3 * 2 ** -8
LARGE_LOGIT_TOL = 1e-4  # an f32 logit near 200 carries a rounding of up to 1.5e-5
MODEL_TOL = 1e-4
BATCH = 1024  # the serving default max_batch: the shapes the main path runs
# H100 SXM peaks (NVIDIA data sheet, at the 700 W limit): f32 on the CUDA
# cores (the kernel's arithmetic, also for bf16 operands) and HBM3.
PEAK_F32_FLOPS = 67e12
PEAK_BYTES = 3.35e12


def log(msg):
    print(msg, flush=True)


def check(ok, what):
    """Fail the run (an assert would vanish under python -O)."""
    if not ok:
        raise RuntimeError(f"chip_smoke check failed: {what}")


def smi_name_power():
    return subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, timeout=60, check=True).stdout.strip()


def tf32_flags():
    """PyTorch's (matmul, cuDNN) TF32 switches."""
    return torch.backends.cuda.matmul.allow_tf32, torch.backends.cudnn.allow_tf32


def cuda_ms(fn, iters):
    """Mean device time of fn() over `iters` back-to-back runs (CUDA events)."""
    fn()
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(iters):
        fn()
    end.record()
    end.synchronize()
    return start.elapsed_time(end) / iters


def operands(B, H, L, with_bias, dtype, gen):
    q, k, v = (torch.randn(B, H, L, 4, generator=gen) for _ in range(3))
    bias = torch.randn(1, H, L, L, generator=gen) if with_bias else None
    return [None if t is None else t.to("cuda", dtype)
            for t in (q, k, v, bias)]


def bound_terms(B, H, L, with_bias, elt):
    """(operations, bytes) lower bounds in ms for one call: its flops over
    the f32 peak, and q, k, v, o and the bias, each moved once, over HBM
    bandwidth. The call's bound is the larger."""
    flops = 2 * B * H * (2 * L * L * 4 + L * L)
    nbytes = (4 * B * H * L * 4 + (H * L * L if with_bias else 0)) * elt
    return flops / PEAK_F32_FLOPS * 1e3, nbytes / PEAK_BYTES * 1e3


def phase_device_and_build():
    name = torch.cuda.get_device_name(0)
    log(f"[1] device: {name}; nvidia-smi name, power.limit: {smi_name_power()}")
    from ecg_denoise_tpu_torch.kernels import attention

    t0 = time.perf_counter()
    attention._library()  # nvcc from the checkout's sources, ptxas report
    log(f"[1] kernel built and loaded in {time.perf_counter() - t0:.1f} s")
    return name


def phase_kernel_vs_plain():
    from ecg_denoise_tpu_torch import full_float32
    from ecg_denoise_tpu_torch.kernels.attention import (
        attention_reference,
        fused_attention,
    )

    # The plain version's float32 matmuls in full float32 for this phase
    # only: phase 3 checks that the package's entry points set it.
    saved = tf32_flags()
    full_float32()
    gen = torch.Generator().manual_seed(0)
    max_err = {torch.float32: 0.0, torch.bfloat16: 0.0}
    cases = [(BATCH, L, H, b, dt) for (L, H) in STAGES
             for b in (True, False) for dt in (torch.float32, torch.bfloat16)]
    cases += [(3, L, H, True, torch.float32) for (L, H) in STAGES]
    for B, L, H, with_bias, dtype in cases:
        q, k, v, bias = operands(B, H, L, with_bias, dtype, gen)
        out = fused_attention(q, k, v, bias)
        torch.cuda.synchronize()
        err = (out.float() - attention_reference(q, k, v, bias).float()).abs().max().item()
        tol = (F32_TOL if dtype == torch.float32
               else BF16_TOL_OF_MAX_V * v.float().abs().max().item())
        log(f"[2] B={B} L={L} H={H} bias={with_bias} {str(dtype)[6:]}: "
            f"max_abs_err={err:.3e} (tol {tol:.3e})")
        check(out.shape == q.shape and out.dtype == dtype, "kernel output shape or dtype")
        check(err <= tol, "kernel disagrees with its plain version")
        max_err[dtype] = max(max_err[dtype], err)
    # Trained logits reach 191.5 at the L=16 stage: without the row max,
    # exp(190) overflows float32.
    q, k, v, bias = operands(BATCH, 32, 16, True, torch.float32, gen)
    bias = bias + 190.0
    peak = (torch.einsum("bhld,bhmd->bhlm", q, k) + bias).max().item()
    out = fused_attention(q, k, v, bias)
    torch.cuda.synchronize()
    err = (out - attention_reference(q, k, v, bias)).abs().max().item()
    log(f"[2] large logits (max {peak:.1f}) L=16 H=32: max_abs_err={err:.3e} "
        f"(tol {LARGE_LOGIT_TOL:.0e})")
    check(peak > 180 and bool(torch.isfinite(out).all()) and err <= LARGE_LOGIT_TOL,
          "kernel fails at large logits")
    torch.backends.cuda.matmul.allow_tf32, torch.backends.cudnn.allow_tf32 = saved
    return max_err[torch.float32]


def seeded_model(seed):
    """RA-LENet 'full' on the CPU from a seed, with random nonzero rel-pos
    tables, BN affine parameters and BN running stats."""
    from ecg_denoise_tpu_torch.models import build_model
    from ecg_denoise_tpu_torch.utils.seed import random_seed

    gen = random_seed(seed)
    model = build_model("ralenet", device="cpu").eval()
    with torch.no_grad():
        for name, p in model.named_parameters():
            if "relative_position_bias_table" in name:
                p.copy_(torch.randn(p.shape, generator=gen))
        bn = model.conv1[2]
        bn.weight.copy_(1 + 0.1 * torch.randn(bn.weight.shape, generator=gen))
        bn.bias.copy_(0.1 * torch.randn(bn.bias.shape, generator=gen))
        bn.running_mean.copy_(0.1 * torch.randn(bn.running_mean.shape, generator=gen))
        bn.running_var.copy_(0.5 + torch.rand(bn.running_var.shape, generator=gen))
    return model


def phase_model(cpu_model):
    from ecg_denoise_tpu_torch.kernels.attention import fused_attention
    from ecg_denoise_tpu_torch.models import build_model

    before = tf32_flags()
    gpu_model = build_model("ralenet").eval()  # default device: the card
    log(f"[3] TF32 (matmul, cuDNN) before build_model: {before}, after: {tf32_flags()}")
    check(tf32_flags() == (False, False), "the package left TF32 on for the card")
    gpu_model.load_state_dict(cpu_model.state_dict())
    x = torch.from_numpy(np.random.default_rng(1).standard_normal(
        (8, 2, 256)).astype(np.float32))
    with torch.no_grad():
        fused_attention.launches = 0
        y = gpu_model(x.cuda())
        torch.cuda.synchronize()
        launches = fused_attention.launches
        err = (y.cpu() - cpu_model(x)).abs().max().item()
    log(f"[3] RaleNet 'full' depth 2, batch 8, float32: card vs CPU "
        f"max_abs_err={err:.3e} (tol {MODEL_TOL:.0e}); kernel launches per "
        f"forward={launches}")
    check(launches == 18, "the forward did not go through the kernel 18 times")
    check(bool(torch.isfinite(y).all()) and err <= MODEL_TOL,
          "the card's forward disagrees with the CPU's")
    return gpu_model


def _post(url, x):
    buf = io.BytesIO()
    np.save(buf, x)
    with urllib.request.urlopen(urllib.request.Request(url, buf.getvalue()),
                                timeout=300) as r:
        return np.load(io.BytesIO(r.read())), json.loads(
            r.headers.get("X-Denoise-Timing", "{}"))


def phase_serving(cpu_model):
    from ecg_denoise_tpu_torch.cli.serve import make_server
    from ecg_denoise_tpu_torch.kernels.attention import fused_attention
    from ecg_denoise_tpu_torch.serving import Denoiser

    rng = np.random.default_rng(2)
    requests = {n: rng.standard_normal((n, 2, 256)).astype(np.float32)
                for n in (1, 37, BATCH)}
    record = rng.standard_normal((2, 5000)).astype(np.float32)
    with tempfile.TemporaryDirectory() as tmp:
        ckpt = os.path.join(tmp, "ralenet.pt")
        torch.save(cpu_model.state_dict(), ckpt)
        denoiser = Denoiser.from_checkpoint("ralenet", ckpt, max_batch=BATCH)
    denoiser.warmup(limit=BATCH)
    direct = {n: denoiser(x) for n, x in requests.items()}
    direct_record = denoiser.denoise_record(record, stride=128)
    meta = {"model": "ralenet", "ckpt": "ralenet.pt",
            "inference_path": denoiser.inference_path}
    server = make_server(denoiser, meta, port=0)
    thread = threading.Thread(target=server.serve_forever, daemon=True)
    thread.start()
    url = f"http://127.0.0.1:{server.server_address[1]}"
    try:
        fused_attention.launches = 0  # the main path's run starts here
        with urllib.request.urlopen(url + "/healthz", timeout=60) as r:
            health = json.loads(r.read())
        log(f"[4] /healthz: {health}")
        check(health["inference_path"] == "torch+attn-cuda:cuda", "inference path")
        for n, x in requests.items():
            y, timing = _post(url + "/denoise", x)
            err = float(np.abs(y - direct[n]).max())
            log(f"[4] /denoise N={n}: max_abs_err vs Denoiser={err:.3e}; {timing}")
            check(y.shape == x.shape and np.isfinite(y).all() and err <= 1e-6,
                  "/denoise disagrees with Denoiser")
        y, _ = _post(url + "/denoise_record?stride=128", record)
        err = float(np.abs(y - direct_record).max())
        log(f"[4] /denoise_record T={record.shape[1]}: max_abs_err vs "
            f"Denoiser={err:.3e}")
        check(y.shape == record.shape and err <= 1e-6,
              "/denoise_record disagrees with Denoiser")
        launches = fused_attention.launches
    finally:
        server.shutdown()
        server.server_close()
        thread.join(timeout=30)
    # 4 forwards (buckets 1, 64, 1024 and the record's 39 windows in 64).
    log(f"[4] kernel launches on the main path: {launches}")
    check(launches == 4 * 18, "the main path did not go through the kernel")
    check(not thread.is_alive(), "the server thread did not stop")
    return launches


def _timed(fn, *args):
    t0 = time.perf_counter()
    fn(*args)
    return time.perf_counter() - t0


def profile_forward(model, x, fwd_ms, card, iters=3):
    """Device time of one forward by kernel name (torch.profiler), and the
    card's busy share of the unprofiled forward time `fwd_ms`."""
    from torch.profiler import ProfilerActivity, profile

    with torch.no_grad(), profile(
            activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        for _ in range(iters):
            model(x)
        torch.cuda.synchronize()
    kernels = sorted(((e.self_device_time_total / 1e3 / iters, e.count // iters,
                       e.key) for e in prof.key_averages()
                      if e.device_type == torch.autograd.DeviceType.CUDA),
                     reverse=True)
    if not kernels:
        log("[5] the profiler recorded no device kernels: breakdown not measured")
        return
    busy = sum(k[0] for k in kernels)
    log(f"[5] {card}: profiled {str(model.dtype)[6:]} forward B={x.shape[0]} (torch.profiler, "
        f"mean of {iters}): {sum(k[1] for k in kernels)} launches of "
        f"{len(kernels)} kernels, device busy {busy:.3f} ms of the unprofiled "
        f"{fwd_ms:.3f} ms forward (idle {100 * (1 - busy / fwd_ms):.1f} %)")
    for ms, n, name in kernels[:15]:
        log(f"[5]   {ms:8.3f} ms {100 * ms / busy:5.1f} % x{n:<4d} {name[:100]}")


def profile_fresh_thread(denoiser, x, card):
    """Where a call from a fresh thread spends its host time: the operators
    by self CPU time (torch.profiler), for a call on this thread and one on
    a new thread."""
    from torch.profiler import ProfilerActivity, profile

    def run(into):
        with profile(activities=[ProfilerActivity.CPU]) as prof:
            into["ms"] = _timed(denoiser, x) * 1e3
        into["ops"] = sorted(prof.key_averages(), reverse=True,
                             key=lambda e: e.self_cpu_time_total)
    here, fresh = {}, {}
    run(here)
    thread = threading.Thread(target=run, args=(fresh,))
    thread.start()
    thread.join()
    for where, got in (("this thread", here), ("a new thread", fresh)):
        total = sum(e.self_cpu_time_total for e in got["ops"]) / 1e3
        log(f"[5] {card}: profiled 37-window call on {where}: {got['ms']:.3f} ms, "
            f"operators' self CPU time {total:.3f} ms; the top 6:")
        for e in got["ops"][:6]:
            log(f"[5]   {e.self_cpu_time_total / 1e3:8.3f} ms x{e.count:<4d} {e.key[:80]}")


def phase_times(gpu_model, cpu_model, card):
    from ecg_denoise_tpu_torch.kernels.attention import (
        attention_reference,
        fused_attention,
    )
    from ecg_denoise_tpu_torch.models import build_model
    from ecg_denoise_tpu_torch.serving import Denoiser

    bf16_model = build_model("ralenet", dtype=torch.bfloat16).eval()
    bf16_model.load_state_dict(cpu_model.state_dict())
    rng = np.random.default_rng(3)
    for dtype, model in ((torch.float32, gpu_model), (torch.bfloat16, bf16_model)):
        denoiser = Denoiser(model, max_batch=2048)
        for batch in (1024, 2048):
            x = rng.standard_normal((batch, 2, 256)).astype(np.float32)
            y = denoiser(x)
            check(np.isfinite(y).all(), "non-finite Denoiser output")
            walls = []
            for _ in range(10):
                t0 = time.perf_counter()
                denoiser(x)  # ends in torch.cuda.synchronize
                walls.append(time.perf_counter() - t0)
            xd = torch.from_numpy(x).cuda()
            with torch.no_grad():
                fwd_ms = cuda_ms(lambda: model(xd), 10)
            med = statistics.median(walls)
            log(f"[5] {card}: Denoiser {str(dtype)[6:]} batch {batch}: "
                f"{batch / med:.1f} windows/s (median of 10 calls, host clock, "
                f"min {batch / max(walls):.1f} max {batch / min(walls):.1f}); "
                f"device-resident forward {fwd_ms:.3f} ms = "
                f"{batch / fwd_ms * 1e3:.1f} windows/s (CUDA events, mean of 10)")
            if batch == BATCH:
                profile_forward(model, xd, fwd_ms, card)

    # The HTTP front end calls Denoiser from a new thread per connection:
    # the same request timed on this thread and on fresh threads.
    denoiser = Denoiser(gpu_model, max_batch=BATCH)
    x = rng.standard_normal((37, 2, 256)).astype(np.float32)
    denoiser(x)
    walls = {"this thread": [], "a new thread each": []}
    for _ in range(5):
        walls["this thread"].append(_timed(denoiser, x))
        thread = threading.Thread(target=lambda: walls["a new thread each"].append(
            _timed(denoiser, x)))
        thread.start()
        thread.join()
    log(f"[5] {card}: Denoiser float32, 37 windows (bucket 64), median of 5 "
        f"calls, host clock: " + ", ".join(
            f"{k} {statistics.median(v) * 1e3:.3f} ms" for k, v in walls.items()))
    profile_fresh_thread(denoiser, x, card)

    gen = torch.Generator().manual_seed(4)
    totals = {"ms": 0.0, "plain_ms": 0.0, "bound_ms": 0.0, "library_ms": 0.0}
    limits = {"operations": 0.0, "bytes": 0.0}
    for dtype in (torch.float32, torch.bfloat16):
        for (L, H, with_bias), calls in FORWARD_CALLS.items():
            q, k, v, bias = operands(BATCH, H, L, with_bias, dtype, gen)
            ms = cuda_ms(lambda: fused_attention(q, k, v, bias), 20)
            plain = cuda_ms(lambda: attention_reference(q, k, v, bias), 5)
            lib = cuda_ms(lambda: F.scaled_dot_product_attention(
                q, k, v, attn_mask=bias, scale=1.0), 20)
            t_ops, t_bytes = bound_terms(BATCH, H, L, with_bias, q.element_size())
            bnd = max(t_ops, t_bytes)
            # What the bias reads cost: the same operands without the bias.
            no_bias = (f", kernel without the bias {cuda_ms(lambda: fused_attention(q, k, v), 20):.4f} ms"
                       if with_bias else "")
            log(f"[5] {card}: attention_fwd {str(dtype)[6:]} B={BATCH} L={L} "
                f"H={H} bias={with_bias}: kernel {ms:.4f} ms, bound {bnd:.4f} ms "
                f"(operations {t_ops:.4f} at the f32 CUDA-core peak, bytes "
                f"{t_bytes:.4f}), plain {plain:.4f} ms, sdpa {lib:.4f} ms"
                f"{no_bias}; {calls} calls per forward")
            if dtype == torch.float32:
                for key, t in (("ms", ms), ("plain_ms", plain),
                               ("bound_ms", bnd), ("library_ms", lib)):
                    totals[key] += calls * t
                limits["operations"] += calls * t_ops
                limits["bytes"] += calls * t_bytes
    by = max(limits, key=limits.get)
    log(f"[5] {card}: attention_fwd float32, one forward's 18 calls at "
        f"B={BATCH}: kernel {totals['ms']:.4f} ms, bound {totals['bound_ms']:.4f} ms, "
        f"plain {totals['plain_ms']:.4f} ms, sdpa {totals['library_ms']:.4f} ms")
    return totals, by


def main():
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device; this script needs an NVIDIA card",
              file=sys.stderr)
        return 1
    t_start = time.perf_counter()
    name = phase_device_and_build()
    card = smi_name_power()
    max_err = phase_kernel_vs_plain()
    cpu_model = seeded_model(0)
    gpu_model = phase_model(cpu_model)
    launches = phase_serving(cpu_model)
    totals, bound_by = phase_times(gpu_model, cpu_model, card)
    log(f"chip_smoke: all phases passed in {time.perf_counter() - t_start:.1f} s")
    print(json.dumps({"kernels": [{
        "name": "attention_fwd",
        "route": "cuda",
        "source": "ecg_denoise_tpu_torch/kernels/csrc/attention_fwd.cu",
        "replaces": "ecg_denoise_tpu/kernels/attention_pallas.py:253",
        "launches": launches,
        "max_abs_err": max_err,
        "ms": totals["ms"],
        "plain_ms": totals["plain_ms"],
        "bound_ms": totals["bound_ms"],
        "bound_by": bound_by,
        "library_ms": totals["library_ms"],
        "times_are": f"one forward's 18 calls, float32, B={BATCH}",
    }]}), flush=True)
    print(card, flush=True)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": name, "count": torch.cuda.device_count()}}),
        flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
