"""Profiling hooks (JAX counterpart: utils/profiling.py; the reference
times only by wall-clock deltas in a tqdm postfix, denoise_train.py:35-64).

* `trace(logdir)`: a context manager around `torch.profiler` that records
  the host's operators and, where a card is present, its kernels, and
  writes a Chrome trace (`trace.json`, loadable in chrome://tracing or
  Perfetto) under `logdir`.
* `StepTimer`: step times that include the device's work, with warmup
  steps discarded. Where JAX calls `block_until_ready` on a step's result,
  this synchronises the card the result lies on.
"""

from __future__ import annotations

import contextlib
import os
import time
from typing import Any, Iterator, Optional

import torch


@contextlib.contextmanager
def trace(logdir: str = "./ecg_denoise_trace") -> Iterator[torch.profiler.profile]:
    """`with trace('/tmp/t'): step(...)` writes `<logdir>/trace.json`."""
    activities = [torch.profiler.ProfilerActivity.CPU]
    if torch.cuda.is_available():
        activities.append(torch.profiler.ProfilerActivity.CUDA)
    os.makedirs(logdir, exist_ok=True)
    with torch.profiler.profile(activities=activities) as prof:
        yield prof
    prof.export_chrome_trace(os.path.join(logdir, "trace.json"))


def _synchronize(result: Any) -> None:
    """Wait for the device work behind `result` (a tensor, or a tuple,
    list or dict of them) on every card it lies on."""
    if isinstance(result, torch.Tensor):
        if result.is_cuda:
            torch.cuda.synchronize(result.device)
    elif isinstance(result, dict):
        for v in result.values():
            _synchronize(v)
    elif isinstance(result, (tuple, list)):
        for v in result:
            _synchronize(v)


class StepTimer:
    """Step times in seconds, the device's work included.

    Usage:
        timer = StepTimer(warmup=2)
        for _ in range(n):
            with timer.step() as t:
                out = step_fn(...)
                t.result = out      # synchronised before the clock stops
        timer.mean()  # seconds a step over the steps after the warmup
    """

    def __init__(self, warmup: int = 2):
        self.warmup = warmup
        self.times: list[float] = []
        self._seen = 0

    @contextlib.contextmanager
    def step(self):
        class _Holder:
            result: Optional[Any] = None

        holder = _Holder()
        t0 = time.perf_counter()
        yield holder
        if holder.result is not None:
            _synchronize(holder.result)
        dt = time.perf_counter() - t0
        self._seen += 1
        if self._seen > self.warmup:
            self.times.append(dt)

    def mean(self) -> float:
        return sum(self.times) / max(len(self.times), 1)
