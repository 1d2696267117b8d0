"""The port's run log, profiling, build cache and version (JAX
counterparts: utils/run_log.py, utils/profiling.py, utils/compile_cache.py,
version.py), on the CPU, as tests/test_aux.py and
tests/test_compile_cache.py hold the JAX package's."""

import json
import os
import time

import pytest
import torch
torch.set_num_threads(1)  # six test workers share the host's cores: one intra-op thread each

import ecg_denoise_tpu
import ecg_denoise_tpu_torch
from ecg_denoise_tpu_torch.kernels import build
from ecg_denoise_tpu_torch.utils.compile_cache import enable_compilation_cache
from ecg_denoise_tpu_torch.utils.profiling import StepTimer, trace
from ecg_denoise_tpu_torch.utils.run_log import train_log


def test_version_is_the_jax_packages():
    assert ecg_denoise_tpu_torch.__version__ == ecg_denoise_tpu.__version__ == "0.1.0"


def test_train_log_records(tmp_path):
    log = str(tmp_path / "log.jsonl")

    @train_log(log)
    def work(x=1, tag="t", device=None):
        return x + 1

    assert work(x=2, tag="hello", device=torch.device("cpu")) == 3
    rec = json.loads(open(log).read().strip())
    assert rec["fn"] == "work" and rec["status"] == "ok" and rec["wall_s"] >= 0
    assert rec["kwargs"] == {"x": 2, "tag": "hello"}  # a device is not of record


def test_train_log_records_a_failure_and_reraises(tmp_path):
    log = str(tmp_path / "log.jsonl")

    @train_log(log)
    def work():
        raise ValueError("bad split")

    with pytest.raises(ValueError, match="bad split"):
        work()
    assert json.loads(open(log).read())["status"] == "error: ValueError: bad split"


def test_train_log_notify_hook(tmp_path, monkeypatch):
    """ECG_NOTIFY_CMD gets the finished record on its standard input; a
    hook that cannot run does not fail the run."""
    log = str(tmp_path / "log.jsonl")
    sink = tmp_path / "notified.json"
    monkeypatch.setenv("ECG_NOTIFY_CMD", f"cat > {sink}")

    @train_log(log)
    def work(x=1):
        return x

    assert work(x=5) == 5
    for _ in range(100):  # the hook runs detached
        if sink.exists() and sink.read_text().strip():
            break
        time.sleep(0.05)
    rec = json.loads(sink.read_text())
    assert rec["fn"] == "work" and rec["kwargs"] == {"x": 5}
    monkeypatch.setenv("ECG_NOTIFY_CMD", "/nonexistent-notifier-binary")
    assert work(x=6) == 6


def test_step_timer_discards_warmup():
    t = StepTimer(warmup=1)
    for i in range(3):
        with t.step() as h:
            h.result = {"y": torch.ones(4) * i, "z": (torch.zeros(2),)}
    assert len(t.times) == 2 and t.mean() > 0
    assert StepTimer().mean() == 0.0


def test_trace_writes_a_chrome_trace_on_the_cpu(tmp_path):
    logdir = tmp_path / "trace"
    with trace(str(logdir)):
        torch.nn.functional.conv1d(torch.randn(2, 2, 64), torch.randn(4, 2, 3))
    events = json.loads((logdir / "trace.json").read_text())["traceEvents"]
    assert any("conv" in e.get("name", "") for e in events)


def test_enable_compilation_cache_moves_the_kernel_builds(tmp_path, monkeypatch):
    """The default is kernels/_build/ beside the sources; a directory given
    is created and later builds go there."""
    monkeypatch.setattr(build, "BUILD_DIR", build.BUILD_DIR)
    default = os.path.join(os.path.dirname(build.__file__), "_build")
    assert enable_compilation_cache() == default and os.path.isdir(default)
    cache_dir = str(tmp_path / "kernels")
    assert enable_compilation_cache(cache_dir) == cache_dir
    assert os.path.isdir(cache_dir)
    assert str(build._target("null_copy", build.CSRC)).startswith(cache_dir)
    assert enable_compilation_cache() == cache_dir  # idempotent
