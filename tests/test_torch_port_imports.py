"""The port imports nothing of JAX and nothing of the JAX package.

Every module of `ecg_denoise_tpu_torch` is imported in a fresh interpreter
in which `jax`, `flax`, `optax`, `msgpack` (the card's machine has none of
them; the port decodes the JAX package's checkpoints itself) and
`ecg_denoise_tpu` (and their submodules, should the interpreter have
loaded any) are blocked: their
entries in `sys.modules` are None, so importing them raises ImportError.
The module list is read from the file tree, so every worker collects the
same tests.
"""

import json
import subprocess
import sys
from pathlib import Path

import pytest
import torch
torch.set_num_threads(1)  # six test workers share the host's cores: one intra-op thread each

REPO = Path(__file__).resolve().parents[1]
PACKAGE = REPO / "ecg_denoise_tpu_torch"
BLOCKED = ("jax", "jaxlib", "flax", "optax", "msgpack", "ecg_denoise_tpu")


def _modules():
    names = []
    for path in sorted(PACKAGE.rglob("*.py")):
        parts = path.relative_to(REPO).with_suffix("").parts
        if parts[-1] == "__init__":
            parts = parts[:-1]
        names.append(".".join(parts))
    return names


MODULES = _modules()

_PROBE = """
import importlib, json, sys, traceback
blocked = {blocked!r}
for name in list(sys.modules):
    if name.split(".")[0] in blocked:
        sys.modules[name] = None
for name in blocked:
    sys.modules[name] = None
results = {{}}
for name in {modules!r}:
    try:
        importlib.import_module(name)
        results[name] = None
    except Exception:
        results[name] = traceback.format_exc()
print(json.dumps(results))
"""


@pytest.fixture(scope="module")
def import_results():
    proc = subprocess.run(
        [sys.executable, "-c", _PROBE.format(blocked=BLOCKED, modules=MODULES)],
        cwd=REPO, capture_output=True, text=True, timeout=300, check=True)
    return json.loads(proc.stdout.strip().splitlines()[-1])


def test_the_package_has_its_modules():
    for name in ("ecg_denoise_tpu_torch.cli.main", "ecg_denoise_tpu_torch.train.loop",
                 "ecg_denoise_tpu_torch.kernels.attention",
                 "ecg_denoise_tpu_torch.data.dataset", "ecg_denoise_tpu_torch.serving",
                 "ecg_denoise_tpu_torch.models.resnet_cls",
                 "ecg_denoise_tpu_torch.models.transformer1d",
                 "ecg_denoise_tpu_torch.metrics.cls", "ecg_denoise_tpu_torch.train.cls_steps",
                 "ecg_denoise_tpu_torch.cli.train_cls", "ecg_denoise_tpu_torch.cli.test_cls",
                 "ecg_denoise_tpu_torch.interop.flax_msgpack",
                 "ecg_denoise_tpu_torch.version", "ecg_denoise_tpu_torch.parallel",
                 "ecg_denoise_tpu_torch.parallel.mesh",
                 "ecg_denoise_tpu_torch.parallel.multihost",
                 "ecg_denoise_tpu_torch.utils.run_log",
                 "ecg_denoise_tpu_torch.utils.profiling",
                 "ecg_denoise_tpu_torch.utils.compile_cache"):
        assert name in MODULES


@pytest.mark.parametrize("module", MODULES)
def test_module_imports_without_jax(import_results, module):
    assert import_results[module] is None, import_results[module]
