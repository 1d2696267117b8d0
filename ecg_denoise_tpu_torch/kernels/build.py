"""Builds the port's CUDA sources at first use and binds them with ctypes.

Each `csrc/<name>.cu` has a plain C interface and compiles on its own with
`nvcc -gencode arch=compute_90a,code=sm_90a -O3 -shared -Xcompiler -fPIC`
into `_build/<name>-<hash>.so` (the directory is git-ignored). The hash
covers the source and the flags, so an edited source never loads a stale
library. Only the sources in this checkout are built; nothing is fetched.
Each build prints nvcc's `-Xptxas -v` report (registers, shared memory,
spills) once.

Building needs nvcc, which only the machine with the card has; the CPU
paths of the port never call into this module.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import subprocess
import threading
from pathlib import Path

CSRC = Path(__file__).resolve().parent / "csrc"
BUILD_DIR = Path(__file__).resolve().parent / "_build"
NVCC_FLAGS = ["-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17", "-O3",
              "-shared", "-Xcompiler", "-fPIC", "-Xptxas", "-v"]

_lock = threading.Lock()
_libs: dict[str, ctypes.CDLL] = {}


def _nvcc() -> str:
    from torch.utils.cpp_extension import CUDA_HOME

    if CUDA_HOME is None:
        raise RuntimeError("no CUDA toolkit found (set CUDA_HOME); the port's "
                           "kernels are built with nvcc at first use")
    return os.path.join(CUDA_HOME, "bin", "nvcc")


def _target(name: str) -> Path:
    src = (CSRC / f"{name}.cu").read_bytes()
    digest = hashlib.sha256(src + " ".join(NVCC_FLAGS).encode()).hexdigest()
    return BUILD_DIR / f"{name}-{digest[:16]}.so"


def _build(name: str) -> Path:
    """Compile `csrc/<name>.cu` unless it is built already; raises with
    nvcc's output if the build fails."""
    out = _target(name)
    if out.exists():
        return out
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    tmp = out.with_name(f"{out.stem}.{os.getpid()}.tmp.so")
    cmd = [_nvcc(), *NVCC_FLAGS, "-o", str(tmp), str(CSRC / f"{name}.cu")]
    proc = subprocess.run(cmd, stdout=subprocess.PIPE, stderr=subprocess.STDOUT,
                          text=True, check=False)
    if proc.returncode != 0:
        raise RuntimeError(f"nvcc failed for {name}.cu:\n{proc.stdout}")
    os.replace(tmp, out)  # atomic: a concurrent build never sees half a file
    print(f"[build] {name}.cu -> {out.name}\n{proc.stdout.rstrip()}", flush=True)
    return out


def load(name: str) -> ctypes.CDLL:
    """The ctypes handle of `csrc/<name>.cu`, built at first use."""
    with _lock:
        lib = _libs.get(name)
        if lib is None:
            lib = ctypes.CDLL(str(_build(name)))
            _libs[name] = lib
        return lib
