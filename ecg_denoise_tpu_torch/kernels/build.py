"""Builds the port's CUDA sources at first use and binds them with ctypes.

Each `csrc/<name>.cu` has a plain C interface and compiles on its own with
`nvcc -gencode arch=compute_90a,code=sm_90a -O3 -shared -Xcompiler -fPIC`
into `_build/<name>-<hash>.so` (the directory is git-ignored). The hash
covers the source, every header it includes from `csrc/` (`#include
"<name>.cuh"`, followed through the headers) and the flags, so an edited
source or header never loads a stale library. Only the sources in this
checkout are built; nothing is fetched.
Each build prints nvcc's `-Xptxas -v` report (registers, shared memory,
spills) once. Each library (source and flags, by their hash) has its own
lock, so loads of different sources from different threads build at once,
one nvcc each, and two directories holding the same source share one
build and one library.

Building needs nvcc, which only the machine with the card has; the CPU
paths of the port never call into this module.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import re
import subprocess
import threading
from pathlib import Path

CSRC = Path(__file__).resolve().parent / "csrc"
BUILD_DIR = Path(__file__).resolve().parent / "_build"
NVCC_FLAGS = ["-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17", "-O3",
              "-shared", "-Xcompiler", "-fPIC", "-Xptxas", "-v"]

_INCLUDE = re.compile(rb'^[ \t]*#[ \t]*include[ \t]+"([^"]+)"', re.MULTILINE)
_lock = threading.Lock()  # guards _locks
_locks: dict[Path, threading.Lock] = {}  # by built library path
_libs: dict[Path, ctypes.CDLL] = {}


def _nvcc() -> str:
    from torch.utils.cpp_extension import CUDA_HOME

    if CUDA_HOME is None:
        raise RuntimeError("no CUDA toolkit found (set CUDA_HOME); the port's "
                           "kernels are built with nvcc at first use")
    return os.path.join(CUDA_HOME, "bin", "nvcc")


def sources(name: str, csrc: Path) -> list[Path]:
    """`<csrc>/<name>.cu` and every file it includes by a quoted name, the
    includes of those too, each once, in the order they are found."""
    found, todo = [], [csrc / f"{name}.cu"]
    while todo:
        path = todo.pop(0)
        if path not in found:
            found.append(path)
            todo += [path.parent / m.decode() for m in _INCLUDE.findall(path.read_bytes())]
    return found


def _target(name: str, csrc: Path) -> Path:
    text = b"".join(path.read_bytes() for path in sources(name, csrc))
    digest = hashlib.sha256(text + " ".join(NVCC_FLAGS).encode()).hexdigest()
    return BUILD_DIR / f"{name}-{digest[:16]}.so"


def _build(name: str, csrc: Path) -> Path:
    """Compile `<csrc>/<name>.cu` unless it is built already; raises with
    nvcc's output if the build fails."""
    out = _target(name, csrc)
    if out.exists():
        return out
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    tmp = out.with_name(f"{out.stem}.{os.getpid()}.tmp.so")
    cmd = [_nvcc(), *NVCC_FLAGS, "-o", str(tmp), str(csrc / f"{name}.cu")]
    proc = subprocess.run(cmd, stdout=subprocess.PIPE, stderr=subprocess.STDOUT,
                          text=True, check=False)
    if proc.returncode != 0:
        raise RuntimeError(f"nvcc failed for {name}.cu:\n{proc.stdout}")
    os.replace(tmp, out)  # atomic: a concurrent build never sees half a file
    print(f"[build] {name}.cu -> {out.name}\n{proc.stdout.rstrip()}", flush=True)
    return out


def load(name: str, csrc: Path = CSRC) -> ctypes.CDLL:
    """The ctypes handle of `<csrc>/<name>.cu`, built at first use. `csrc`
    is the package's own sources but for a timing yardstick (an earlier
    version of a kernel, unpacked elsewhere), which nothing on a path loads."""
    target = _target(name, Path(csrc))
    with _lock:
        lock = _locks.setdefault(target, threading.Lock())
    with lock:
        lib = _libs.get(target)
        if lib is None:
            lib = ctypes.CDLL(str(_build(name, Path(csrc))))
            _libs[target] = lib
        return lib
