"""The build cache of the port's kernels (JAX counterpart:
utils/compile_cache.py, which turns on JAX's persistent compilation cache).

The port compiles its CUDA sources with nvcc at first use and keeps each
library under a hash of its source and flags (`kernels/build.py`'s
`BUILD_DIR`, by default `kernels/_build/` beside the sources), so a rerun
of any entry point finds its kernels built. That directory is the port's
persistent cache; the CLIs call `enable_compilation_cache` where the JAX
package's call theirs.
"""

from __future__ import annotations

import os
from pathlib import Path


def enable_compilation_cache(cache_dir: str | None = None) -> str:
    """The directory the kernels are built into, created; given
    `cache_dir`, later builds go there instead (idempotent)."""
    from ecg_denoise_tpu_torch.kernels import build

    if cache_dir is not None:
        build.BUILD_DIR = Path(os.path.abspath(cache_dir))
    os.makedirs(build.BUILD_DIR, exist_ok=True)
    return str(build.BUILD_DIR)
