"""What bounds B5's mma template on the card (`csrc/attention_dense_fwd.cu`,
`attention_dense_fwd_mma_kernel`): the instructions or the bytes.

    python -m ecg_denoise_tpu_torch.probes.dense_bound

On the card only (it raises without one), at Transformer1d's two packable
stages, (L, H) = (64, 16) and (32, 32), D = 32, B = 256, no bias, f32 and
bf16, in µs per call from CUDA graph replays in turns (in order, then in
reverse), prints:

* the kernel;
* the kernel with its loads removed (`VARIANTS["no_loads"]`): every unit
  after the first two computed on the rows already in the ring, so that
  only its instructions and stores are left;
* the kernel with its products removed (`VARIANTS["no_products"]`): every
  warp stores its rows of the output without computing, so that only its
  loads, stores and barriers are left;
* B1 without lse on the same call, and a streaming pass of PyTorch's over
  three quarters of the call's bytes (`torch.add(q, k, out=o)`), the rate
  device memory gives a plain copy;
* the bound: q, k, v and o moved once over 3.35 TB/s.

The variants are the package's own source with one edit each, applied by
exact text (`variant_source` raises if the source no longer holds the
text), built under `kernels/_build/` by `build.load` and loaded by this
probe alone: nothing on a path calls them, and no launch count moves.
"""

from __future__ import annotations

import statistics
import subprocess

import torch

from ecg_denoise_tpu_torch.probes.floor import graph_us, require_card

STAGES = ((64, 16), (32, 32))  # Transformer1d's packable (L, H) at 256 samples
D = 32
BATCH = 256
PEAK_BYTES = 3.35e12
CALLS = 20

# Each variant: (the text in attention_dense_fwd.cu, what replaces it).
VARIANTS = {
    "no_loads": (
        "    if (it < n_mine) {\n      size_t row0;",
        "    if (it < n_mine && it < kStages) {\n      size_t row0;"),
    "no_products": (
        "    // S = q.k^T over the span, a 16 x span strip in C fragments.\n",
        "    {\n"
        "      T* z = o + (row0 + r0) * D + 2 * tq;\n"
        "      for (int d = 0; d < D / 8; ++d) {\n"
        "        if (r0 < n) store2(z + 8 * d, 0.f, 0.f);\n"
        "        if (r1 < n) store2(z + 8 * D + 8 * d, 0.f, 0.f);\n"
        "      }\n"
        "      continue;\n"
        "    }\n"
        "    // S = q.k^T over the span, a 16 x span strip in C fragments.\n"),
}


def variant_source(name: str) -> str:
    """attention_dense_fwd.cu with variant `name`'s edit applied."""
    from ecg_denoise_tpu_torch.kernels.build import CSRC

    src = (CSRC / "attention_dense_fwd.cu").read_text()
    old, new = VARIANTS[name]
    if src.count(old) != 1:
        raise RuntimeError(f"attention_dense_fwd.cu no longer holds variant {name}'s text")
    return src.replace(old, new)


def _variant_library(name: str):
    """Variant `name` built from its edited source (a directory of its own
    under the build directory) and bound like B5's library."""
    from ecg_denoise_tpu_torch.kernels.attention import bind
    from ecg_denoise_tpu_torch.kernels.build import BUILD_DIR

    csrc = BUILD_DIR / "variants" / name
    csrc.mkdir(parents=True, exist_ok=True)
    (csrc / "attention_dense_fwd.cu").write_text(variant_source(name))
    return bind("attention_dense_fwd", "ecg_attention_dense_fwd", 5, 7, csrc=csrc)


def _call(lib, q, k, v):
    """One call of a B5 library, no bias; no count moves."""
    from ecg_denoise_tpu_torch.kernels.attention import DTYPE_CODES, ptr, raise_on
    from ecg_denoise_tpu_torch.kernels.attention_dense import dense_pack_factor

    B, H, L, d = q.shape
    o = torch.empty_like(q)
    err = lib.ecg_attention_dense_fwd(ptr(q), ptr(k), ptr(v), None, ptr(o), B, H, L, d,
                                      dense_pack_factor(H, L), DTYPE_CODES[q.dtype],
                                      q.device.index, torch.cuda.current_stream().cuda_stream)
    raise_on(lib, err, "dense attention forward (probe)")
    return o


def main() -> dict:
    require_card()
    card = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                          capture_output=True, text=True, timeout=60, check=True).stdout.strip()

    from concurrent.futures import ThreadPoolExecutor

    from ecg_denoise_tpu_torch.kernels import attention, attention_dense

    with ThreadPoolExecutor(len(VARIANTS) + 2) as pool:
        futures = {name: pool.submit(_variant_library, name) for name in VARIANTS}
        this = pool.submit(attention_dense._library)
        pool.submit(attention._library).result()
        libs = {"kernel": this.result(), **{n: f.result() for n, f in futures.items()}}
    gen = torch.Generator().manual_seed(0)
    rows = []
    for dtype in (torch.float32, torch.bfloat16):
        for L, H in STAGES:
            q, k, v = (torch.randn(BATCH, H, L, D, generator=gen).to("cuda", dtype)
                       for _ in range(3))
            q = q * D ** -0.5
            o = torch.empty_like(q)
            names = [*libs, "b1", "torch_add"]
            fns = [*(lambda lib=lib: _call(lib, q, k, v) for lib in libs.values()),
                   lambda: attention._launch(q, k, v, None),
                   lambda: torch.add(q, k, out=o)]
            got = [[] for _ in fns]
            for i in [*range(len(fns)), *reversed(range(len(fns)))]:
                got[i].append(graph_us(fns[i], CALLS))
            row = {"dtype": str(dtype)[6:], "L": L, "H": H,
                   **{n: statistics.mean(us) for n, us in zip(names, got)},
                   "bound_us": 4 * q.numel() * q.element_size() / PEAK_BYTES * 1e6}
            add_rate = 3 * q.numel() * q.element_size() / row["torch_add"] / 1e3  # GB/s
            print(f"[dense_bound] {card}: {row['dtype']} B={BATCH} L={L} H={H} D={D}: kernel "
                  f"{row['kernel']:.1f} us, loads removed {row['no_loads']:.1f}, products "
                  f"removed {row['no_products']:.1f}, B1 without lse {row['b1']:.1f}, bound "
                  f"{row['bound_us']:.1f} (bytes); torch.add over 3/4 of the bytes "
                  f"{row['torch_add']:.1f} us, {add_rate:.0f} GB/s ({CALLS} calls a graph "
                  "replay, in turns, mean of 2)", flush=True)
            rows.append(row)
    return {"card": card, "rows": rows}


if __name__ == "__main__":
    main()
