"""The instructions B3's window kernel issues a (row, key) pair, from the
SASS the compiler left.

    python -m ecg_denoise_tpu_torch.probes.sass_mix

Builds `attention_rpos_fwd.cu` from this checkout (nvcc; no card needed),
disassembles it (`cuobjdump -sass`) and reads the f32, D = 4 instantiation
of `attention_rpos_fwd_mma_kernel`: the tile loop's compute body runs from
the loop's first HMMA to its back edge (the backward branch with the widest
span); a forward branch whose skipped range holds a global load (the toep
bias, where the window meets the tile) or an FSEL to -INF (the keys past L,
on the last tile) is a rare path and left out. A (row, key) pair is a
thread's 2/3 of an HMMA there (q.k^T's m16n8k4 and p.v's m16n8k8 at three
passes each: 6 HMMA a thread's 4 pairs of an 8-key n-tile). Prints, and
returns, {"per_pair": {opcode: count}, "pairs_a_tile": n, "total_per_pair":
x, "tile_staging": count}: tile_staging is the instructions before the body
in the loop (the wait, the barriers, the split into TF32 halves and the
next copies, as written: loops counted once), per thread and tile.

The reading rests on the loop's shape as this compiler lays it out; where
that shape is not found it raises rather than guess.
"""

from __future__ import annotations

import json
import os
import re
import subprocess

KERNEL = "rpos_fwd_mma_kernelIfLi4E"  # f32, D = 4
_BRANCH = re.compile(r"(@!?U?P\w+\s+)?BRA(\.\w+)*\s+(?:`\(\.L_x_\d+\)|0x([0-9a-f]+))")


def loop_mix(sass: str) -> dict:
    """The per-pair instruction mix of KERNEL's tile loop in `sass`."""
    parts = [p for p in sass.split("Function : ")[1:] if KERNEL in p.split(None, 1)[0]]
    if len(parts) != 1:
        raise RuntimeError(f"{len(parts)} functions named like {KERNEL} in the SASS")
    ins = [(int(a, 16), t.strip()) for a, t in
           re.findall(r"/\*([0-9a-f]{4,})\*/\s+([^;]*);", parts[0])]
    targets = []
    for a, t in ins:
        m = _BRANCH.search(t)
        if m and m.group(3):
            targets.append((a, int(m.group(3), 16), bool(m.group(1))))
    back = [(tgt, a) for a, tgt, _ in targets if tgt < a]
    if not back:
        raise RuntimeError(f"no backward branch in {KERNEL}'s SASS")
    lo, hi = max(back, key=lambda r: r[1] - r[0])
    hmma = [a for a, t in ins if lo <= a <= hi and t.startswith("HMMA")]
    if not hmma:
        raise RuntimeError(f"no HMMA inside {KERNEL}'s widest loop")
    start = hmma[0]
    rare = set()
    for a, tgt, cond in targets:
        if cond and start <= a < tgt <= hi:
            skipped = [t for x, t in ins if a < x < tgt]
            if any("LDG" in t or ("FSEL" in t and "-INF" in t) for t in skipped):
                rare.update(x for x, _ in ins if a < x < tgt)
    body = [t for a, t in ins if start <= a <= hi and a not in rare]
    ops = {}
    for t in body:
        op = re.sub(r"^@!?U?P\w+\s+", "", t).split()[0].split(".")[0]
        ops[op] = ops.get(op, 0) + 1
    pairs = ops["HMMA"] * 2 / 3
    return {"per_pair": {k: v / pairs for k, v in sorted(ops.items(), key=lambda kv: -kv[1])},
            "pairs_a_tile": pairs, "total_per_pair": len(body) / pairs,
            "tile_staging": sum(1 for a, _ in ins if lo <= a < start)}


def main() -> dict:
    from ecg_denoise_tpu_torch.kernels.build import CSRC, _build, _nvcc

    lib = _build("attention_rpos_fwd", CSRC)
    tool = os.path.join(os.path.dirname(_nvcc()), "cuobjdump")
    sass = subprocess.run([tool, "-sass", str(lib)], capture_output=True, text=True,
                          timeout=300, check=True).stdout
    mix = loop_mix(sass)
    print(f"[sass_mix] B3's window kernel, f32 D = 4, its tile loop's compute body: "
          f"{mix['total_per_pair']:.2f} instructions a (row, key) pair ("
          + ", ".join(f"{k} {v:.3f}" for k, v in mix["per_pair"].items())
          + f"), {mix['pairs_a_tile']:.0f} pairs a thread a tile; before the body "
          f"{mix['tile_staging']} instructions a tile (the wait, barriers, split and "
          "copies, loops once)", flush=True)
    print(json.dumps(mix), flush=True)
    return mix


if __name__ == "__main__":
    main()
