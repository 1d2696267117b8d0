"""The precision probes (JAX counterparts: `dot_kernel`, `fold_kernel`,
`tree_kernel` and `div_kernel` of scripts/probe_precision.py).

Four wrappers over the kernels of `csrc/precision_probe.cu`:

* `probe_dot(a, b, precision)`: a (M, K) . b (K, N), f32 out;
* `probe_fold(logits, v, precision)`: softmax(logits (L, L)) . v (D, L)^T as
  (D, L), the row sum folded into the product as a ones row of v;
* `probe_tree(logits, v)`: the same with the row sum taken first, as a tree,
  and the product in f32 on the CUDA cores;
* `probe_div(n, d)`: n / d elementwise.

`precision` is one of `PRECISIONS`: "ieee" (f32 FMAs on the CUDA cores),
"tf32" (one TF32 tensor-core pass on inputs rounded to nearest, ties away),
"tf32x3" (x = hi + lo in TF32, three passes) and "bf16" (one bf16 pass on
inputs rounded to nearest even), each with f32 accumulation.

On a CUDA tensor a wrapper launches its kernel or raises; on a CPU tensor
it takes its plain version (`dot_plain`, `fold_plain`, `tree_plain`,
`div_plain`), which rounds the inputs as the kernel's path does and takes
the product in float64, cast once to f32. The plain versions run on either
device and nothing on the card's path calls them. Each wrapper counts its
kernel launches in `.launches` (a plain int). Operands are contiguous 2-D
float32 tensors; the wrappers raise on anything else.
"""

from __future__ import annotations

import functools

import torch

from ecg_denoise_tpu_torch.kernels.attention import bind, ptr, raise_on

PRECISIONS = ("ieee", "tf32", "tf32x3", "bf16")
MAX_L = 1024  # the softmax probes' row length (the kernels' shared buffers)
MAX_D = 15  # D + 1 rows of [v; ones] fill at most one 16-row mma tile
F32_UNIT_ROUNDOFF = 2.0 ** -24


@functools.cache
def _library():
    """The kernels' library, built at first use."""
    bind("precision_probe", "ecg_probe_dot", 3, 5)  # M, N, K, precision, device
    bind("precision_probe", "ecg_probe_fold", 3, 4)  # L, D, precision, device
    bind("precision_probe", "ecg_probe_tree", 3, 3)  # L, D, device
    return bind("precision_probe", "ecg_probe_div", 3, 2)  # count, device


# --- plain versions ----------------------------------------------------------

def round_tf32_rna(x: torch.Tensor) -> torch.Tensor:
    """float32 x rounded to TF32 (10 mantissa bits), to nearest with ties
    away from zero, as `cvt.rna.tf32.f32`: add half a TF32 step to the bit
    pattern and clear the 13 dropped bits. inf and NaN are left alone."""
    finite = torch.isfinite(x)
    bits = torch.where(finite, x, 0.0).view(torch.int32)
    rounded = ((bits + 0x1000) & -0x2000).view(torch.float32)
    return torch.where(finite, rounded, x)


def split_tf32x3(x: torch.Tensor) -> tuple[torch.Tensor, torch.Tensor]:
    """x = hi + lo with hi = tf32(x) and lo = tf32(x - hi); x - hi is exact."""
    hi = round_tf32_rna(x)
    return hi, round_tf32_rna(x - hi)


def round_bf16(x: torch.Tensor) -> torch.Tensor:
    """float32 x rounded to bf16 (to nearest even), back in float32."""
    return x.to(torch.bfloat16).to(torch.float32)


def _check_precision(precision: str) -> None:
    if precision not in PRECISIONS:
        raise ValueError(f"precision must be one of {PRECISIONS}, got {precision!r}")


def dot_terms(a: torch.Tensor, b: torch.Tensor, precision: str):
    """The (a part, b part) pairs whose products the path sums: the rounded
    inputs, or for tf32x3 hi.hi, hi.lo and lo.hi."""
    _check_precision(precision)
    if precision == "tf32x3":
        (ah, al), (bh, bl) = split_tf32x3(a), split_tf32x3(b)
        return [(ah, bh), (ah, bl), (al, bh)]
    rnd = {"ieee": lambda t: t, "tf32": round_tf32_rna, "bf16": round_bf16}[precision]
    return [(rnd(a), rnd(b))]


def dot_plain(a: torch.Tensor, b: torch.Tensor, precision: str = "ieee") -> torch.Tensor:
    """a . b on the path's rounded inputs, in float64, cast once to f32."""
    return sum(x.double() @ y.double() for x, y in dot_terms(a, b, precision)).float()


def dot_tolerance(a: torch.Tensor, b: torch.Tensor, precision: str) -> torch.Tensor:
    """Elementwise bound on |kernel - plain| for the dot: c K u (|A_r| . |B_r|),
    A_r and B_r the rounded inputs, u = 2^-24, c the number of products
    summed per k (1, or 3 for tf32x3). The products of rounded inputs are
    exact in f32, so the f32 accumulation order is the only difference; its
    K roundings per product each cost at most u of the partial sum."""
    terms = dot_terms(a, b, precision)
    mags = sum(x.double().abs() @ y.double().abs() for x, y in terms)
    return len(terms) * a.shape[1] * F32_UNIT_ROUNDOFF * mags


def _softmax_exp(logits: torch.Tensor) -> torch.Tensor:
    return torch.exp(logits - logits.amax(dim=-1, keepdim=True))


def fold_plain(logits: torch.Tensor, v: torch.Tensor, precision: str = "ieee") -> torch.Tensor:
    """(D, L): of = [v; ones] . en^T at the path's rounding (`dot_plain`),
    en = exp(logits - row max) in f32, then of[:D] / of[D] in f32."""
    D, L = v.shape
    vx = torch.cat([v, torch.ones(1, L, dtype=v.dtype, device=v.device)])
    of = dot_plain(vx, _softmax_exp(logits).T, precision)
    return of[:D] / of[D:]


def tree_plain(logits: torch.Tensor, v: torch.Tensor) -> torch.Tensor:
    """(D, L): p = e / sum(e) in f32, then v . p^T (`dot_plain`, ieee)."""
    e = _softmax_exp(logits)
    return dot_plain(v, (e / e.sum(dim=-1, keepdim=True)).T)


def div_plain(n: torch.Tensor, d: torch.Tensor) -> torch.Tensor:
    return n / d


# --- wrappers --------------------------------------------------------------

def _check(what: str, *tensors: torch.Tensor) -> None:
    """Raise on what the kernels do not take: other dtypes or devices,
    strided or non-2-D operands, operands on two devices."""
    for t in tensors:
        if t.dtype != torch.float32:
            raise TypeError(f"{what} takes float32, got {t.dtype}")
        if t.device.type not in ("cpu", "cuda") or t.device != tensors[0].device:
            raise ValueError(f"{what} takes operands on one CPU or CUDA device")
        if t.dim() != 2 or not t.is_contiguous() or not 0 < t.numel() < 2**31:
            raise ValueError(f"{what} takes contiguous 2-D operands of 1 to 2**31 - 1 "
                             f"elements, got {tuple(t.shape)} with strides {t.stride()}")


def _check_softmax(what: str, logits: torch.Tensor, v: torch.Tensor) -> tuple[int, int]:
    _check(what, logits, v)
    D, L = v.shape
    if logits.shape != (L, L) or not (1 <= L <= MAX_L and 1 <= D <= MAX_D):
        raise ValueError(f"{what} takes logits (L, L) and v (D, L) with L <= {MAX_L} "
                         f"and D <= {MAX_D}, got {tuple(logits.shape)} and {tuple(v.shape)}")
    return L, D


def _stream(x: torch.Tensor) -> int:
    return torch.cuda.current_stream(x.device).cuda_stream


def probe_dot(a: torch.Tensor, b: torch.Tensor, precision: str) -> torch.Tensor:
    """a (M, K) . b (K, N) at `precision` (see the module docstring)."""
    _check_precision(precision)
    _check("probe_dot", a, b)
    (M, K), (K2, N) = a.shape, b.shape
    if K != K2 or M * N >= 2**31:
        raise ValueError(f"probe_dot cannot multiply {tuple(a.shape)} by {tuple(b.shape)}")
    if a.device.type == "cpu":
        return dot_plain(a, b, precision)
    lib = _library()
    c = torch.empty(M, N, dtype=torch.float32, device=a.device)
    err = lib.ecg_probe_dot(ptr(a), ptr(b), ptr(c), M, N, K, PRECISIONS.index(precision),
                            a.device.index, _stream(a))
    raise_on(lib, err, "precision probe dot")
    probe_dot.launches += 1
    return c


def probe_fold(logits: torch.Tensor, v: torch.Tensor, precision: str) -> torch.Tensor:
    """softmax(logits) . v^T as (D, L), the row sum folded into the product
    at `precision`."""
    _check_precision(precision)
    L, D = _check_softmax("probe_fold", logits, v)
    if logits.device.type == "cpu":
        return fold_plain(logits, v, precision)
    lib = _library()
    o = torch.empty(D, L, dtype=torch.float32, device=v.device)
    err = lib.ecg_probe_fold(ptr(logits), ptr(v), ptr(o), L, D, PRECISIONS.index(precision),
                             v.device.index, _stream(v))
    raise_on(lib, err, "precision probe fold")
    probe_fold.launches += 1
    return o


def probe_tree(logits: torch.Tensor, v: torch.Tensor) -> torch.Tensor:
    """softmax(logits) . v^T as (D, L), the row sum a tree, all f32."""
    L, D = _check_softmax("probe_tree", logits, v)
    if logits.device.type == "cpu":
        return tree_plain(logits, v)
    lib = _library()
    o = torch.empty(D, L, dtype=torch.float32, device=v.device)
    err = lib.ecg_probe_tree(ptr(logits), ptr(v), ptr(o), L, D, v.device.index, _stream(v))
    raise_on(lib, err, "precision probe tree")
    probe_tree.launches += 1
    return o


def probe_div(n: torch.Tensor, d: torch.Tensor) -> torch.Tensor:
    """n / d elementwise."""
    _check("probe_div", n, d)
    if n.shape != d.shape:
        raise ValueError(f"probe_div takes two operands of one shape, got "
                         f"{tuple(n.shape)} and {tuple(d.shape)}")
    if n.device.type == "cpu":
        return div_plain(n, d)
    lib = _library()
    o = torch.empty_like(n)
    err = lib.ecg_probe_div(ptr(n), ptr(d), ptr(o), n.numel(), n.device.index, _stream(n))
    raise_on(lib, err, "precision probe divide")
    probe_div.launches += 1
    return o


probe_dot.launches = probe_fold.launches = probe_tree.launches = probe_div.launches = 0
