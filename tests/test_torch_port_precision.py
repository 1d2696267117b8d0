"""The precision probes' plain versions against the JAX script's Pallas
kernels, on the CPU.

scripts/probe_precision.py runs its cases when imported, and its
pallas_calls are compiled for the TPU, so it is not imported: its source is
parsed with `ast`, and only the kernel functions (`dot_kernel`,
`fold_kernel`, `tree_kernel`, `div_kernel`), its `report` and its operand
assignments (`rng`, `a`, `b`, `exact`, `abf`, `bbf`, `logits`, `v`, `out64`,
... in the script's order) are executed, in a namespace holding jax, jnp,
np, L = 256 and D = 4. Each kernel then runs through
`pl.pallas_call(..., interpret=True)`, where both of the script's
precisions give the f32 product.

Tolerances:
* the ieee dot: within K 2^-24 (|a| . |b|) elementwise of JAX's (f32
  accumulation in other orders; K roundings of at most 2^-24 each);
* the fold (ieee) and the tree: within 1e-5 of max|out| (exp and the sums
  differ in order and by an ulp or two between XLA and PyTorch);
* the divide: bit for bit (IEEE division on both sides);
* chip_smoke.py's SDPA yardstick for the fold and the tree: within 1e-5
  of max|out| of JAX's tree_kernel (and of tree_plain at ragged shapes);
* the bf16 dot: the script's host prediction `abf @ bbf` rounded once to
  f32 (2^-24 of |prediction|, plus 1e-12 of (|a| . |b|) for float64 sums in
  another order);
* bf16 rounding: torch's equals `astype(jnp.bfloat16)` bit for bit;
* TF32 rounding: hand-picked values, exactly.
"""

import ast
import functools
from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
torch.set_num_threads(1)  # six test workers share the host's cores: one intra-op thread each
from jax.experimental import pallas as pl

from ecg_denoise_tpu_torch.kernels import precision as probes
from ecg_denoise_tpu_torch.probes import precision as probe_main

SCRIPT = Path(__file__).resolve().parents[1] / "scripts" / "probe_precision.py"
KERNELS = ("dot_kernel", "fold_kernel", "tree_kernel", "div_kernel", "report")
OPERANDS = ("rng", "L", "a", "b", "exact", "abf", "bbf", "D", "logits", "v",
            "l64", "e64", "p64", "out64", "num", "den")
U = 2.0 ** -24
SOFTMAX_TOL_OF_MAX = 1e-5


@pytest.fixture(scope="module")
def script():
    """The script's kernels, report and operands, without running it."""
    tree = ast.parse(SCRIPT.read_text())
    body = [node for node in tree.body
            if (isinstance(node, ast.FunctionDef) and node.name in KERNELS)
            or (isinstance(node, ast.Assign)
                and all(isinstance(t, ast.Name) and t.id in OPERANDS for t in node.targets))]
    ns = {"jax": jax, "jnp": jnp, "np": np, "L": 256, "D": 4}
    exec(compile(ast.Module(body=body, type_ignores=[]), str(SCRIPT), "exec"), ns)
    assert all(name in ns for name in KERNELS + OPERANDS)
    return ns


def _run(kernel, shape, *args):
    call = pl.pallas_call(kernel, out_shape=jax.ShapeDtypeStruct(shape, jnp.float32),
                          interpret=True)
    return np.asarray(call(*args))


def _t(x):
    return torch.from_numpy(np.ascontiguousarray(x))


def test_the_port_draws_the_scripts_operands(script):
    ops = probe_main.operands()
    for name in ("a", "b", "logits", "v", "num", "den"):
        assert ops[name].dtype == np.float32
        assert np.array_equal(ops[name], script[name]), name
    np.testing.assert_array_equal(probe_main.softmax_pv64(ops["logits"], ops["v"]),
                                  script["out64"].T)


@pytest.mark.parametrize("prec", [None, jax.lax.Precision.HIGHEST], ids=["None", "HIGHEST"])
def test_ieee_dot_matches_jax_dot_kernel(script, prec):
    a, b = script["a"], script["b"]
    jx = _run(functools.partial(script["dot_kernel"], prec), (256, 256), a, b)
    got = probes.probe_dot(_t(a), _t(b), "ieee").numpy()
    bound = 256 * U * (np.abs(a).astype(np.float64) @ np.abs(b).astype(np.float64))
    assert got.dtype == np.float32
    assert (np.abs(got.astype(np.float64) - jx) <= bound).all()


@pytest.mark.parametrize("prec", [None, jax.lax.Precision.HIGHEST, "tree"],
                         ids=["fold-None", "fold-HIGHEST", "tree"])
def test_fold_and_tree_match_jax_kernels(script, prec):
    logits, v = script["logits"], script["v"]
    if prec == "tree":
        jx = _run(script["tree_kernel"], (4, 256), logits, v)
        got = probes.probe_tree(_t(logits), _t(v)).numpy()
    else:
        jx = _run(functools.partial(script["fold_kernel"], prec), (4, 256), logits, v)
        got = probes.probe_fold(_t(logits), _t(v), "ieee").numpy()
    assert got.shape == (4, 256)
    assert np.abs(got - jx).max() <= SOFTMAX_TOL_OF_MAX * np.abs(jx).max()


@pytest.mark.parametrize("shape", ["script", (1, 1), (7, 2), (129, 5)], ids=str)
def test_sdpa_yardstick_computes_the_tree_kernels_function(script, shape):
    """chip_smoke.py's library call for the fold and the tree (SDPA with
    zero q and k, the logits as its mask) is softmax(logits) . v^T: JAX's
    tree_kernel on the script's operands, tree_plain at ragged shapes."""
    import chip_smoke

    if shape == "script":
        logits, v = script["logits"], script["v"]
        ref = _run(script["tree_kernel"], (4, 256), logits, v)
    else:
        L, D = shape
        rng = np.random.default_rng(L)
        logits = 2.0 * rng.standard_normal((L, L), np.float32)
        v = rng.standard_normal((D, L), np.float32)
        ref = probes.tree_plain(_t(logits), _t(v)).numpy()
    got = chip_smoke.softmax_pv_sdpa(_t(logits), _t(v))().numpy()
    assert got.shape == ref.shape
    assert np.abs(got - ref).max() <= SOFTMAX_TOL_OF_MAX * np.abs(ref).max()


def test_divide_is_bit_exact_against_jax(script):
    num, den = script["num"], script["den"]
    jx = _run(script["div_kernel"], (8, 256), num, den)
    got = probes.probe_div(_t(num), _t(den)).numpy()
    assert np.array_equal(got.view(np.uint32), jx.view(np.uint32))
    assert np.array_equal(got.view(np.uint32), (num / den).view(np.uint32))


def test_bf16_dot_is_the_scripts_host_prediction(script):
    a, b = script["a"], script["b"]
    pred = script["abf"] @ script["bbf"]
    got = probes.dot_plain(_t(a), _t(b), "bf16").numpy().astype(np.float64)
    slack = 1e-12 * (np.abs(a).astype(np.float64) @ np.abs(b).astype(np.float64))
    assert (np.abs(got - pred) <= U * np.abs(pred) + slack).all()


@pytest.mark.parametrize("which", ["a", "b", "special"])
def test_bf16_rounding_is_jaxs(script, which):
    if which == "special":
        bits = np.array([0x3F808000, 0x3F818000, 0xBF808000, 0x3F807FFF, 0x00000001,
                         0x00008000, 0x80000000, 0x7F7FFFFF, 0x7F800000, 0xFF800000],
                        np.uint32)
        x = bits.view(np.float32)
    else:
        x = script[which]
    mine = probes.round_bf16(_t(x)).numpy()
    theirs = x.astype(jnp.bfloat16).astype(np.float32)
    assert np.array_equal(mine.view(np.uint32), theirs.view(np.uint32))


# (input bits, TF32 rna bits): a TF32 step is 0x2000, half of it 0x1000.
TF32_CASES = [
    (0x3F800000, 0x3F800000),  # 1.0, exact
    (0x3F801000, 0x3F802000),  # 1 + 2^-11, a tie: away from zero (RNE keeps 1)
    (0xBF801000, 0xBF802000),  # the negative tie, also away from zero
    (0x3F800FFF, 0x3F800000),  # just below the tie
    (0x3F803000, 0x3F804000),  # a tie at an odd TF32 value
    (0x3F801001, 0x3F802000),  # just above the tie
    (0x3FFFF000, 0x40000000),  # the tie carries into the exponent
    (0x00000000, 0x00000000),  # +0
    (0x80000000, 0x80000000),  # -0 keeps its sign
    (0x00000FFF, 0x00000000),  # a subnormal below half a step
    (0x00001000, 0x00002000),  # a subnormal tie
    (0x807FF000, 0x80800000),  # the largest negative subnormal tie becomes normal
    (0x7F7FFFFF, 0x7F800000),  # above the largest TF32 value: to inf
    (0x7F800000, 0x7F800000),  # inf
    (0xFF800000, 0xFF800000),  # -inf
    (0x7FC00001, 0x7FC00001),  # NaN left alone
    (0x7F800001, 0x7F800001),  # a NaN that rounding would turn into inf
]


@pytest.mark.parametrize("bits,want", TF32_CASES, ids=[f"{b:08x}" for b, _ in TF32_CASES])
def test_round_tf32_rna(bits, want):
    x = torch.tensor([bits], dtype=torch.int64).to(torch.int32).view(torch.float32)
    got = probes.round_tf32_rna(x).view(torch.int32).item() & 0xFFFFFFFF
    assert got == want, f"{got:08x}"


def test_tf32x3_split_is_exact_to_float32():
    x = torch.from_numpy(np.random.default_rng(5).standard_normal(4096).astype(np.float32))
    hi, lo = probes.split_tf32x3(x)
    assert torch.equal(probes.round_tf32_rna(hi), hi) and torch.equal(probes.round_tf32_rna(lo), lo)
    # hi + lo keeps 22 of x's 24 significant bits: within 2^-21 of |x|.
    assert ((hi.double() + lo.double() - x.double()).abs() <= 2.0 ** -21 * x.double().abs()).all()


# Error of each path's dot over max|exact| on the script's operands, one
# decade per path: f32 paths near 2^-24 (1e-7), TF32 (inputs rounded to
# 2^-11) from 1e-4 to 1e-3, bf16 (2^-9) from 1e-3 to 1e-2; a path wired to
# another's rounding lands a decade off.
DOT_BANDS = {"ieee": (0.0, 1e-6), "tf32x3": (0.0, 1e-5), "tf32": (1e-4, 1e-3),
             "bf16": (1e-3, 1e-2)}


@pytest.mark.parametrize("precision", probes.PRECISIONS)
def test_precision_tuple_is_wired_to_its_rounding(script, precision):
    lo, hi = DOT_BANDS[precision]
    got = probes.probe_dot(_t(script["a"]), _t(script["b"]), precision).numpy()
    err = np.abs(got - script["exact"]).max() / np.abs(script["exact"]).max()
    assert lo <= err <= hi, err


@pytest.mark.parametrize("precision", probes.PRECISIONS)
def test_fold_shares_the_dots_rounding(script, precision):
    """The fold's error over max|out| follows its precision as the dot's
    does: the ones row (exact in every format) and en round together."""
    lo, hi = DOT_BANDS[precision]
    got = probes.probe_fold(_t(script["logits"]), _t(script["v"]), precision).numpy()
    exact = script["out64"].T
    assert lo <= np.abs(got - exact).max() / np.abs(exact).max() <= hi


def test_dot_tolerance_counts_the_products_summed():
    a = torch.ones(3, 5)
    b = torch.full((5, 2), 2.0)
    assert torch.equal(probes.dot_tolerance(a, b, "ieee"),
                       torch.full((3, 2), 5 * U * 10.0, dtype=torch.float64))
    # 1 and 2 are exact in TF32: lo = 0, so three terms of which one counts.
    assert torch.equal(probes.dot_tolerance(a, b, "tf32x3"),
                       torch.full((3, 2), 3 * 5 * U * 10.0, dtype=torch.float64))


def test_report_prints_the_scripts_line(script, capsys):
    rng = np.random.default_rng(9)
    exact = rng.standard_normal((16, 16))
    got = (exact + 1e-6 * rng.standard_normal((16, 16))).astype(np.float32)
    script["report"]("a probe line", got, exact)
    theirs = capsys.readouterr().out
    numbers = probe_main.report("a probe line", got, exact)
    assert capsys.readouterr().out == theirs
    probe_main.report("a probe line", got, exact, abs_of_max=True)
    extended = capsys.readouterr().out
    assert extended.startswith(theirs.rstrip("\n") + " max_abs/max|exact|=")
    rel = np.abs(got - exact) / np.abs(exact)
    assert numbers == {"max_rel": rel.max(), "med_rel": np.median(rel)}


@pytest.mark.parametrize("kernel", ["dot", "fold", "tree", "div"])
def test_wrappers_take_the_plain_version_on_the_cpu(kernel):
    x = torch.from_numpy(np.random.default_rng(2).standard_normal((8, 8), np.float32))
    v = x[:3].contiguous()
    call, plain = {
        "dot": (lambda: probes.probe_dot(x, x, "tf32"), lambda: probes.dot_plain(x, x, "tf32")),
        "fold": (lambda: probes.probe_fold(x, v, "bf16"), lambda: probes.fold_plain(x, v, "bf16")),
        "tree": (lambda: probes.probe_tree(x, v), lambda: probes.tree_plain(x, v)),
        "div": (lambda: probes.probe_div(x, x + 3), lambda: probes.div_plain(x, x + 3)),
    }[kernel]
    wrapper = getattr(probes, f"probe_{kernel}")
    before = wrapper.launches
    assert torch.equal(call(), plain())
    assert wrapper.launches == before


@pytest.mark.parametrize("case", ["bf16", "strided", "3-D", "precision", "shapes",
                                  "softmax-shape", "too-many-rows"])
def test_wrappers_refuse_what_the_kernels_do_not_take(case):
    x = torch.zeros(8, 8)
    with pytest.raises(TypeError if case == "bf16" else ValueError):
        {"bf16": lambda: probes.probe_dot(x.to(torch.bfloat16), x, "ieee"),
         "strided": lambda: probes.probe_div(x[:, ::2], x[:, ::2]),
         "3-D": lambda: probes.probe_div(x[None], x[None]),
         "precision": lambda: probes.probe_fold(x, x[:4].contiguous(), "fp16"),
         "shapes": lambda: probes.probe_dot(x, torch.zeros(7, 8), "ieee"),
         "softmax-shape": lambda: probes.probe_tree(x, torch.zeros(4, 7)),
         "too-many-rows": lambda: probes.probe_fold(x, torch.zeros(16, 8), "ieee"),
         }[case]()


def test_probe_raises_without_a_card(monkeypatch, capsys):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        probe_main.main()
    assert capsys.readouterr().out == ""
