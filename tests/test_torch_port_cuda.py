"""The Hopper attention kernels against their plain versions, on the card.

Marked `gpu`; each test takes the `cuda` fixture, which skips when no card
is present (decided at run time, so every pytest-xdist worker collects the
same tests). Run on a machine with the card:

    python -m pytest --noconftest tests/test_torch_port_cuda.py -q -m gpu

Tolerances: float32 1e-5 (both sides compute float32 logits and softmax;
the plain version's matmuls run in full float32, PyTorch's default and the
port's choice, `ecg_denoise_tpu_torch.full_float32`). bfloat16 3 * 2^-8 of max|v|: the plain version rounds the
probabilities to bf16 before the pv product and the kernel does not (up to
2^-8 of max|v|), and each side rounds its output once to bf16 (up to 2^-8
of |out| <= max|v| each).

The dense forward (attention_dense_fwd.cu, B5) is held to the same limits
against its plain version, and at D = 4 equals B1 without lse bit for bit
(it computes B1's f32 expressions with the keys in B1's order), at
batches that cut across its blocks' groups of elements; where the parent
commit's tree is unpacked, it is the parent's B5 bit for bit at D = 4.
Its mma template (D = 8, 16, 32, 64; 24 padded to 32) is held to the
same limits against its plain version and B1 without lse at L = 2 to 64,
at groups of heads that cut across its 64-row units, and, where the parent's tree
is unpacked, within them of the parent's B5.
`null_copy` equals `clone()` bit for bit at ragged sizes, aligned and as a
view 4 bytes off.

The r-pos kernels (attention_rpos_fwd.cu, attention_rpos_bwd.cu) are held
to the same limits against their plain versions, dtoep like dbias, at the
four biased stage shapes (L, W, H) and at ragged batches and lengths
(RPOS_CASES), with R peaks at 0, 5, L/2, L - 1 and random ones, so that
windows hang off both ends; and, where the parent commit's tree is
unpacked under _archive/parent, bit for bit to the parent's kernels. At
every other head dim and length (B1's and B2's templates in their window
mode: D = 8, 24 padded to 32, 64, 128 and 200 padded to 256, at a ragged
L and at packed heads, and D = 4 past 256 keys) they are held to the bars
of the templates (RPOS_ANY_D_CASES), a second call bit-identical.

Backward: dq, dk, dv to 1e-4 in float32 (the JAX package's gradient bar,
tests/test_pallas_attention.py:125); dbias, a sum over the batch of terms
each carrying about 1e-6 of relative error from its recomputed
probabilities, to 1e-4 of max|dbias|; with logits near 200 each side's
logits carry roundings of up to 1.5e-5, so 1e-4 of max|grad|. bfloat16
against the flash-form plain backward on the kernel's own o and lse: both
compute in float32 and round once, so they part by at most one bfloat16
spacing, 2^-7 of max|grad|.

The precision probes (precision_probe.cu) against their plain versions at
the probe's shapes and at ragged ones that fit no mma tile: the dot
within c K 2^-24 (|A_r| . |B_r|) elementwise (`dot_tolerance`: the
products of the rounded inputs are exact, so only the f32 accumulation
order differs; c = 3 for tf32x3's three products), the fold and the tree
within 1e-5 of max|out| (both sides use the card's expf; the sums differ
in order), the divide bit for bit against torch.div on the card and numpy
on the host, its operands aligned or not, alike or not; two calls
bit-identical; and, where the parent commit's tree is unpacked, the fold,
the tree, the divide and `null_copy` bit for bit the parent's. The probe's
own four dot readings equal those of its first version within 1e-3
relative.

B2 is also held with a bias whose gradient nobody wants (12-lead
transfer's frozen core): dq, dk and dv as above, and bit for bit those of
the same call with dbias.

B1 is also held at shapes that cut across its row tiles and batch groups
(L = 203, 7, 1; B = 1, 3, 37, 1000), with its lse within 1e-5 of
max(1, max|lse|) of the plain log-sum-exp and a second call bit-identical.

B1, B2 and B5 past head_dim 64 (the wide kernels; 72, 96 and 200 padded
to 128 and 256, 128, 192, 256, 320, 512 and 576 as they are: B1's and B2's
clusters of 2 to 8 blocks, and nine chunks on five) are held to the same
bars at shapes that cut across their 64-row tiles and packed heads and
past 256 keys, and a small Transformer1d with 128- and 256-wide heads on
the card equals the CPU's within 1e-4 with the launches of its blocks,
dense and default. B3 and B4 past D = 4 are held at 320 and 576 too, and
at dtoep's routes with B = 1 and W >= L; their f32 gradients also against
float64 gradients, and past D = 512 against those alone (there the
float32 plain versions' own rounding nears the 1e-4 bar). Where the parent commit's tree is
unpacked, what this tree left as it was equals the parent's bit for bit:
B1 and B2 on the mma template and the wide kernels, B3 on the wide kernel
and B4's dq, dk and dv on B2's wide passes, B3 and B4 at D = 4 and L <= 256
(their D = 4 kernels), and B5 at every head dim.

B3's window kernel (head_dim 4 past 256 keys, unpadded, and 8, 16, 32,
64: RPOS_WINDOW_CASES) is held to B3's bars against its plain version,
its lse to LSE_TOL, with windows whose edges fall on every multiple of 16
(every warp's, block's and key tile's boundary) and one either side, a
negative start, one past L - W and a NaN; B4's gradients from its o and
lse to B4's bars. B4's window kernel (csrc/attention_rpos_bwd_mma.cuh: head_dim 4
past 256 keys, unpadded, and 8, 16, 32, 64: RPOS_BWD_WINDOW_CASES) is held
on the same windows to B4's bars against the flash form on its o and lse
(f32 also against autograd through the plain forward), with its launch
counted and a second call bit-identical.

B1 and B2 on the mma template (head_dim 8, 16, 32, 64; 24 padded to 32;
D = 4 past 256 keys padded to 8) are held to the same bars, the f32
gradients to 1e-4 of their max, at Transformer1d's four stage shapes and
at shapes that cut across its 64-row tiles, 64-key stages and packed heads,
with and without a bias, and past 256 keys (L = 300, 500, 1000), a second
call bit-identical; at D = 4 and L <= 256 B1 is the parent commit's bit for
bit. A small Transformer1d on the card equals the CPU's within 1e-4 with
one B1 launch a block forward and one B2 a block backward. With
ECG_ATTN_DENSE=1 a D = 32 call at a packable stage goes to B5 at D = 32,
held to the bars above against its plain version and B1 at D = 32 without
lse, and the parent's B5; a small Transformer1d whose stages pack makes
one B5 launch a block.
"""

import copy
import os

import numpy as np
import pytest
import torch
torch.set_num_threads(1)  # six test workers share the host's cores: one intra-op thread each

from ecg_denoise_tpu_torch import full_float32
from ecg_denoise_tpu_torch.kernels import attention, attention_dense
from ecg_denoise_tpu_torch.kernels.attention import (
    attention_backward_reference,
    attention_reference,
    fused_attention,
)
from ecg_denoise_tpu_torch.kernels.attention_dense import (
    attention_dense_reference,
    fused_attention_dense,
)
from ecg_denoise_tpu_torch.kernels.attention_rpos import (
    attention_rpos_backward_reference,
    attention_rpos_reference,
    fused_attention_rpos,
)

pytestmark = pytest.mark.gpu

STAGES = [(256, 2), (128, 4), (64, 8), (32, 16), (16, 32)]
RPOS_STAGES = [(256, 32, 2), (128, 16, 4), (64, 8, 8), (32, 4, 16)]
# (L, H) the dense route takes in RA-LENet, then other shapes it admits.
DENSE_SHAPES = [(64, 8), (32, 16), (16, 32), (64, 4), (2, 2), (8, 4), (8, 6), (2, 64)]
# B5's batches: batches that cut across its blocks' groups of elements.
DENSE_BATCHES = [5, 1, 17, 37, 1000]
F32_TOL = 1e-5
BF16_TOL_OF_MAX_V = 3 * 2 ** -8
GRAD_TOL = 1e-4
DBIAS_TOL_OF_MAX = 1e-4
LARGE_LOGIT_GRAD_TOL_OF_MAX = 1e-4
BF16_GRAD_TOL_OF_MAX = 2 ** -7


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA card")
    return torch.device("cuda")


def _operands(B, H, L, with_bias, dtype, device, seed=0, D=4):
    """q, k, v and the bias; at D = 32 q is scaled by D^-1/2, as the model
    scales it, so the logits spread as at D = 4."""
    g = torch.Generator().manual_seed(seed)
    q, k, v = (torch.randn(B, H, L, D, generator=g) for _ in range(3))
    if D != 4:
        q = q * D ** -0.5
    bias = torch.randn(1, H, L, L, generator=g) if with_bias else None
    return [None if t is None else t.to(device, dtype)
            for t in (q, k, v, bias)]


@pytest.mark.parametrize("L,H", STAGES)
@pytest.mark.parametrize("with_bias", [True, False])
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_kernel_matches_plain_version(cuda, L, H, with_bias, dtype):
    q, k, v, bias = _operands(8, H, L, with_bias, dtype, cuda)
    before = fused_attention.launches
    out = fused_attention(q, k, v, bias)
    torch.cuda.synchronize()
    assert fused_attention.launches == before + 1
    assert out.dtype == dtype and out.shape == q.shape
    ref = attention_reference(q, k, v, bias)
    err = (out.float() - ref.float()).abs().max().item()
    tol = (F32_TOL if dtype == torch.float32
           else BF16_TOL_OF_MAX_V * v.float().abs().max().item())
    assert err <= tol, (err, tol)


def test_ragged_batch_and_large_logits(cuda):
    q, k, v, bias = _operands(3, 32, 16, True, torch.float32, cuda)
    bias = bias + 190.0  # trained logits reach 191.5; exp(190) overflows f32
    out = fused_attention(q, k, v, bias)
    torch.cuda.synchronize()
    assert torch.isfinite(out).all()
    # 1e-4: a float32 logit near 200 carries a rounding of up to 1.5e-5.
    assert (out - attention_reference(q, k, v, bias)).abs().max().item() <= 1e-4


# B1 at shapes that cut across its row tiles (32 rows), its batch groups
# (16 elements) and the elements side by side in a warp at L < 32: (B, L, H).
RAGGED_B1 = [(1, 256, 2), (37, 128, 4), (1000, 64, 8), (3, 203, 2), (37, 203, 1),
             (1000, 7, 3), (1, 7, 2), (3, 1, 2), (1000, 1, 5)]
# B1 and B2 at head_dim 32: Transformer1d's four stage shapes (L, H) at a
# 256-sample input, at B = 8, then shapes that cut across the D = 32
# kernels' 64-row tiles and 32-key chunks: (B, L, H).
D32_CASES = ([(8, L, H) for L, H in [(256, 4), (128, 8), (64, 16), (32, 32)]]
             + [(3, 203, 2), (2, 33, 3), (5, 7, 2), (4, 1, 1), (1, 65, 1)])
# The mma template's other head dims (24 padded to 32) at shapes that cut
# across its 64-row tiles, 64-key stages and packed heads (L <= 32), then
# D = 4 past the D = 4 kernels' 256 keys (padded to 8): (D, B, L, H).
MMA_CASES = ([(D, *c) for D in (8, 16, 24, 64)
              for c in [(2, 256, 2), (3, 203, 2), (2, 33, 3), (5, 7, 2), (4, 1, 1), (1, 65, 1)]]
             + [(4, 3, 300, 2), (4, 1, 257, 1)])
# The wide kernels (head_dim past 64): padded up (72, 96, 200) and as they
# are (128, 192, 256, 320, 512, 576: clusters of 2, 3, 4, 5 and 8 blocks,
# and nine chunks on a cluster of five, two a block but the last), at
# packed heads (L <= 32), one and four 64-row tiles and past 256 keys:
# (D, B, L, H).
WIDE_CASES = [(D, *c) for D in (72, 96, 128, 192, 200, 256, 320, 512, 576)
              for c in [(2, 32, 3), (3, 64, 2), (2, 256, 1), (1, 300, 1), (3, 7, 2)]]
# lse against attention_reference's logsumexp of the same f32 logits: the
# kernel's row sum uses __expf and another order (1e-6 relative), |lse|
# stays below about 20.
LSE_TOL = 1e-5


@pytest.mark.parametrize("D,B,L,H", [(4, *c) for c in RAGGED_B1] + [(32, *c) for c in D32_CASES]
                         + MMA_CASES + WIDE_CASES)
@pytest.mark.parametrize("with_bias", [True, False])
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_kernel_at_ragged_shapes_with_lse(cuda, D, B, L, H, with_bias, dtype):
    """B1 (bf16 operands with a bf16 bias) against its plain version, its
    lse against the plain log-sum-exp, and a second call bit-identical; at
    head_dim 4 at ragged shapes, at head_dim 32 at Transformer1d's stage
    shapes too, and at the mma template's other head dims."""
    full_float32()
    q, k, v, bias = _operands(B, H, L, with_bias, dtype, cuda, seed=B + L + H, D=D)
    before = fused_attention.launches
    out = fused_attention(q, k, v, bias)
    again, lse = attention._launch(q, k, v, bias, with_lse=True)
    torch.cuda.synchronize()
    assert fused_attention.launches == before + 2
    ref, ref_lse = attention_reference(q, k, v, bias, return_lse=True)
    tol = (F32_TOL if dtype == torch.float32
           else BF16_TOL_OF_MAX_V * v.float().abs().max().item())
    assert out.dtype == dtype and out.shape == q.shape
    assert (out.float() - ref.float()).abs().max().item() <= tol
    assert lse.dtype == torch.float32 and lse.shape == (B, H, L)
    lse_err = (lse - ref_lse).abs().max().item()
    assert lse_err <= LSE_TOL * max(1.0, ref_lse.abs().max().item()), lse_err
    assert torch.equal(out, again)


def _grads(q, k, v, bias, g):
    """Gradients of fused_attention through autograd, for every operand
    given (dbias only with a bias)."""
    ins = [t.detach().requires_grad_() for t in (q, k, v, bias) if t is not None]
    out = fused_attention(*ins[:3], ins[3] if bias is not None else None)
    return out, torch.autograd.grad(out, ins, g)


# On the mma template (D = 32 and the other head dims, D = 4 past 256)
# each gradient is held to 1e-4 of its max, in f32, dbias too.
D32_GRAD_TOL_OF_MAX = 1e-4


@pytest.mark.parametrize("D,B,L,H", [(4, 8, L, H) for L, H in STAGES]
                         + [(32, *c) for c in D32_CASES] + MMA_CASES + WIDE_CASES)
@pytest.mark.parametrize("with_bias", [True, False])
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_backward_kernel_matches_plain_versions(cuda, D, B, L, H, with_bias, dtype):
    """The autograd Function (forward kernel with its lse, backward kernel)
    against the flash-form plain backward on the kernel's own o and lse,
    and, in float32, against autograd through the plain forward; at head_dim
    4 at RA-LENet's stage shapes, at head_dim 32 at Transformer1d's and at
    ragged ones."""
    full_float32()
    q, k, v, bias = _operands(B, H, L, with_bias, dtype, cuda, D=D)
    g = torch.randn(q.shape, generator=torch.Generator().manual_seed(1)).to(cuda, dtype)
    before = (fused_attention.launches, fused_attention.bwd_launches)
    out, grads = _grads(q, k, v, bias, g)
    torch.cuda.synchronize()
    assert (fused_attention.launches, fused_attention.bwd_launches) == (
        before[0] + 1, before[1] + 1)
    assert [t.dtype for t in grads] == [dtype] * len(grads)
    _, lse = attention_reference(q, k, v, bias, return_lse=True)
    flash = attention_backward_reference(q, k, v, bias, out.detach(), lse, g)
    refs = [flash]
    if dtype == torch.float32:
        ins = [t.detach().requires_grad_() for t in (q, k, v, bias) if t is not None]
        out_ref = attention_reference(*ins[:3], ins[3] if bias is not None else None)
        refs.append(torch.autograd.grad(out_ref, ins, g))
    for ref in refs:
        for name, a, b in zip("q k v bias".split(), grads, ref):
            assert a.shape == b.shape
            a, b = a.float(), b.float()
            # At L = 1 the exact dq, dk and dbias are 0: their bars are
            # taken of max|dv| (see test_backward_kernel_at_ragged_shapes).
            scale = (ref[2] if L == 1 and name != "v" else b).float().abs().max().item()
            tol = (BF16_GRAD_TOL_OF_MAX * scale if dtype == torch.bfloat16
                   else D32_GRAD_TOL_OF_MAX * scale if D != 4 or L > 256
                   else DBIAS_TOL_OF_MAX * scale if name == "bias" else GRAD_TOL)
            err = (a - b).abs().max().item()
            assert err <= tol, (name, err, tol)
    # Every output element is summed by one thread in a fixed order.
    _, again = _grads(q, k, v, bias, g)
    for a, b in zip(grads, again):
        assert torch.equal(a, b)


def test_backward_ragged_batch_and_large_logits(cuda):
    full_float32()
    q, k, v, bias = _operands(3, 32, 16, True, torch.float32, cuda)
    bias = bias + 190.0
    g = torch.randn(q.shape, generator=torch.Generator().manual_seed(2)).to(cuda)
    _, grads = _grads(q, k, v, bias, g)
    ins = [t.detach().requires_grad_() for t in (q, k, v, bias)]
    ref = torch.autograd.grad(attention_reference(*ins), ins, g)
    for a, b in zip(grads, ref):
        assert torch.isfinite(a).all()
        assert (a - b).abs().max().item() <= LARGE_LOGIT_GRAD_TOL_OF_MAX * b.abs().max().item()


@pytest.mark.parametrize("B,L,H", RAGGED_B1)
@pytest.mark.parametrize("with_bias", [True, False])
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_backward_kernel_at_ragged_shapes(cuda, B, L, H, with_bias, dtype):
    """B2 at shapes that cut across its row tiles, batch groups and dbias
    tiles, against the flash-form plain backward on the forward kernel's
    own o and lse; a second call bit-identical."""
    q, k, v, bias = _operands(B, H, L, with_bias, dtype, cuda, seed=B + L + H)
    g = torch.randn(q.shape, generator=torch.Generator().manual_seed(3)).to(cuda, dtype)
    o, lse = attention._launch(q, k, v, bias, with_lse=True)
    before = fused_attention.bwd_launches
    got = attention._launch_bwd(q, k, v, bias, o, lse, g, want_dbias=with_bias)
    again = attention._launch_bwd(q, k, v, bias, o, lse, g, want_dbias=with_bias)
    torch.cuda.synchronize()
    assert fused_attention.bwd_launches == before + 2
    ref = attention_backward_reference(q, k, v, bias, o, lse, g)
    for name, a, b in zip("q k v bias".split(), got, ref):
        if b is None:
            assert a is None
            continue
        assert a.dtype == dtype and a.shape == b.shape
        scale = b.float().abs().max().item()
        if L == 1 and name != "v":
            # A softmax over one key is constant: the exact dq, dk and dbias
            # are 0 and both sides return the rounding of the cancelled
            # g.v - g.o, so their bars are taken of max|dv| (= max|g|), the
            # call's one gradient that does not vanish.
            scale = ref[2].float().abs().max().item()
        tol = (BF16_GRAD_TOL_OF_MAX * scale if dtype == torch.bfloat16
               else DBIAS_TOL_OF_MAX * scale if name == "bias" else GRAD_TOL)
        err = (a.float() - b.float()).abs().max().item()
        assert err <= tol, (name, err, tol)
    for a, b in zip(got, again):
        assert (a is None and b is None) or torch.equal(a, b)


@pytest.mark.parametrize("B,L,H", [(32, L, H) for (L, H) in STAGES] + [(37, 203, 2), (3, 7, 3)])
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_backward_with_a_frozen_bias(cuda, B, L, H, dtype):
    """B2 with a bias whose gradient nobody wants (12-lead transfer's
    frozen core: the rel-pos tables do not require grad), through the
    autograd Function: no dbias; dq, dk and dv within the bars of the
    plain flash backward on the forward kernel's own o and lse, and bit
    for bit those of the same call with dbias."""
    q, k, v, bias = _operands(B, H, L, True, dtype, cuda, seed=L + H + 7)
    g = torch.randn(q.shape, generator=torch.Generator().manual_seed(5)).to(cuda, dtype)
    ins = [t.detach().requires_grad_() for t in (q, k, v)]
    before = fused_attention.bwd_launches
    out = fused_attention(*ins, bias)
    grads = torch.autograd.grad(out, ins, g)
    torch.cuda.synchronize()
    assert fused_attention.bwd_launches == before + 1
    o, lse = attention._launch(q, k, v, bias, with_lse=True)
    with_dbias = attention._launch_bwd(q, k, v, bias, o, lse, g, want_dbias=True)
    assert with_dbias[3] is not None
    ref = attention_backward_reference(q, k, v, bias, o, lse, g)
    for name, a, b, full in zip("q k v".split(), grads, ref, with_dbias):
        assert a.dtype == dtype and a.shape == q.shape
        assert torch.equal(a, full), name
        scale = b.float().abs().max().item()
        tol = BF16_GRAD_TOL_OF_MAX * scale if dtype == torch.bfloat16 else GRAD_TOL
        err = (a.float() - b.float()).abs().max().item()
        assert err <= tol, (name, err, tol)


# The parent commit's tree, unpacked by `git archive` under the git-ignored
# _archive/ (absent from a plain checkout): its B2 is the yardstick.
PARENT_CSRC = os.path.join(os.path.dirname(os.path.dirname(os.path.abspath(__file__))),
                           "_archive", "parent", "ecg_denoise_tpu_torch", "kernels", "csrc")


@pytest.mark.parametrize("B,L,H", [(256, L, H) for (L, H) in STAGES] + [(37, 203, 2), (3, 7, 3)])
@pytest.mark.parametrize("with_bias", [True, False])
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_backward_kernel_equals_the_parent_commits(cuda, B, L, H, with_bias, dtype):
    """dq, dk, dv and the float32 dbias bit for bit those of the parent
    commit's B2 on the same o, lse and g: the redesign kept the arithmetic
    (skipped where the parent's tree is not unpacked)."""
    if not os.path.isdir(PARENT_CSRC):
        pytest.skip("the parent commit's tree is not under _archive/parent")
    from pathlib import Path

    from ecg_denoise_tpu_torch.kernels.attention import DTYPE_CODES, bind, ptr, raise_on

    q, k, v, bias = _operands(B, H, L, with_bias, dtype, cuda, seed=L + H)
    g = torch.randn(q.shape, generator=torch.Generator().manual_seed(4)).to(cuda, dtype)
    o, lse = attention._launch(q, k, v, bias, with_lse=True)
    outs = []
    for lib in (attention._bwd_library(),
                bind("attention_bwd", "ecg_attention_bwd", 12, csrc=Path(PARENT_CSRC))):
        dq, dk, dv = (torch.empty_like(q) for _ in range(3))
        c = torch.empty(B, H, L, device=cuda)
        dbias = torch.empty(1, H, L, L, device=cuda) if with_bias else None
        err = lib.ecg_attention_bwd(ptr(q), ptr(k), ptr(v), ptr(bias), ptr(g), ptr(o),
                                    ptr(lse), ptr(c), ptr(dq), ptr(dk), ptr(dv), ptr(dbias),
                                    B, H, L, 4, DTYPE_CODES[dtype], cuda.index or 0,
                                    torch.cuda.current_stream().cuda_stream)
        raise_on(lib, err, "attention backward")
        outs.append((dq, dk, dv, dbias))
    torch.cuda.synchronize()
    for name, a, b in zip("q k v bias".split(), *outs):
        assert (a is None and b is None) or torch.equal(a, b), name


def _seeded_ralenet(device):
    """RA-LENet 'full' (depth 2) with seeded weights and nonzero rel-pos
    tables on the CPU, and the same model on `device`."""
    from ecg_denoise_tpu_torch.models import build_model

    torch.manual_seed(0)
    cpu = build_model("ralenet", device="cpu")
    with torch.no_grad():
        for name, p in cpu.named_parameters():
            if "relative_position_bias_table" in name:
                p.normal_()
    gpu = build_model("ralenet", device=device)
    gpu.load_state_dict(cpu.state_dict())
    return cpu, gpu


def test_training_step_matches_cpu_with_18_and_18_launches(cuda):
    """One Adam step of RA-LENet 'full' (depth 2, float32, batch 8) on the
    card against the same step on the CPU."""
    from ecg_denoise_tpu_torch.train import create_train_state, train_step

    cpu, gpu = _seeded_ralenet(cuda)
    rng = np.random.default_rng(0)
    noisy, clean = (torch.from_numpy(rng.standard_normal((8, 2, 256)).astype(np.float32))
                    for _ in range(2))
    cpu_state = create_train_state(cpu, device="cpu")
    gpu_state = create_train_state(gpu, device=cuda)
    before = (fused_attention.launches, fused_attention.bwd_launches)
    loss = train_step(gpu_state, noisy.to(cuda), clean.to(cuda))[0].item()
    assert (fused_attention.launches - before[0],
            fused_attention.bwd_launches - before[1]) == (18, 18)
    ref = train_step(cpu_state, noisy, clean)[0].item()
    assert abs(loss - ref) <= 1e-5 * abs(ref)
    ref_sd = cpu.state_dict()
    for key, val in gpu.state_dict().items():
        tol = 1e-5 if key.endswith(("running_mean", "running_var")) else 1e-4
        assert (val.cpu().float() - ref_sd[key].float()).abs().max().item() <= tol, key


def test_model_forward_matches_cpu_with_18_launches(cuda):
    cpu, gpu = _seeded_ralenet(cuda)
    cpu.eval()
    gpu.eval()
    # The package, not the caller, turns TF32 off on the card.
    assert not torch.backends.cudnn.allow_tf32
    assert not torch.backends.cuda.matmul.allow_tf32
    x = torch.from_numpy(
        np.random.default_rng(0).standard_normal((8, 2, 256)).astype(np.float32))
    with torch.no_grad():
        before = fused_attention.launches
        y = gpu(x.to(cuda))
        torch.cuda.synchronize()
        assert fused_attention.launches == before + 18
        assert (y.cpu() - cpu(x)).abs().max().item() <= 1e-4


def _rpos_operands(B, L, W, H, dtype, device, seed=0, D=4):
    """q (scaled by D^-1/2 past D = 4), k, v, a Toeplitz toep from a random
    table, and float32 offsets of R peaks at 0, 5, L/2, L - 1 and random
    positions."""
    g = torch.Generator().manual_seed(seed)
    q, k, v = (torch.randn(B, H, L, D, generator=g) for _ in range(3))
    if D != 4:
        q = q * D ** -0.5
    table = torch.randn(2 * W - 1, H, generator=g)
    pos = torch.arange(L)
    rel = pos[:, None] - pos[None, :]
    toep = (table[(rel + W - 1).clamp(0, 2 * W - 2)]
            * (rel.abs() < W)[..., None]).permute(2, 0, 1)[None].contiguous()
    r_pos = torch.randint(0, L, (B,), generator=g)
    r_pos[:4] = torch.tensor([0, 5, L // 2, L - 1])[:B]
    offsets = (r_pos - W // 2).float()
    return ([t.to(device, dtype) for t in (q, k, v, toep)], W, offsets.to(device))


# The r-pos kernels' cases, (B, L, W, H): the four biased stage shapes at
# B = 8, then batches at the edges of B4's dtoep stages and lists (1, 17,
# 37), and ragged L (odd L takes a row a thread, even L two) with W cut to
# fit. R peaks at 0, 5, L/2 and L - 1 put windows off both ends.
RPOS_CASES = ([(8, L, W, H) for (L, W, H) in RPOS_STAGES]
              + [(1, 256, 32, 2), (17, 128, 16, 4), (37, 64, 8, 8), (37, 203, 25, 2),
                 (17, 7, 3, 3), (3, 1, 1, 2)])


def _rpos_grad_scale(name, ref, L):
    """The bar's scale for one gradient: its max, but at L = 1, where the
    softmax over one key is constant, the exact dq, dk and dtoep are 0 and
    both sides return the rounding of the cancelled g.v - g.o, so their
    bars are taken of max|dv| (= max|g|), as for B2."""
    if L == 1 and name != "dv":
        return ref[2].float().abs().max().item()
    return ref[("dq", "dk", "dv", "dtoep").index(name)].float().abs().max().item()


# B3 and B4 on the templates in their window mode, (D, B, L, W, H): a
# ragged L and packed heads (L <= 32, five heads: one block holds heads of
# two batch elements) at every width class, D = 4 past 256 keys, and
# dtoep's routes at B = 1 and with W >= L (the whole length a window).
RPOS_ANY_D_CASES = [(D, B, L, W, H) for D in (8, 24, 64, 128, 200, 320, 576)
                    for (B, L, W, H) in ((8, 203, 25, 3), (5, 32, 4, 5))] + [
    (4, 8, 300, 37, 2), (4, 1, 300, 37, 1), (8, 1, 64, 16, 2), (576, 2, 70, 9, 1),
    (320, 3, 40, 48, 2), (16, 3, 24, 32, 2)]


# Past this head dim the float32 plain versions' own rounding nears the
# f32 gradient bar (at D = 576 the flash form's dq lies 9.5e-05 and
# autograd's 5.6e-05 from float64, the kernel's 2.1e-05), so B4's f32
# gradients are held there to float64 gradients alone, at the same bar.
RPOS_F64_ONLY_PAST = 512


def _rpos_exact_grads(ops, W, offsets, g):
    """Float64 gradients of the r-pos attention through autograd (the
    materialised bias, softmax and products in float64)."""
    from ecg_denoise_tpu_torch.kernels.attention_rpos import materialize_rpos_bias

    ins = [t.detach().double().requires_grad_() for t in ops]
    logits = (torch.einsum("bhld,bhmd->bhlm", ins[0], ins[1])
              + materialize_rpos_bias(ins[3], W, offsets))
    out = torch.einsum("bhlm,bhmd->bhld", torch.softmax(logits, -1), ins[2])
    return torch.autograd.grad(out, ins, g.double())


@pytest.mark.parametrize("D,B,L,W,H", RPOS_ANY_D_CASES)
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_rpos_kernels_at_any_head_dim_match_plain_versions(cuda, D, B, L, W, H, dtype):
    full_float32()
    ops, W, offsets = _rpos_operands(B, L, W, H, dtype, cuda, seed=D + L, D=D)
    g = torch.randn(ops[0].shape, generator=torch.Generator().manual_seed(3)).to(cuda, dtype)

    def grads():
        ins = [t.detach().requires_grad_() for t in ops]
        out = fused_attention_rpos(*ins, W, offsets)
        return out.detach(), torch.autograd.grad(out, ins, g)

    before = (fused_attention_rpos.launches, fused_attention_rpos.bwd_launches)
    out, got = grads()
    torch.cuda.synchronize()
    assert (fused_attention_rpos.launches, fused_attention_rpos.bwd_launches) == (
        before[0] + 1, before[1] + 1)
    assert out.shape == ops[0].shape and [t.dtype for t in got] == [dtype] * 4
    ref, lse = attention_rpos_reference(*ops, W, offsets, return_lse=True)
    tol = (F32_TOL if dtype == torch.float32
           else BF16_TOL_OF_MAX_V * ops[2].float().abs().max().item())
    assert (out.float() - ref.float()).abs().max().item() <= tol
    refs = [attention_rpos_backward_reference(*ops, W, offsets, out, lse, g)]
    if dtype == torch.float32:
        ins = [t.detach().requires_grad_() for t in ops]
        refs.append(torch.autograd.grad(attention_rpos_reference(*ins, W, offsets), ins, g))
        if D > RPOS_F64_ONLY_PAST:
            refs = []
        refs.append(_rpos_exact_grads(ops, W, offsets, g))
    for ref in refs:
        for name, a, b in zip(("dq", "dk", "dv", "dtoep"), got, ref):
            scale = _rpos_grad_scale(name, ref, L)
            tol = (BF16_GRAD_TOL_OF_MAX * scale if dtype == torch.bfloat16
                   else DBIAS_TOL_OF_MAX * scale if name == "dtoep" else GRAD_TOL)
            err = (a.double() - b.double()).abs().max().item()
            assert err <= tol, (name, err, tol)
    again, again_grads = grads()
    assert torch.equal(out, again)
    assert all(torch.equal(a, b) for a, b in zip(got, again_grads))


# B3's window kernel (csrc/attention_rpos_fwd_mma.cuh), (D, L): D = 4 past
# 256 keys, unpadded, and D = 8-64 at one key tile, at four and past them.
RPOS_WINDOW_CASES = ([(4, L) for L in (257, 300, 1000)]
                     + [(D, L) for D in (8, 16, 32, 64) for L in (64, 256, 300)])


def _edge_offsets(L):
    """W = 64 and window starts whose two edges fall on every multiple of
    16 (every warp's rows, block's rows and key tile start at one) and one
    either side of it, then a negative start, one past L - W, a
    fractional one and a NaN (an empty window)."""
    offs = [float(b + d) for b in range(-16, L + 16, 16) for d in (-1, 0, 1)]
    return 64, torch.tensor(offs + [-40.0, L - 20.0, 100.5 % L, float("nan")])


@pytest.mark.parametrize("D,L", RPOS_WINDOW_CASES)
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_rpos_window_kernel_at_tile_edges(cuda, D, L, dtype):
    """B3 on its window kernel against its plain version (f32 1e-5, bf16
    3 * 2^-8 of max|v|), its lse against the plain log-sum-exp, with the
    windows' edges on every tile boundary and one either side; B4 through
    the autograd Function from the kernel's o and lse: f32 within 1e-4
    (dtoep 1e-4 of its max) of autograd through the plain forward and of
    the flash form on the plain o and lse, bf16 within 2^-7 of each max of
    the flash form on the kernel's own o and lse."""
    from ecg_denoise_tpu_torch.kernels import attention_rpos

    full_float32()
    W, offsets = _edge_offsets(L)
    ops, W, _ = _rpos_operands(len(offsets), L, W, 2, dtype, cuda, seed=D + L, D=D)
    offsets = offsets.to(cuda)
    g = torch.randn(ops[0].shape, generator=torch.Generator().manual_seed(9)).to(cuda, dtype)
    ins = [t.detach().requires_grad_() for t in ops]
    before = (fused_attention_rpos.launches, fused_attention_rpos.bwd_launches)
    out = fused_attention_rpos(*ins, W, offsets)
    got = torch.autograd.grad(out, ins, g)
    again, lse = attention_rpos._launch(*ops, W, offsets, with_lse=True)
    torch.cuda.synchronize()
    assert (fused_attention_rpos.launches, fused_attention_rpos.bwd_launches) == (
        before[0] + 2, before[1] + 1)
    # unpadded, but bf16's D = 8, which its mma (16 deep) takes padded to 16
    assert attention_rpos.rpos_head_dim(D, L, dtype) == (
        16 if (D, dtype) == (8, torch.bfloat16) else D)
    ref, ref_lse = attention_rpos_reference(*ops, W, offsets, return_lse=True)
    tol = (F32_TOL if dtype == torch.float32
           else BF16_TOL_OF_MAX_V * ops[2].float().abs().max().item())
    assert out.shape == ops[0].shape and out.dtype == dtype
    assert (out.float() - ref.float()).abs().max().item() <= tol
    assert torch.equal(out.detach(), again)
    lse_err = (lse - ref_lse).abs().max().item()
    assert lse_err <= LSE_TOL * max(1.0, ref_lse.abs().max().item()), lse_err
    if dtype == torch.float32:
        plain = [t.detach().requires_grad_() for t in ops]
        refs = [torch.autograd.grad(attention_rpos_reference(*plain, W, offsets), plain, g),
                attention_rpos_backward_reference(*ops, W, offsets, ref, ref_lse, g)]
    else:
        refs = [attention_rpos_backward_reference(*ops, W, offsets, out.detach(), lse, g)]
    for want in refs:
        for name, a, b in zip(("dq", "dk", "dv", "dtoep"), got, want):
            scale = b.float().abs().max().item()
            bar = (BF16_GRAD_TOL_OF_MAX * scale if dtype == torch.bfloat16
                   else DBIAS_TOL_OF_MAX * scale if name == "dtoep" else GRAD_TOL)
            err = (a.float() - b.float()).abs().max().item()
            assert bool(torch.isfinite(a).all()) and err <= bar, (name, err, bar)


# B4's window kernel (csrc/attention_rpos_bwd_mma.cuh), (D, L): D = 4 past
# 256 keys, unpadded, and D = 8-64 at a length past one block's 64 rows
# and its tiles' 64 (f32 D = 64: 32 and 16) rows.
RPOS_BWD_WINDOW_CASES = ([(4, 257), (4, 1000)]
                         + [(D, L) for D in (8, 16, 32, 64) for L in (203, 300)])


@pytest.mark.parametrize("D,L", RPOS_BWD_WINDOW_CASES)
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_rpos_backward_window_kernel_matches_plain_and_repeats(cuda, D, L, dtype):
    """B4 on its window kernel, through `_launch_bwd` on the forward
    kernel's o and lse, with the windows' edges on every tile boundary and
    one either side: dq, dk, dv within 1e-4 and dtoep within 1e-4 of its
    max of the flash form on the same o and lse (f32; also of autograd
    through the plain forward), bf16 within 2^-7 of each max; one backward
    launch a call, and a second call bit-identical."""
    from ecg_denoise_tpu_torch.kernels import attention_rpos

    full_float32()
    W, offsets = _edge_offsets(L)
    ops, W, _ = _rpos_operands(len(offsets), L, W, 2, dtype, cuda, seed=3 * D + L, D=D)
    offsets = offsets.to(cuda)
    g = torch.randn(ops[0].shape, generator=torch.Generator().manual_seed(11)).to(cuda, dtype)
    assert attention_rpos.rpos_head_dim(D, L, dtype) == (
        16 if (D, dtype) == (8, torch.bfloat16) else D)
    o, lse = attention_rpos._launch(*ops, W, offsets, with_lse=True)
    before = fused_attention_rpos.bwd_launches
    got = attention_rpos._launch_bwd(*ops, W, offsets, o, lse, g)
    again = attention_rpos._launch_bwd(*ops, W, offsets, o, lse, g)
    torch.cuda.synchronize()
    assert fused_attention_rpos.bwd_launches == before + 2
    assert [t.dtype for t in got] == [dtype] * 4
    assert [t.shape for t in got] == [t.shape for t in ops]
    refs = [attention_rpos_backward_reference(*ops, W, offsets, o, lse, g)]
    if dtype == torch.float32:
        plain = [t.detach().requires_grad_() for t in ops]
        refs.append(torch.autograd.grad(attention_rpos_reference(*plain, W, offsets), plain, g))
    for want in refs:
        for name, a, b in zip(("dq", "dk", "dv", "dtoep"), got, want):
            scale = b.float().abs().max().item()
            bar = (BF16_GRAD_TOL_OF_MAX * scale if dtype == torch.bfloat16
                   else DBIAS_TOL_OF_MAX * scale if name == "dtoep" else GRAD_TOL)
            err = (a.float() - b.float()).abs().max().item()
            assert bool(torch.isfinite(a).all()) and err <= bar, (name, err, bar)
    assert all(torch.equal(a, b) for a, b in zip(got, again))


@pytest.mark.parametrize("B,L,W,H", RPOS_CASES)
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_rpos_kernel_matches_plain_version(cuda, B, L, W, H, dtype):
    full_float32()
    (q, k, v, toep), W, offsets = _rpos_operands(B, L, W, H, dtype, cuda)
    before = fused_attention_rpos.launches
    out = fused_attention_rpos(q, k, v, toep, W, offsets)
    torch.cuda.synchronize()
    assert fused_attention_rpos.launches == before + 1
    assert out.dtype == dtype and out.shape == q.shape
    ref = attention_rpos_reference(q, k, v, toep, W, offsets)
    err = (out.float() - ref.float()).abs().max().item()
    tol = (F32_TOL if dtype == torch.float32
           else BF16_TOL_OF_MAX_V * v.float().abs().max().item())
    assert err <= tol, (err, tol)


@pytest.mark.parametrize("B,L,W,H", RPOS_CASES)
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_rpos_backward_kernel_matches_plain_versions(cuda, B, L, W, H, dtype):
    full_float32()
    ops, W, offsets = _rpos_operands(B, L, W, H, dtype, cuda, seed=1)
    g = torch.randn(ops[0].shape, generator=torch.Generator().manual_seed(2)).to(cuda, dtype)

    def grads():
        ins = [t.detach().requires_grad_() for t in ops]
        out = fused_attention_rpos(*ins, W, offsets)
        return out.detach(), torch.autograd.grad(out, ins, g)

    before = (fused_attention_rpos.launches, fused_attention_rpos.bwd_launches)
    out, got = grads()
    torch.cuda.synchronize()
    assert (fused_attention_rpos.launches, fused_attention_rpos.bwd_launches) == (
        before[0] + 1, before[1] + 1)
    assert [t.dtype for t in got] == [dtype] * 4
    _, lse = attention_rpos_reference(*ops, W, offsets, return_lse=True)
    refs = [attention_rpos_backward_reference(*ops, W, offsets, out, lse, g)]
    if dtype == torch.float32:
        ins = [t.detach().requires_grad_() for t in ops]
        refs.append(torch.autograd.grad(attention_rpos_reference(*ins, W, offsets), ins, g))
    for ref in refs:
        for name, a, b in zip(("dq", "dk", "dv", "dtoep"), got, ref):
            a, b = a.float(), b.float()
            scale = _rpos_grad_scale(name, ref, L)
            tol = (BF16_GRAD_TOL_OF_MAX * scale if dtype == torch.bfloat16
                   else DBIAS_TOL_OF_MAX * scale if name == "dtoep" else GRAD_TOL)
            err = (a - b).abs().max().item()
            assert err <= tol, (name, err, tol)
    _, again = grads()
    for a, b in zip(got, again):
        assert torch.equal(a, b)


@pytest.mark.parametrize("B,L,W,H", RPOS_CASES + [(256, L, W, H) for (L, W, H) in RPOS_STAGES])
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_rpos_kernels_equal_the_parent_commits(cuda, B, L, W, H, dtype):
    """B3's output and lse, and B4's dq, dk, dv and float32 dtoep, bit for
    bit those of the parent commit's B3 and B4 on the same operands: the
    redesigns kept the arithmetic (skipped where the parent's tree is not
    unpacked)."""
    if not os.path.isdir(PARENT_CSRC):
        pytest.skip("the parent commit's tree is not under _archive/parent")
    from pathlib import Path

    from ecg_denoise_tpu_torch.kernels import attention_rpos
    from ecg_denoise_tpu_torch.kernels.attention import DTYPE_CODES, bind, ptr, raise_on

    (q, k, v, toep), W, offsets = _rpos_operands(B, L, W, H, dtype, cuda, seed=L + H)
    g = torch.randn(q.shape, generator=torch.Generator().manual_seed(5)).to(cuda, dtype)
    stream = torch.cuda.current_stream().cuda_stream
    fwd_libs = (attention_rpos._library(),
                bind("attention_rpos_fwd", "ecg_attention_rpos_fwd", 7, 7,
                     csrc=Path(PARENT_CSRC)))
    bwd_libs = (attention_rpos._bwd_library(),
                bind("attention_rpos_bwd", "ecg_attention_rpos_bwd", 14, 7,
                     csrc=Path(PARENT_CSRC)))
    # At D = 4 both backwards take no ds scratch (a null 14th pointer).
    scratch = ([None], [None])
    outs = []
    for fwd, bwd in zip(fwd_libs, bwd_libs):
        o = torch.empty_like(q)
        lse = torch.empty(B, H, L, device=cuda)
        err = fwd.ecg_attention_rpos_fwd(ptr(q), ptr(k), ptr(v), ptr(toep), ptr(offsets),
                                         ptr(o), ptr(lse), B, H, L, 4, W, DTYPE_CODES[dtype],
                                         cuda.index or 0, stream)
        raise_on(fwd, err, "attention r-pos forward")
        dq, dk, dv = (torch.empty_like(q) for _ in range(3))
        c = torch.empty(B, H, L, device=cuda)
        dtoep = torch.empty(1, H, L, L, device=cuda)
        # Both backward kernels on the new forward's o and lse.
        o_in, lse_in = (o, lse) if not outs else outs[0][:2]
        err = bwd.ecg_attention_rpos_bwd(ptr(q), ptr(k), ptr(v), ptr(toep), ptr(offsets),
                                         ptr(g), ptr(o_in), ptr(lse_in), ptr(c), ptr(dq),
                                         ptr(dk), ptr(dv), ptr(dtoep),
                                         *scratch[len(outs)], B, H, L, 4, W,
                                         DTYPE_CODES[dtype], cuda.index or 0, stream)
        raise_on(bwd, err, "attention r-pos backward")
        outs.append((o, lse, dq, dk, dv, dtoep))
    torch.cuda.synchronize()
    for name, a, b in zip(("o", "lse", "dq", "dk", "dv", "dtoep"), *outs):
        assert torch.equal(a, b), name


def test_rpos_model_forward_and_step_match_cpu_with_14_and_4_launches(cuda):
    """RA-LENet 'full' (depth 2, float32, batch 8) with detected R peaks:
    the forward goes 14 times through B3 and 4 through B1, one training
    step adds 14 B4 and 4 B2 launches, and both agree with the CPU."""
    from ecg_denoise_tpu_torch.data.rpeaks import detect_r_peaks
    from ecg_denoise_tpu_torch.train import create_train_state, train_step

    cpu, gpu = _seeded_ralenet(cuda)
    rng = np.random.default_rng(0)
    noisy, clean = (torch.from_numpy(rng.standard_normal((8, 2, 256)).astype(np.float32))
                    for _ in range(2))
    r_cpu = detect_r_peaks(noisy)
    r_gpu = detect_r_peaks(noisy.to(cuda))
    assert torch.equal(r_gpu.cpu(), r_cpu)

    def counts():
        return (fused_attention_rpos.launches, fused_attention.launches,
                fused_attention_rpos.bwd_launches, fused_attention.bwd_launches)

    with torch.no_grad():
        before = counts()
        y = gpu.eval()(noisy.to(cuda), r_pos=r_gpu)
        torch.cuda.synchronize()
        assert [a - b for a, b in zip(counts(), before)] == [14, 4, 0, 0]
        assert (y.cpu() - cpu.eval()(noisy, r_pos=r_cpu)).abs().max().item() <= 1e-4

    cpu_state = create_train_state(cpu, device="cpu")
    gpu_state = create_train_state(gpu, device=cuda)
    before = counts()
    loss = train_step(gpu_state, noisy.to(cuda), clean.to(cuda), r_gpu)[0].item()
    assert [a - b for a, b in zip(counts(), before)] == [14, 4, 14, 4]
    ref = train_step(cpu_state, noisy, clean, r_cpu)[0].item()
    assert abs(loss - ref) <= 1e-5 * abs(ref)
    ref_sd = cpu.state_dict()
    for key, val in gpu.state_dict().items():
        tol = 1e-5 if key.endswith(("running_mean", "running_var")) else 1e-4
        assert (val.cpu().float() - ref_sd[key].float()).abs().max().item() <= tol, key


# B5's mma template: L = 2 to 64 (an m-tile of 8, 2 and 1 heads at L = 2,
# 8, 16), Transformer1d's stages, and groups of 4, 48 and 96 rows against
# its 64-row units (one short unit; two, the second ragged, at (32, 3));
# at every head dim, 24 padded to 32.
DENSE_MMA_SHAPES = [(2, 64), (8, 16), (16, 8), (32, 32), (64, 16), (2, 2), (8, 6), (32, 3)]
DENSE_CASES = ([(4, B, L, H) for L, H in DENSE_SHAPES for B in DENSE_BATCHES]
               + [(D, B, L, H) for D in (8, 16, 24, 32, 64) for L, H in DENSE_MMA_SHAPES
                  for B in (1, 37)]
               # The wide kernel: Transformer1d's packable stages with 256-wide
               # heads, (64, 2) and (32, 4), and other shapes, padded up (72,
               # 200) and as they are (128, 256, 320).
               + [(D, B, L, H) for D in (72, 128, 200, 256, 320)
                  for L, H in [(64, 2), (32, 4), (8, 16), (16, 2), (32, 3)] for B in (1, 5)])


@pytest.mark.parametrize("D,B,L,H", DENSE_CASES)
@pytest.mark.parametrize("with_bias", [True, False])
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_dense_kernel_matches_plain_version_and_b1(cuda, D, B, L, H, with_bias, dtype):
    """B5 within the bars of its plain version, at batches that cut across
    its blocks' groups of elements or units; at D = 4 it equals B1 without
    lse bit for bit (the same f32 expressions, keys in order), at D >= 8
    (the mma template, other arithmetic than B1's) within the bars."""
    full_float32()
    q, k, v, bias = _operands(B, H, L, with_bias, dtype, cuda, seed=3, D=D)
    before = fused_attention_dense.launches
    out = fused_attention_dense(q, k, v, bias)
    torch.cuda.synchronize()
    assert fused_attention_dense.launches == before + 1
    assert out.dtype == dtype and out.shape == q.shape
    err_plain = (out.float() - attention_dense_reference(q, k, v, bias).float()).abs().max().item()
    tol = F32_TOL if dtype == torch.float32 else BF16_TOL_OF_MAX_V * v.float().abs().max().item()
    assert err_plain <= tol, err_plain
    b1 = attention._launch(q, k, v, bias)
    if D == 4:
        assert torch.equal(out, b1)
    else:
        assert (out.float() - b1.float()).abs().max().item() <= tol
    assert torch.equal(fused_attention_dense(q, k, v, bias), out)  # no atomics


@pytest.mark.parametrize("B", DENSE_BATCHES)
@pytest.mark.parametrize("L,H", DENSE_SHAPES)
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_dense_kernel_matches_the_parent_commits(cuda, B, L, H, dtype):
    """B5 at D = 4 bit for bit the parent commit's B5 on the same operands:
    the D = 4 kernel is unchanged (skipped where the parent's tree is not
    unpacked)."""
    if not os.path.isdir(PARENT_CSRC):
        pytest.skip("the parent commit's tree is not under _archive/parent")
    from pathlib import Path

    from ecg_denoise_tpu_torch.kernels.attention import DTYPE_CODES, bind, ptr, raise_on
    from ecg_denoise_tpu_torch.kernels.attention_dense import dense_pack_factor

    q, k, v, bias = _operands(B, H, L, True, dtype, cuda, seed=L + H)
    outs = []
    for lib in (attention_dense._library(),
                bind("attention_dense_fwd", "ecg_attention_dense_fwd", 5, 7,
                     csrc=Path(PARENT_CSRC))):
        o = torch.empty_like(q)
        err = lib.ecg_attention_dense_fwd(ptr(q), ptr(k), ptr(v), ptr(bias), ptr(o), B, H, L,
                                          4, dense_pack_factor(H, L), DTYPE_CODES[dtype],
                                          cuda.index or 0,
                                          torch.cuda.current_stream().cuda_stream)
        raise_on(lib, err, "dense attention forward")
        outs.append(o)
    torch.cuda.synchronize()
    assert torch.equal(outs[0], outs[1])


def test_dense_kernel_heads_far_apart_and_large_logits(cuda):
    """Head 0 about 130 logits above head 1 in one packed group, and a
    bias lifted to about 190 (trained logits reach 191.5): each head takes
    its own max (1e-4: logits near 200 carry roundings of up to 1.5e-5)."""
    full_float32()
    q, k, v, bias = _operands(3, 32, 16, True, torch.float32, cuda, seed=4)
    far = bias.clone()
    far[0, 0] += 65.0
    far[0, 1] -= 65.0
    for b in (far, bias + 190.0):
        out = fused_attention_dense(q, k, v, b)
        torch.cuda.synchronize()
        assert torch.isfinite(out).all()
        assert (out - attention_reference(q, k, v, b)).abs().max().item() <= 1e-4


@pytest.mark.parametrize("L,H", [(8, 16), (64, 16)])
def test_dense_mma_heads_far_apart_and_large_logits(cuda, L, H):
    """B5's mma template at D = 32: head 0 about 130 logits above head 1
    (in one m-tile at L = 8, in one unit at L = 64), and a bias lifted to
    about 190: each head takes its own max (1e-4: logits near 200 carry
    roundings of up to 1.5e-5)."""
    full_float32()
    q, k, v, bias = _operands(3, H, L, True, torch.float32, cuda, seed=5, D=32)
    far = bias.clone()
    far[0, 0] += 65.0
    far[0, 1] -= 65.0
    for b in (far, bias + 190.0):
        out = fused_attention_dense(q, k, v, b)
        torch.cuda.synchronize()
        assert torch.isfinite(out).all()
        assert (out - attention_reference(q, k, v, b)).abs().max().item() <= 1e-4


def test_dense_route_and_its_refusals(cuda, monkeypatch):
    """With ECG_ATTN_DENSE=1 a no-grad call at a packable stage goes to B5;
    a grad-requiring call, or a stage that does not pack, stays on B1."""
    q, k, v, bias = _operands(4, 8, 64, True, torch.float32, cuda, seed=5)
    q256, k256, v256, _ = _operands(4, 2, 256, False, torch.float32, cuda, seed=6)

    def counts():
        return fused_attention_dense.launches, fused_attention.launches

    monkeypatch.setenv("ECG_ATTN_DENSE", "1")
    before = counts()
    with torch.no_grad():
        fused_attention(q, k, v, bias)
        fused_attention(q256, k256, v256)
    ins = [t.detach().requires_grad_() for t in (q, k, v)]
    fused_attention(*ins, bias)
    assert [a - b for a, b in zip(counts(), before)] == [1, 2]
    monkeypatch.setenv("ECG_ATTN_DENSE", "0")
    with torch.no_grad():
        fused_attention(q, k, v, bias)
    assert [a - b for a, b in zip(counts(), before)] == [1, 3]
    with pytest.raises(ValueError, match="no backward"):
        fused_attention_dense(*ins, bias)


def test_dense_model_forward_matches_cpu_with_12_and_6_launches(cuda, monkeypatch):
    monkeypatch.setenv("ECG_ATTN_DENSE", "1")
    cpu, gpu = _seeded_ralenet(cuda)
    x = torch.from_numpy(
        np.random.default_rng(1).standard_normal((8, 2, 256)).astype(np.float32))
    with torch.no_grad():
        before = (fused_attention_dense.launches, fused_attention.launches)
        y = gpu.eval()(x.to(cuda))
        torch.cuda.synchronize()
        assert (fused_attention_dense.launches - before[0],
                fused_attention.launches - before[1]) == (12, 6)
        assert (y.cpu() - cpu.eval()(x)).abs().max().item() <= 1e-4


# null_copy's sizes: one value, three, a vector short of the null tile, the
# tile, one over, 1000, and a (64, 8) call's q at B = 1024.
NULL_COPY_SIZES = [1, 3, 1000, 1023, 1024, 1025, 8 * 64 * 4 * 1024]


def _offset_view(values, offset, device):
    """`values` on `device` as a view `offset` floats past a 16-byte
    boundary (a fresh allocation is aligned)."""
    base = torch.cat([torch.zeros(offset), values.ravel()]).to(device)
    return base[offset:].view(values.shape)


@pytest.mark.parametrize("n", NULL_COPY_SIZES)
@pytest.mark.parametrize("offset", [0, 1])
def test_null_copy_is_clone(cuda, n, offset):
    """Bit for bit clone(), aligned (16-byte accesses and a scalar tail)
    and as a view 4 bytes off (4-byte accesses)."""
    from ecg_denoise_tpu_torch.kernels.null_copy import null_copy

    x = _offset_view(torch.randn(n, generator=torch.Generator().manual_seed(n)), offset, cuda)
    assert x.data_ptr() % 16 == 4 * offset
    before = null_copy.launches
    y = null_copy(x)
    torch.cuda.synchronize()
    assert null_copy.launches == before + 1
    assert torch.equal(y, x.clone()) and y.data_ptr() != x.data_ptr()


# The precision probes: (M, K, N) of the dot, (L, D) of the softmax probes,
# the divide's shape; the probe's own, then ragged ones.
DOT_SHAPES = [(256, 256, 256), (203, 141, 77), (1, 8, 1), (65, 264, 33)]
# The probe's dot readings, max|got - exact| / max|exact| and the median
# elementwise relative error, as the dot's first version gave them on an
# H100 (PERF.md): the dot's redesign keeps each output's roundings, so they
# stay within 1e-3 relative (they are kept to four digits).
PROBE_DOT_READINGS = {"ieee": (6.554e-07, 2.362e-07), "tf32": (3.578e-04, 2.956e-04),
                      "tf32x3": (2.604e-06, 1.764e-06), "bf16": (2.986e-03, 2.366e-03)}
# The fold's, as its first version gave them beside its redesign, which
# keeps each output's roundings.
PROBE_FOLD_READINGS = {"ieee": (6.636e-07, 3.058e-07), "tf32": (2.817e-04, 2.175e-04),
                       "tf32x3": (1.942e-06, 9.898e-07), "bf16": (2.121e-03, 1.677e-03)}
# The probe's, then shapes that cut across the softmax kernels' blocks (8
# query rows), row buckets, k-steps and 16-byte loads, up to L = 1024 and
# D = 15.
SOFTMAX_SHAPES = [(256, 4), (203, 3), (1, 1), (7, 2), (1024, 15), (129, 5)]
DIV_SHAPES = [(8, 256), (203, 77)]
SOFTMAX_TOL_OF_MAX = 1e-5


def _probe_operands(shape, seed=0):
    rng = np.random.default_rng(seed)
    return [torch.from_numpy(rng.standard_normal(s, np.float32)) for s in shape]


@pytest.mark.parametrize("M,K,N", DOT_SHAPES)
@pytest.mark.parametrize("precision", ["ieee", "tf32", "tf32x3", "bf16"])
def test_probe_dot_matches_plain_version(cuda, M, K, N, precision):
    from ecg_denoise_tpu_torch.kernels.precision import dot_plain, dot_tolerance, probe_dot

    a, b = (t.to(cuda) for t in _probe_operands([(M, K), (K, N)]))
    before = probe_dot.launches
    got, again = probe_dot(a, b, precision), probe_dot(a, b, precision)
    torch.cuda.synchronize()
    assert probe_dot.launches == before + 2
    assert got.shape == (M, N) and torch.equal(got, again)
    err = (got.double() - dot_plain(a, b, precision).double()).abs()
    assert (err <= dot_tolerance(a, b, precision)).all(), err.max().item()


@pytest.mark.parametrize("L,D", SOFTMAX_SHAPES)
@pytest.mark.parametrize("precision", ["ieee", "tf32", "tf32x3", "bf16", "tree"])
def test_probe_fold_and_tree_match_plain_versions(cuda, L, D, precision):
    from ecg_denoise_tpu_torch.kernels import precision as probes

    logits, v = (t.to(cuda) for t in _probe_operands([(L, L), (D, L)]))
    logits = 2.0 * logits
    if precision == "tree":
        kernel, plain = probes.probe_tree, probes.tree_plain
        run, ref = (lambda: kernel(logits, v)), plain(logits, v)
    else:
        kernel = probes.probe_fold
        run, ref = (lambda: kernel(logits, v, precision)), probes.fold_plain(logits, v, precision)
    before = kernel.launches
    got, again = run(), run()
    torch.cuda.synchronize()
    assert kernel.launches == before + 2
    assert got.shape == (D, L) and torch.equal(got, again)
    err = (got - ref).abs().max().item()
    assert err <= SOFTMAX_TOL_OF_MAX * ref.abs().max().item(), err


@pytest.mark.parametrize("L,D", SOFTMAX_SHAPES)
@pytest.mark.parametrize("precision", ["ieee", "tf32", "tf32x3", "bf16", "tree"])
def test_probe_fold_and_tree_equal_the_parent_commits(cuda, L, D, precision):
    """The fold and the tree bit for bit the parent commit's on the same
    operands (skipped where the parent's tree is not unpacked): a redesign
    keeps every rounding of the first version."""
    if not os.path.isdir(PARENT_CSRC):
        pytest.skip("the parent commit's tree is not under _archive/parent")
    from pathlib import Path

    from ecg_denoise_tpu_torch.kernels import precision as probes
    from ecg_denoise_tpu_torch.kernels.attention import bind, ptr, raise_on

    logits, v = (t.to(cuda) for t in _probe_operands([(L, L), (D, L)], seed=L + D))
    logits = 2.0 * logits
    stream = torch.cuda.current_stream().cuda_stream
    parent = Path(PARENT_CSRC)
    o = torch.empty(D, L, device=cuda)
    if precision == "tree":
        got = probes.probe_tree(logits, v)
        lib = bind("precision_probe", "ecg_probe_tree", 3, 3, csrc=parent)
        err = lib.ecg_probe_tree(ptr(logits), ptr(v), ptr(o), L, D, cuda.index or 0, stream)
    else:
        got = probes.probe_fold(logits, v, precision)
        lib = bind("precision_probe", "ecg_probe_fold", 3, 4, csrc=parent)
        err = lib.ecg_probe_fold(ptr(logits), ptr(v), ptr(o), L, D,
                                 probes.PRECISIONS.index(precision), cuda.index or 0, stream)
    raise_on(lib, err, "the parent's precision probe")
    torch.cuda.synchronize()
    assert torch.equal(got, o)


@pytest.mark.parametrize("shape", DIV_SHAPES)
def test_probe_div_is_ieee_division(cuda, shape):
    from ecg_denoise_tpu_torch.kernels.precision import probe_div

    rng = np.random.default_rng(3)
    num = rng.standard_normal(shape).astype(np.float32)
    den = (0.5 + rng.random(shape)).astype(np.float32)
    n, d = torch.from_numpy(num).to(cuda), torch.from_numpy(den).to(cuda)
    got = probe_div(n, d)
    torch.cuda.synchronize()
    assert torch.equal(got, torch.div(n, d)) and torch.equal(got, probe_div(n, d))
    assert np.array_equal(got.cpu().numpy().view(np.uint32), (num / den).view(np.uint32))


@pytest.mark.parametrize("offset", [0, 1])
def test_probe_div_at_a_ragged_size_and_offset(cuda, offset):
    """The divide at 7 x 1029 elements (no multiple of a block or of a
    vector), its operands 16-byte aligned or 4 bytes off: bit for bit
    torch.div and numpy."""
    from ecg_denoise_tpu_torch.kernels.precision import probe_div

    rng = np.random.default_rng(5)
    shape = (7, 1029)
    num = rng.standard_normal(shape).astype(np.float32)
    den = (0.5 + rng.random(shape)).astype(np.float32)
    n, d = (torch.cat([torch.zeros(offset), torch.from_numpy(x).ravel()]).to(cuda)[offset:]
            .view(shape) for x in (num, den))
    assert n.data_ptr() % 16 == 4 * offset
    got = probe_div(n, d)
    torch.cuda.synchronize()
    assert torch.equal(got, torch.div(n, d))
    assert np.array_equal(got.cpu().numpy().view(np.uint32), (num / den).view(np.uint32))


@pytest.mark.parametrize("shape", DIV_SHAPES)
@pytest.mark.parametrize("offsets", [(1, 0), (0, 3), (2, 2), (4, 0), (4, 1)])
def test_probe_div_with_mixed_alignments(cuda, shape, offsets):
    """The divide with its numerator and denominator at other offsets (in
    values) from a 16-byte boundary: one off, both off alike, both 16-byte
    aligned at another offset: bit for bit torch.div and numpy."""
    from ecg_denoise_tpu_torch.kernels.precision import probe_div

    rng = np.random.default_rng(7)
    num = rng.standard_normal(shape).astype(np.float32)
    den = (0.5 + rng.random(shape)).astype(np.float32)
    n, d = (_offset_view(torch.from_numpy(x), off, cuda) for x, off in zip((num, den), offsets))
    assert (n.data_ptr() % 16, d.data_ptr() % 16) == tuple(4 * (o % 4) for o in offsets)
    got = probe_div(n, d)
    torch.cuda.synchronize()
    assert torch.equal(got, torch.div(n, d))
    assert np.array_equal(got.cpu().numpy().view(np.uint32), (num / den).view(np.uint32))


@pytest.mark.parametrize("kernel,shape,offset", [
    ("null_copy", (n,), offset) for n in NULL_COPY_SIZES for offset in (0, 1)] + [
    ("probe_div", shape, offset) for shape in DIV_SHAPES for offset in (0, 1)])
def test_null_copy_and_probe_div_equal_the_parent_commits(cuda, kernel, shape, offset):
    """P2 and P1's divide bit for bit the parent commit's on the same
    operands, aligned and 4 bytes off (skipped where the parent's tree is
    not unpacked)."""
    if not os.path.isdir(PARENT_CSRC):
        pytest.skip("the parent commit's tree is not under _archive/parent")
    from pathlib import Path

    from ecg_denoise_tpu_torch.kernels.attention import bind, ptr, raise_on
    from ecg_denoise_tpu_torch.kernels.null_copy import null_copy
    from ecg_denoise_tpu_torch.kernels.precision import probe_div

    rng = np.random.default_rng(len(shape) + offset)
    x, y = (_offset_view(torch.from_numpy(rng.standard_normal(shape).astype(np.float32) + 2.0),
                         offset, cuda) for _ in range(2))
    stream = torch.cuda.current_stream().cuda_stream
    o = torch.empty_like(x)
    if kernel == "null_copy":
        got = null_copy(x)
        lib = bind("null_copy", "ecg_null_copy", 2, 2, csrc=Path(PARENT_CSRC))
        err = lib.ecg_null_copy(ptr(x), ptr(o), x.numel(), cuda.index or 0, stream)
    else:
        got = probe_div(x, y)
        lib = bind("precision_probe", "ecg_probe_div", 3, 2, csrc=Path(PARENT_CSRC))
        err = lib.ecg_probe_div(ptr(x), ptr(y), ptr(o), x.numel(), cuda.index or 0, stream)
    raise_on(lib, err, f"the parent's {kernel}")
    torch.cuda.synchronize()
    assert torch.equal(got, o)


def test_probe_wrappers_refuse_what_the_kernels_do_not_take(cuda):
    from ecg_denoise_tpu_torch.kernels import precision as probes

    x = torch.randn(16, 16, device=cuda)
    v = torch.randn(4, 16, device=cuda)
    before = [f.launches for f in (probes.probe_dot, probes.probe_fold,
                                   probes.probe_tree, probes.probe_div)]
    for call in (lambda t: probes.probe_dot(t, x, "tf32"), lambda t: probes.probe_fold(t, v, "bf16"),
                 lambda t: probes.probe_tree(t, v), lambda t: probes.probe_div(t, x)):
        with pytest.raises(TypeError):
            call(x.to(torch.bfloat16))
        with pytest.raises(ValueError):
            call(x.T)
    with pytest.raises(ValueError):
        probes.probe_dot(x, x, "fp8")
    assert [f.launches for f in (probes.probe_dot, probes.probe_fold,
                                 probes.probe_tree, probes.probe_div)] == before


def test_probe_dot_readings_are_unchanged(cuda):
    from ecg_denoise_tpu_torch.probes import precision as probe

    result = probe.main()
    for p, want in PROBE_DOT_READINGS.items():
        got = (result["dot"][p]["abs_of_max"], result["dot"][p]["med_rel"])
        assert all(abs(g - w) <= 1e-3 * w for g, w in zip(got, want)), (p, got, want)


def test_probe_fold_readings_are_unchanged(cuda):
    from ecg_denoise_tpu_torch.probes import precision as probe

    result = probe.main()
    for p, want in PROBE_FOLD_READINGS.items():
        got = (result["fold"][p]["abs_of_max"], result["fold"][p]["med_rel"])
        assert all(abs(g - w) <= 1e-3 * w for g, w in zip(got, want)), (p, got, want)


def test_dense_route_launches_b5_for_d32_at_a_packable_stage(cuda, monkeypatch):
    """With ECG_ATTN_DENSE=1 a no-grad D = 32 call at a packable stage,
    (L, H) = (64, 16), is one B5 launch, and one at a stage that does not
    pack, (256, 4), stays on B1."""
    monkeypatch.setenv("ECG_ATTN_DENSE", "1")
    q, k, v, _ = _operands(8, 16, 64, False, torch.float32, cuda, D=32)
    q256, k256, v256, _ = _operands(8, 4, 256, False, torch.float32, cuda, D=32)
    before = (fused_attention.launches, fused_attention_dense.launches)
    with torch.no_grad():
        out = fused_attention(q, k, v)
    torch.cuda.synchronize()
    assert (fused_attention.launches, fused_attention_dense.launches) == (
        before[0], before[1] + 1)
    assert (out - attention_reference(q, k, v)).abs().max().item() <= F32_TOL
    with torch.no_grad():
        fused_attention(q256, k256, v256)
    torch.cuda.synchronize()
    assert (fused_attention.launches, fused_attention_dense.launches) == (
        before[0] + 1, before[1] + 1)


# B5 at head_dim 32: Transformer1d's packable stages, then other shapes
# the route admits (P = 2 with one chunk of keys, P = 16 and 64), at
# batches that cut across its blocks' groups of elements.
DENSE_D32_SHAPES = [(64, 16), (32, 32), (64, 2), (16, 8), (8, 16), (2, 64)]


@pytest.mark.parametrize("B", [1, 5, 37])
@pytest.mark.parametrize("L,H", DENSE_D32_SHAPES)
@pytest.mark.parametrize("with_bias", [True, False])
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_dense_d32_kernel_matches_plain_version_and_b1(cuda, B, L, H, with_bias, dtype):
    """B5 at D = 32 within the bars of its plain version and of B1 at D =
    32 without lse (B1 now runs on the tensor cores at 3xTF32: the two no
    longer make the same operations); a second call bit-identical."""
    full_float32()
    q, k, v, bias = _operands(B, H, L, with_bias, dtype, cuda, seed=L + H, D=32)
    before = fused_attention_dense.launches
    out = fused_attention_dense(q, k, v, bias)
    torch.cuda.synchronize()
    assert fused_attention_dense.launches == before + 1
    assert out.dtype == dtype and out.shape == q.shape
    tol = F32_TOL if dtype == torch.float32 else BF16_TOL_OF_MAX_V * v.float().abs().max().item()
    assert (out.float() - attention_dense_reference(q, k, v, bias).float()
            ).abs().max().item() <= tol
    assert (out.float() - attention._launch(q, k, v, bias).float()).abs().max().item() <= tol
    assert torch.equal(fused_attention_dense(q, k, v, bias), out)  # no atomics


def _parent_lib(name, fn, n_pointers, n_ints=6):
    """The parent commit's library `name` (skips where its tree is not
    unpacked under _archive/parent)."""
    if not os.path.isdir(PARENT_CSRC):
        pytest.skip("the parent commit's tree is not under _archive/parent")
    from pathlib import Path

    from ecg_denoise_tpu_torch.kernels.attention import bind

    return bind(name, fn, n_pointers, n_ints, csrc=Path(PARENT_CSRC))


@pytest.mark.parametrize("B,L,H", [(8, L, H) for (L, H) in STAGES] + RAGGED_B1)
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_forward_kernel_at_d4_equals_the_parent_commits(cuda, B, L, H, dtype):
    """B1 at D = 4 (L <= 256, the D = 4 kernel) bit for bit the parent
    commit's B1, with its lse: the mma template left it as it was."""
    from ecg_denoise_tpu_torch.kernels.attention import DTYPE_CODES, ptr, raise_on

    lib = _parent_lib("attention_fwd", "ecg_attention_fwd", 6)
    q, k, v, bias = _operands(B, H, L, True, dtype, cuda, seed=L + H)
    o, lse = attention._launch(q, k, v, bias, with_lse=True)
    o2, lse2 = torch.empty_like(q), torch.empty_like(lse)
    err = lib.ecg_attention_fwd(ptr(q), ptr(k), ptr(v), ptr(bias), ptr(o2), ptr(lse2), B, H, L,
                                4, DTYPE_CODES[dtype], cuda.index or 0,
                                torch.cuda.current_stream().cuda_stream)
    raise_on(lib, err, "the parent's attention forward")
    torch.cuda.synchronize()
    assert torch.equal(o, o2) and torch.equal(lse, lse2)


@pytest.mark.parametrize("B", [1, 5, 37])
@pytest.mark.parametrize("L,H", DENSE_D32_SHAPES)
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_dense_d32_kernel_equals_the_parent_commits(cuda, B, L, H, dtype):
    """B5 at D = 32 within the bars of the parent commit's B5: the mma
    template computes it with other arithmetic (3xTF32 on the tensor
    cores, one softmax pass), so no longer bit for bit."""
    from ecg_denoise_tpu_torch.kernels.attention import DTYPE_CODES, ptr, raise_on
    from ecg_denoise_tpu_torch.kernels.attention_dense import dense_pack_factor

    lib = _parent_lib("attention_dense_fwd", "ecg_attention_dense_fwd", 5, 7)
    q, k, v, bias = _operands(B, H, L, True, dtype, cuda, seed=L + H, D=32)
    out = fused_attention_dense(q, k, v, bias)
    old = torch.empty_like(q)
    err = lib.ecg_attention_dense_fwd(ptr(q), ptr(k), ptr(v), ptr(bias), ptr(old), B, H, L, 32,
                                      dense_pack_factor(H, L), DTYPE_CODES[dtype],
                                      cuda.index or 0, torch.cuda.current_stream().cuda_stream)
    raise_on(lib, err, "the parent's dense attention forward")
    torch.cuda.synchronize()
    tol = F32_TOL if dtype == torch.float32 else BF16_TOL_OF_MAX_V * v.float().abs().max().item()
    assert (out.float() - old.float()).abs().max().item() <= tol


def test_dense_d32_transformer1d_matches_cpu_with_its_launches(cuda, monkeypatch):
    """A small Transformer1d whose two stages pack ((64, 2), (32, 4)) with
    ECG_ATTN_DENSE=1: the card's forward within 1e-4 of the CPU's, with one
    B5 launch a block and no B1."""
    from ecg_denoise_tpu_torch.models import Transformer1d
    from ecg_denoise_tpu_torch.train import create_train_state

    monkeypatch.setenv("ECG_ATTN_DENSE", "1")
    torch.manual_seed(2)
    cpu = Transformer1d(num_class=3, in_channels=4, embed_dim=64, depths=(1, 1),
                        num_heads=(2, 4)).eval()
    x = torch.randn(8, 4, 64)
    gpu = create_train_state(copy.deepcopy(cpu)).model.eval()
    before = (fused_attention.launches, fused_attention_dense.launches)
    with torch.no_grad():
        y = gpu(x.to(cuda))
        torch.cuda.synchronize()
        assert (fused_attention.launches - before[0],
                fused_attention_dense.launches - before[1]) == (0, 2)
        assert (y.cpu() - cpu(x)).abs().max().item() <= 1e-4


# B1 and B2 at head_dim 32 past 256 keys: 10-second PTB-XL records at
# 100 Hz through Transformer1d's four stages (L = 250 and 125 are ragged
# against the 64-row tiles and 32-key chunks, as is 1000 against the
# chunks), and another ragged length.
D32_LONG = [(2, 1000, 4), (2, 500, 8), (2, 250, 16), (2, 125, 32), (1, 300, 2)]


@pytest.mark.parametrize("B,L,H", D32_LONG)
@pytest.mark.parametrize("with_bias", [True, False])
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_b1_and_b2_at_d32_past_256(cuda, B, L, H, with_bias, dtype):
    """B1 with its lse and B2 through the autograd Function against their
    plain versions at the bars of the stage-shape tests."""
    full_float32()
    q, k, v, bias = _operands(B, H, L, with_bias, dtype, cuda, seed=L + H, D=32)
    out, lse = attention._launch(q, k, v, bias, with_lse=True)
    ref, ref_lse = attention_reference(q, k, v, bias, return_lse=True)
    tol = F32_TOL if dtype == torch.float32 else BF16_TOL_OF_MAX_V * v.float().abs().max().item()
    assert (out.float() - ref.float()).abs().max().item() <= tol
    assert (lse - ref_lse).abs().max().item() <= LSE_TOL * max(1.0, ref_lse.abs().max().item())
    g = torch.randn(q.shape, generator=torch.Generator().manual_seed(1)).to(cuda, dtype)
    before = fused_attention.bwd_launches
    out, grads = _grads(q, k, v, bias, g)
    torch.cuda.synchronize()
    assert fused_attention.bwd_launches == before + 1
    _, lse = attention_reference(q, k, v, bias, return_lse=True)
    flash = attention_backward_reference(q, k, v, bias, out.detach(), lse, g)
    for name, a, b in zip("q k v bias".split(), grads, flash):
        scale = b.float().abs().max().item()
        tol = (BF16_GRAD_TOL_OF_MAX if dtype == torch.bfloat16 else D32_GRAD_TOL_OF_MAX) * scale
        assert (a.float() - b.float()).abs().max().item() <= tol, name


def test_transformer1d_matches_cpu_with_its_launches(cuda):
    """A small Transformer1d (head_dim 32, one block a stage) on the card
    against the CPU within 1e-4, eval and one training step's loss, with
    one B1 launch a block forward and one B2 a block backward."""
    from ecg_denoise_tpu_torch.models import Transformer1d
    from ecg_denoise_tpu_torch.train import create_train_state, make_cls_epoch_fns

    torch.manual_seed(0)
    cpu = Transformer1d(num_class=3, in_channels=4, embed_dim=64, depths=(1, 1),
                        num_heads=(2, 4)).eval()
    x = torch.randn(8, 4, 64)
    label = torch.randint(0, 3, (8,))
    gpu = create_train_state(copy.deepcopy(cpu)).model.eval()
    before = fused_attention.launches
    with torch.no_grad():
        y = gpu(x.to(cuda))
    torch.cuda.synchronize()
    assert fused_attention.launches == before + 2
    with torch.no_grad():
        assert (y.cpu() - cpu(x)).abs().max().item() <= 1e-4
    got = []
    for model, device in ((gpu, cuda), (cpu, torch.device("cpu"))):
        state = create_train_state(model, device=device)
        train_epoch, _ = make_cls_epoch_fns(state.model, state.optimizer)
        counts = (fused_attention.launches, fused_attention.bwd_launches)
        gen = torch.Generator(device=device).manual_seed(0)
        got.append(train_epoch(x.to(device), label.to(device), gen, 8)["loss"])
        if device.type == "cuda":
            torch.cuda.synchronize()
            assert (fused_attention.launches - counts[0],
                    fused_attention.bwd_launches - counts[1]) == (2, 2)
    assert abs(got[0] - got[1]) <= 1e-5 * abs(got[1])


def test_wide_head_transformer1d_matches_cpu_with_its_launches(cuda, monkeypatch):
    """A small Transformer1d with heads 128 and 256 wide (embed 128, heads
    (1, 1); the wide kernels) on the card against the CPU within 1e-4, eval
    and one training step's loss, with one B1 launch a block forward and
    one B2 a block backward; with ECG_ATTN_DENSE=1, at embed 256 and heads
    (2, 2) (D = 128 at L = 64, 256 at L = 32: both pack, P = 2), one B5
    launch a block, within 1e-5 of the default route."""
    from ecg_denoise_tpu_torch.models import Transformer1d
    from ecg_denoise_tpu_torch.train import create_train_state, make_cls_epoch_fns

    torch.manual_seed(3)
    cpu = Transformer1d(num_class=3, in_channels=4, embed_dim=128, depths=(1, 1),
                        num_heads=(1, 1)).eval()
    x = torch.randn(8, 4, 64)
    label = torch.randint(0, 3, (8,))
    gpu = create_train_state(copy.deepcopy(cpu)).model.eval()
    before = fused_attention.launches
    with torch.no_grad():
        y = gpu(x.to(cuda))
    torch.cuda.synchronize()
    assert fused_attention.launches == before + 2
    with torch.no_grad():
        assert (y.cpu() - cpu(x)).abs().max().item() <= 1e-4
    got = []
    for model, device in ((gpu, cuda), (cpu, torch.device("cpu"))):
        state = create_train_state(model, device=device)
        train_epoch, _ = make_cls_epoch_fns(state.model, state.optimizer)
        counts = (fused_attention.launches, fused_attention.bwd_launches)
        gen = torch.Generator(device=device).manual_seed(0)
        got.append(train_epoch(x.to(device), label.to(device), gen, 8)["loss"])
        if device.type == "cuda":
            torch.cuda.synchronize()
            assert (fused_attention.launches - counts[0],
                    fused_attention.bwd_launches - counts[1]) == (2, 2)
    assert abs(got[0] - got[1]) <= 1e-5 * abs(got[1])

    dense = Transformer1d(num_class=3, in_channels=4, embed_dim=256, depths=(1, 1),
                          num_heads=(2, 2))
    dense = create_train_state(dense).model.eval()
    xd = torch.randn(8, 4, 64).to(cuda)
    with torch.no_grad():
        monkeypatch.setenv("ECG_ATTN_DENSE", "0")
        y_default = dense(xd)
        monkeypatch.setenv("ECG_ATTN_DENSE", "1")
        before = (fused_attention.launches, fused_attention_dense.launches)
        y_dense = dense(xd)
        torch.cuda.synchronize()
    assert (fused_attention.launches - before[0],
            fused_attention_dense.launches - before[1]) == (0, 2)
    assert (y_dense - y_default).abs().max().item() <= F32_TOL


# Kernels this tree leaves as the parent commit had them, on the same
# operands bit for bit (skipped where the parent's tree is not unpacked):
# B1 and B2 on the mma template (head_dim 8, 16, 32, 64; D = 4 past 256
# keys on it) and on the wide kernels (128, 320), B3 on the wide kernel (o,
# lse) and B4's dq, dk and dv on B2's wide passes (its dtoep is formed
# anew, from the dq pass's ds), and B5 on its template and its wide
# kernel. B3 and B4 at D <= 64 run on their own window kernels, whose
# arithmetic is new: held there to their bars against their plain
# versions.
TEMPLATE_PARENT_CASES = [(D, B, L, H) for D in (8, 16, 32, 64, 128, 320)
                         for (B, L, H) in ((3, 203, 2), (5, 32, 3))] + [(4, 2, 300, 2)]
DENSE_PARENT_CASES = [(D, 3, L, H) for D in (8, 16, 32, 64, 128, 256)
                      for (L, H) in ((64, 2), (32, 4), (8, 16))]


@pytest.mark.parametrize("D,B,L,H", TEMPLATE_PARENT_CASES)
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_templates_equal_the_parent_commits(cuda, D, B, L, H, dtype):
    from ecg_denoise_tpu_torch.kernels import attention_rpos
    from ecg_denoise_tpu_torch.kernels.attention import (
        DTYPE_CODES,
        kernel_head_dim,
        ptr,
        raise_on,
    )

    Dk = kernel_head_dim(D, L, dtype)
    code, dev, stream = DTYPE_CODES[dtype], cuda.index or 0, torch.cuda.current_stream().cuda_stream
    libs = [(attention._library(), attention._bwd_library(), attention_rpos._library(),
             attention_rpos._bwd_library()),
            (_parent_lib("attention_fwd", "ecg_attention_fwd", 6),
             _parent_lib("attention_bwd", "ecg_attention_bwd", 12),
             _parent_lib("attention_rpos_fwd", "ecg_attention_rpos_fwd", 7, 7),
             _parent_lib("attention_rpos_bwd", "ecg_attention_rpos_bwd", 14, 7))]
    q, k, v, bias = _operands(B, H, L, True, dtype, cuda, seed=D + L, D=Dk)
    g = torch.randn(q.shape, generator=torch.Generator().manual_seed(4)).to(cuda, dtype)
    (rq, rk, rv, toep), W, offsets = _rpos_operands(B, L, max(1, L // 8), H, dtype, cuda,
                                                    seed=D + L, D=Dk)
    outs = []
    for mine, (b1, b2, b3, b4) in enumerate(libs):
        o, ro = torch.empty_like(q), torch.empty_like(rq)
        lse, rlse = (torch.empty(B, H, L, device=cuda) for _ in range(2))
        raise_on(b1, b1.ecg_attention_fwd(ptr(q), ptr(k), ptr(v), ptr(bias), ptr(o), ptr(lse),
                                          B, H, L, Dk, code, dev, stream), "B1")
        raise_on(b3, b3.ecg_attention_rpos_fwd(ptr(rq), ptr(rk), ptr(rv), ptr(toep),
                                               ptr(offsets), ptr(ro), ptr(rlse), B, H, L, Dk,
                                               W, code, dev, stream), "B3")
        if outs:  # both backwards on this tree's forward
            o, lse, ro, rlse = (outs[0][i] for i in (0, 1, 6, 7))
        grads = [torch.empty_like(q) for _ in range(3)] + [torch.empty_like(rq)
                                                           for _ in range(3)]
        c = torch.empty(B, H, L, device=cuda)
        dbias, dtoep = (torch.empty(1, H, L, L, device=cuda) for _ in range(2))
        raise_on(b2, b2.ecg_attention_bwd(ptr(q), ptr(k), ptr(v), ptr(bias), ptr(g), ptr(o),
                                          ptr(lse), ptr(c), *map(ptr, grads[:3]), ptr(dbias),
                                          B, H, L, Dk, code, dev, stream), "B2")
        ds = torch.empty(B, H, min(W, L), min(W, L), device=cuda)
        raise_on(b4, b4.ecg_attention_rpos_bwd(ptr(rq), ptr(rk), ptr(rv), ptr(toep),
                                               ptr(offsets), ptr(g), ptr(ro), ptr(rlse), ptr(c),
                                               *map(ptr, grads[3:]), ptr(dtoep), ptr(ds), B, H,
                                               L, Dk, W, code, dev, stream), "B4")
        outs.append((o, lse, *grads[:3], dbias, ro, rlse, *grads[3:]))
    torch.cuda.synchronize()
    names = ("o", "lse", "dq", "dk", "dv", "dbias", "B3 o", "B3 lse", "B4 dq", "B4 dk", "B4 dv")
    window_kernel = Dk <= 64  # B3's and B4's own kernels: their bars, not the parent's bits
    for name, a, b in zip(names, *outs):
        if not (window_kernel and name.startswith(("B3", "B4"))):
            assert torch.equal(a, b), name
    if window_kernel:
        want = attention_rpos_backward_reference(rq, rk, rv, toep, W, offsets, outs[0][6],
                                                 outs[0][7], g)
        for name, a, b in zip(("dq", "dk", "dv"), outs[0][8:], want):
            scale = b.float().abs().max().item()
            bar = BF16_GRAD_TOL_OF_MAX * scale if dtype == torch.bfloat16 else GRAD_TOL
            err = (a.float() - b.float()).abs().max().item()
            assert err <= bar, (name, err, bar)
        ref, ref_lse = attention_rpos_reference(rq, rk, rv, toep, W, offsets, return_lse=True)
        tol = (F32_TOL if dtype == torch.float32
               else BF16_TOL_OF_MAX_V * rv.float().abs().max().item())
        assert (outs[0][6].float() - ref.float()).abs().max().item() <= tol
        lse_err = (outs[0][7] - ref_lse).abs().max().item()
        assert lse_err <= LSE_TOL * max(1.0, ref_lse.abs().max().item()), lse_err


@pytest.mark.parametrize("D,B,L,H", DENSE_PARENT_CASES)
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_dense_kernels_equal_the_parent_commits(cuda, D, B, L, H, dtype):
    from ecg_denoise_tpu_torch.kernels.attention import (
        DTYPE_CODES,
        kernel_head_dim,
        ptr,
        raise_on,
    )
    from ecg_denoise_tpu_torch.kernels.attention_dense import dense_pack_factor

    lib = _parent_lib("attention_dense_fwd", "ecg_attention_dense_fwd", 5, 7)
    D = kernel_head_dim(D, L, dtype)  # bf16 from 16
    q, k, v, bias = _operands(B, H, L, True, dtype, cuda, seed=L + H, D=D)
    out = fused_attention_dense(q, k, v, bias)
    old = torch.empty_like(q)
    err = lib.ecg_attention_dense_fwd(ptr(q), ptr(k), ptr(v), ptr(bias), ptr(old), B, H, L, D,
                                      dense_pack_factor(H, L), DTYPE_CODES[dtype],
                                      cuda.index or 0, torch.cuda.current_stream().cuda_stream)
    raise_on(lib, err, "the parent's dense attention forward")
    torch.cuda.synchronize()
    assert torch.equal(out, old)
