"""The Hopper attention kernel against its plain version, on the card.

Marked `gpu`; each test takes the `cuda` fixture, which skips when no card
is present (decided at run time, so every pytest-xdist worker collects the
same tests). Run on a machine with the card:

    python -m pytest tests/test_torch_port_cuda.py -q -m gpu

Tolerances: float32 1e-5 (both sides compute float32 logits and softmax;
the plain version's matmuls run in full float32, PyTorch's default and the
port's choice, `ecg_denoise_tpu_torch.full_float32`). bfloat16 3 * 2^-8 of max|v|: the plain version rounds the
probabilities to bf16 before the pv product and the kernel does not (up to
2^-8 of max|v|), and each side rounds its output once to bf16 (up to 2^-8
of |out| <= max|v| each).
"""

import numpy as np
import pytest
import torch

from ecg_denoise_tpu_torch.kernels.attention import (
    attention_reference,
    fused_attention,
)

pytestmark = pytest.mark.gpu

STAGES = [(256, 2), (128, 4), (64, 8), (32, 16), (16, 32)]
F32_TOL = 1e-5
BF16_TOL_OF_MAX_V = 3 * 2 ** -8


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA card")
    return torch.device("cuda")


def _operands(B, H, L, with_bias, dtype, device, seed=0):
    g = torch.Generator().manual_seed(seed)
    q, k, v = (torch.randn(B, H, L, 4, generator=g) for _ in range(3))
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


def test_cuda_call_needing_a_gradient_raises(cuda):
    q, k, v, _ = _operands(2, 4, 32, False, torch.float32, cuda)
    q.requires_grad_(True)
    with pytest.raises(NotImplementedError):
        fused_attention(q, k, v)


def test_model_forward_matches_cpu_with_18_launches(cuda):
    from ecg_denoise_tpu_torch.models import build_model

    torch.manual_seed(0)
    cpu = build_model("ralenet", device="cpu").eval()
    with torch.no_grad():
        for name, p in cpu.named_parameters():
            if "relative_position_bias_table" in name:
                p.normal_()
    gpu = build_model("ralenet", device=cuda).eval()
    gpu.load_state_dict(cpu.state_dict())
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
