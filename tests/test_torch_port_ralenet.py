"""The port's RaleNet against the JAX package's, on the same weights.

Weights go both ways: random numpy variables of the JAX model reach the
port through `interop.jax_weights.ralenet_state_dict`, and a port
module's weights reach the JAX model through the JAX package's own
`interop.torch_weights.ralenet_variables`. Eval outputs must agree within
1e-4 at float32 (the bar of tests/test_torch_parity.py). Depth is cut to 1
for 'mlp' and 'nra' to keep the JAX CPU compiles short; 'full' runs at
its real depth 2. All widths are the model's own.
"""

import numpy as np
import pytest
import torch
import jax
import jax.numpy as jnp

import ecg_denoise_tpu.kernels.attention_pallas as ap
from ecg_denoise_tpu.interop.torch_weights import ralenet_variables
from ecg_denoise_tpu.models.ralenet import RaleNet as JaxRaleNet
from ecg_denoise_tpu_torch.interop.jax_weights import ralenet_state_dict
from ecg_denoise_tpu_torch.models import build_model
from ecg_denoise_tpu_torch.models.ralenet import RaleNet
from test_torch_port_layers import random_variables

ATOL = 1e-4
DEPTH = {"full": 2, "mlp": 1, "nra": 1}


def _x(seed=1):
    return np.random.default_rng(seed).standard_normal((2, 2, 256)).astype(np.float32)


def _jax_eval(model):
    return jax.jit(lambda v, x: model.apply(v, x, train=False))


def _port_eval(model, x):
    with torch.no_grad():
        return model.eval()(torch.from_numpy(x)).numpy()


@pytest.mark.parametrize("variant", ["full", "mlp", "nra"])
def test_forward_matches_jax(variant):
    x = _x()
    jm = JaxRaleNet(variant=variant, depth=DEPTH[variant])
    v = random_variables(jm, jnp.asarray(x))
    pm = RaleNet(variant=variant, depth=DEPTH[variant])
    pm.load_state_dict(ralenet_state_dict(v, variant))
    y = _port_eval(pm, x)
    assert y.shape == x.shape
    np.testing.assert_allclose(y, np.asarray(_jax_eval(jm)(v, x)), atol=ATOL, rtol=0)


def test_forward_matches_jax_pallas_kernel(monkeypatch):
    """The JAX model with its fused Pallas kernel, run in interpret mode."""
    monkeypatch.setattr(ap, "_INTERPRET", True)
    x = _x(2)
    jm = JaxRaleNet(variant="full", use_pallas=True)
    v = random_variables(jm, jnp.asarray(x), seed=4)
    pm = RaleNet(variant="full")
    pm.load_state_dict(ralenet_state_dict(v, "full"))
    np.testing.assert_allclose(_port_eval(pm, x), np.asarray(_jax_eval(jm)(v, x)),
                               atol=ATOL, rtol=0)


def test_port_weights_read_by_jax_interop():
    """Port module -> the JAX package's ralenet_variables -> JAX model; and
    ralenet_state_dict inverts ralenet_variables exactly."""
    torch.manual_seed(0)
    pm = RaleNet(variant="mlp", depth=1)
    with torch.no_grad():  # nonzero tables and BN stats
        for name, p in pm.named_parameters():
            if "relative_position_bias_table" in name:
                p.normal_()
        pm.conv1[2].running_mean.normal_(0, 0.1)
        pm.conv1[2].running_var.uniform_(0.5, 1.5)
    variables = ralenet_variables(pm, high_enh=False, has_bias=True)
    sd = ralenet_state_dict(variables, "mlp")
    assert sd.keys() == pm.state_dict().keys()
    for key, val in pm.state_dict().items():
        torch.testing.assert_close(sd[key], val, atol=0, rtol=0, msg=key)
    x = _x(3)
    jm = JaxRaleNet(variant="mlp", depth=1)
    np.testing.assert_allclose(_port_eval(pm, x),
                               np.asarray(_jax_eval(jm)(variables, x)),
                               atol=ATOL, rtol=0)


def test_state_dict_keys_are_the_reference_names():
    keys = RaleNet(variant="full", depth=1).state_dict().keys()
    for key in ("conv1.0.weight", "conv1.2.running_var", "transconv.0.bias",
                "dtransformer34.blocks.0.attn.qkv_proj.to_kv.weight",
                "utranformer3.blocks.0.mlp.leconv.partial_conv3.weight",
                "rwattn4.relative_position_bias_table", "pm4.reduction.weight",
                "ps1.norm.bias", "transformer.blocks.0.norm2.weight"):
        assert key in keys
    nra = RaleNet(variant="nra", depth=1).state_dict().keys()
    assert not any(k.startswith("rwattn") for k in nra)


def test_variant_mismatch_raises():
    x = jnp.zeros((2, 2, 256))
    v = random_variables(JaxRaleNet(variant="nra", depth=1), x)
    with pytest.raises(ValueError, match="rel-pos"):
        ralenet_state_dict(v, "full")


@pytest.mark.parametrize("name,variant", [
    ("ralenet", "full"), ("ralenet_mlp", "mlp"), ("ralenet_nra", "nra"),
    (4, "full"), (3, "mlp"), (2, "nra"),
])
def test_build_model(name, variant):
    m = build_model(name, device="cpu")
    assert isinstance(m, RaleNet) and m.variant == variant
    assert len(m.transformer.blocks) == 2  # the model's own depth
    assert next(m.parameters()).device.type == "cpu"


@pytest.mark.parametrize("name", ["unet", "DANet", "ACDAE", 0, 5, "newrale"])
def test_models_not_ported_yet_raise(name):
    with pytest.raises(NotImplementedError, match="ROADMAP"):
        build_model(name, device="cpu")


def test_bfloat16_forward():
    """RaleNet 'full' computing in bfloat16 from float32 parameters,
    against the JAX model at dtype=bfloat16 on the same weights.

    Tolerance 2^-5: four bfloat16 spacings at the outputs' magnitude (|y| <
    2, asserted, so one spacing is at most 2^-7). Layer by layer the two
    round the same casts bit for bit (test_torch_port_layers); here they
    part where XLA fuses an elementwise chain and rounds it once, and in
    GELU, and a flipped last bit travels through some 40 layers. No bound
    on the maximum error separates bfloat16 from float32 compute at the
    model level: the JAX model's own jitted and op-by-op bfloat16 runs
    differ by about as much as bfloat16 and float32 do. The casts are held
    by the per-layer tests.
    """
    x = _x(5)
    jm = JaxRaleNet(variant="full", depth=DEPTH["full"], dtype=jnp.bfloat16)
    v = random_variables(jm, jnp.asarray(x), seed=6)
    pm = RaleNet(variant="full", depth=DEPTH["full"], dtype=torch.bfloat16)
    pm.load_state_dict(ralenet_state_dict(v, "full"))
    assert all(p.dtype == torch.float32 for p in pm.parameters())
    with torch.no_grad():
        y = pm.eval()(torch.from_numpy(x))
    assert y.dtype == torch.bfloat16 and torch.isfinite(y).all()
    ref = np.asarray(_jax_eval(jm)(v, x)).astype(np.float32)
    assert np.abs(ref).max() < 2
    np.testing.assert_allclose(y.float().numpy(), ref, atol=2 ** -5, rtol=0)
