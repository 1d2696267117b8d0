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
torch.set_num_threads(1)  # six test workers share the host's cores: one intra-op thread each
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


@pytest.mark.parametrize("use_pallas", [True, False])
def test_per_window_r_pos_forward_matches_jax(monkeypatch, use_pallas):
    """RaleNet 'full' (depth 1) with a (B,) r_pos — the `--r_pos detect`
    path — against the JAX model with its Pallas r-pos kernel pair in
    interpret mode, and against its XLA path (the materialised bias). The
    positions come from the port's detector, cover both edges, and differ
    per window; the rel-pos tables are nonzero."""
    from ecg_denoise_tpu_torch.data.rpeaks import detect_r_peaks

    monkeypatch.setattr(ap, "_INTERPRET", True)
    x = np.random.default_rng(7).standard_normal((4, 2, 256)).astype(np.float32)
    r_pos = detect_r_peaks(torch.from_numpy(x))
    r_pos[:2] = torch.tensor([0, 255])  # windows hanging off both ends
    assert len(set(r_pos.tolist())) == 4
    jm = JaxRaleNet(variant="full", depth=1, use_pallas=use_pallas)
    v = random_variables(jm, jnp.asarray(x), seed=8)
    pm = RaleNet(variant="full", depth=1)
    pm.load_state_dict(ralenet_state_dict(v, "full"))
    with torch.no_grad():
        y = pm.eval()(torch.from_numpy(x), r_pos=r_pos).numpy()
        y_centre = pm(torch.from_numpy(x)).numpy()
    ref = jax.jit(lambda v, x, r: jm.apply(v, x, train=False, r_pos=r))(
        v, x, jnp.asarray(r_pos.numpy(), jnp.int32))
    np.testing.assert_allclose(y, np.asarray(ref), atol=ATOL, rtol=0)
    assert np.abs(y - y_centre).max() > 100 * ATOL  # the positions matter


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


@pytest.mark.parametrize("name,cls,in_channels", [
    ("unet", "UNet", 2), ("DANet", "Seq2Seq2", 2), ("ralenet_nra", "RaleNet", 2),
    ("ralenet_mlp", "RaleNet", 2), ("ralenet", "RaleNet", 2), ("ACDAE", "ACDAE", 2),
    ("newrale", "NewRale", 12),
])
def test_build_model_builds_every_name(monkeypatch, name, cls, in_channels):
    """Every name of MODEL_NAMES and "newrale": on the CPU when asked, on
    the card by default (which raises without one)."""
    m = build_model(name, device="cpu")
    assert type(m).__name__ == cls and m.in_channels == in_channels
    assert all(p.device.type == "cpu" for p in m.parameters())
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        build_model(name)


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


def test_dense_route_forward_matches_jax_dense_kernel(monkeypatch):
    """With ECG_ATTN_DENSE=1: the port's RaleNet 'full' on the CPU (the
    plain attention) against the JAX model whose packable stages go through
    its dense kernel `_fwd_dense` in interpret mode (6 of the 9 attention
    calls at depth 1: L = 64, 32 and 16). Depth 1 keeps the JAX compile
    short; widths are the model's own."""
    monkeypatch.setattr(ap, "_INTERPRET", True)
    monkeypatch.setenv("ECG_ATTN_DENSE", "1")
    calls = []
    real = ap._fwd_dense

    def counted(*args, **kwargs):
        calls.append(args[0].shape[1:3])
        return real(*args, **kwargs)

    monkeypatch.setattr(ap, "_fwd_dense", counted)
    x = _x(9)
    jm = JaxRaleNet(variant="full", depth=1, use_pallas=True)
    v = random_variables(jm, jnp.asarray(x), seed=10)
    pm = RaleNet(variant="full", depth=1)
    pm.load_state_dict(ralenet_state_dict(v, "full"))
    ref = np.asarray(_jax_eval(jm)(v, x))
    # Counted per trace, and JAX may trace a call more than once.
    assert set(calls) == {(8, 64), (16, 32), (32, 16)}
    np.testing.assert_allclose(_port_eval(pm, x), ref, atol=ATOL, rtol=0)
