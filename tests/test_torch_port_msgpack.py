"""The port's reader of the JAX package's `.msgpack` checkpoints, on the CPU.

`interop.flax_msgpack` decodes what flax's `serialization.to_bytes` writes
without msgpack or flax: held against `msgpack.packb` of fixed trees that
take every header it reads (each fixint, int, uint, float, str, bin,
array, map and ext width, nil and the bools) and against flax's own
`msgpack_restore` of flax trees (ndarrays of every dtype a checkpoint
holds, bfloat16 too, numpy scalars, a complex, a chunked array).

The fixture tests/data/jax_ckpt/ holds a full JAX TrainState of UNet after
one JAX Adam step, under JAX's file name scheme, and 8 seeded windows with
JAX's eval output on them (`write_fixture` wrote it once:
`JAX_PLATFORMS=cpu python -c "import sys; sys.path.insert(0, 'tests');
import test_torch_port_msgpack as t; t.write_fixture()"`). The tests hold
the committed files to the JAX package (flax's restore and the decoder
agree leaf for leaf, JAX's model reproduces the committed output within
1e-6), serve the fixture through the port within 1e-4 of JAX's output,
resume it and take one step against JAX's step from the same state (loss
1e-5 relative, gradients and parameters at `chip_smoke.step_bars`), serve
a RA-LENet 'full' TrainState that JAX's `save_checkpoint` writes in
tmp_path, find a `.msgpack` with `find_model`, and refuse to resume a
frozen-mask state. The classifiers too: a ResNetCls and a small
Transformer1d TrainState that JAX writes in tmp_path, with random BatchNorm
stats and random Adam moments at count 3, resumed by the port's
`load_checkpoint` (weights, stats and moments bit for bit, Adam at step 3)
and its logits within 1e-4 of JAX's eval forward.
"""

import os

import msgpack
import numpy as np
import pytest
import torch
torch.set_num_threads(1)  # six test workers share the host's cores: one intra-op thread each
import jax
import jax.numpy as jnp
from flax import serialization

from ecg_denoise_tpu.models import RaleNet as JaxRaleNet
from ecg_denoise_tpu.models import ResNetCls as JaxResNetCls
from ecg_denoise_tpu.models import Transformer1d as JaxTransformer1d
from ecg_denoise_tpu.models import UNet as JaxUNet
from ecg_denoise_tpu.train import checkpoint as jax_checkpoint
from ecg_denoise_tpu.train import create_train_state as jax_train_state
from ecg_denoise_tpu.train import make_epoch_fns as jax_epoch_fns
from ecg_denoise_tpu_torch import NOISE_INTENSITIES, NOISE_TYPES
from ecg_denoise_tpu_torch.interop import flax_msgpack
from ecg_denoise_tpu_torch.interop.jax_weights import (
    resnet_cls_state_dict,
    transformer1d_state_dict,
    unet_state_dict,
)
from ecg_denoise_tpu_torch.models import ResNetCls, Transformer1d, build_model
from ecg_denoise_tpu_torch.serving import Denoiser
from ecg_denoise_tpu_torch.train import (
    create_train_state,
    find_model,
    load_checkpoint,
    load_model_weights,
    make_epoch_fns,
)
from test_torch_port_layers import random_variables

FIXTURE = os.path.join(os.path.dirname(os.path.abspath(__file__)), "data", "jax_ckpt")
CKPT_NAME = ("unet", 1, NOISE_TYPES[0], NOISE_INTENSITIES[0])  # name, epoch, noise, k
FIXTURE_CKPT = jax_checkpoint.checkpoint_path(FIXTURE, *CKPT_NAME)
FIXTURE_EVAL = os.path.join(FIXTURE, "unet_eval.npz")
BATCH = 4
SERVE_ATOL = 1e-4
REPRODUCE_ATOL = 1e-6
LOSS_TOL = 1e-5


def _noisy_clean(n, seed):
    rng = np.random.default_rng(seed)
    t = np.linspace(0, 6 * np.pi, 256)
    clean = np.sin(t + rng.uniform(0, 6, (n, 2, 1)))
    noisy = clean + 0.5 * rng.standard_normal(clean.shape)
    return noisy.astype(np.float32), clean.astype(np.float32)


def _jax_unet_state(frozen=False):
    jm = JaxUNet()
    v = random_variables(jm, jnp.zeros((2, 2, 256)), seed=15)
    mask = None
    if frozen:  # the first encoder stage frozen, as transfer learning freezes a core
        mask = jax.tree_util.tree_map_with_path(
            lambda path, _: path[0].key == "enc0", v["params"])
    state, tx = jax_train_state(jm, jax.random.PRNGKey(0), jnp.zeros((2, 2, 256)),
                                variables=v, frozen_mask=mask)
    return jm, state, tx


def write_fixture(directory=FIXTURE):
    """Write the committed fixture: UNet's TrainState after one JAX Adam
    step, and 8 seeded windows with JAX's eval output on them."""
    jm, state, tx = _jax_unet_state()
    train, _ = jax_epoch_fns(jm, tx, donate=False)
    noisy, clean = _noisy_clean(BATCH, seed=15)
    state, _ = train(state, jnp.asarray(noisy), jnp.asarray(clean), jax.random.PRNGKey(0),
                     BATCH)
    jax_checkpoint.save_checkpoint(jax_checkpoint.checkpoint_path(directory, *CKPT_NAME),
                                   state)
    x = np.random.default_rng(16).standard_normal((8, 2, 256)).astype(np.float32)
    y = jm.apply({"params": state.params, "batch_stats": state.batch_stats}, x, train=False)
    np.savez(os.path.join(directory, "unet_eval.npz"), x=x, y=np.asarray(y))


def _leaves(tree):
    return jax.tree_util.tree_flatten_with_path(tree)[0]


def _assert_same_tree(got, ref):
    got, ref = _leaves(got), _leaves(ref)
    assert [p for p, _ in got] == [p for p, _ in ref]
    for (path, a), (_, b) in zip(got, ref):
        a, b = np.asarray(a), np.asarray(b)
        assert a.dtype == b.dtype and a.shape == b.shape, path
        assert np.array_equal(a, b), path


# --- the decoder ------------------------------------------------------------

# Values whose msgpack headers cover every width: fixints, each int and
# uint, float64, each str, bin, array and map length field, nil, bools.
HEADER_VALUES = [
    0, 127, -1, -32, 128, 255, 256, 65535, 65536, 2**32 - 1, 2**32, 2**64 - 1,
    -33, -128, -129, -32768, -32769, -2**31, -2**31 - 1, -2**63,
    1.5, -2.25e300, None, True, False,
    "", "a" * 31, "b" * 32, "c" * 255, "d" * 256, "e" * 65535, "f" * 65536, "été",
    b"", b"\x00" * 255, b"\x01" * 256, b"\x02" * 65535, b"\x03" * 65536,
    [], list(range(15)), list(range(16)), list(range(65535)), list(range(65536)),
    {}, {str(i): i for i in range(15)}, {str(i): i for i in range(16)},
    {str(i): i for i in range(65536)}, {"nested": [{"x": [1, 2.5, None]}, b"\xff"]},
]
EXT_SIZES = [1, 2, 4, 8, 16, 3, 255, 256, 65535, 65536]  # fixext, then ext 8, 16, 32


@pytest.mark.parametrize("i", range(len(HEADER_VALUES)))
def test_decoder_reads_every_header(i):
    value = HEADER_VALUES[i]
    data = msgpack.packb(value, use_bin_type=True)
    assert flax_msgpack._unpack(data) == value == msgpack.unpackb(data, raw=False)


def test_decoder_reads_float32_and_ext_headers():
    data = msgpack.packb([1.25, -3.5e-3], use_single_float=True)
    assert data[1] == 0xca
    assert flax_msgpack._unpack(data) == msgpack.unpackb(data)
    exts = [msgpack.ExtType(5 + i % 3, bytes(range(256)) * (n // 256) + bytes(n % 256))
            for i, n in enumerate(EXT_SIZES)]
    data = msgpack.packb(exts)
    got = flax_msgpack._unpack(data, ext=lambda code, body: msgpack.ExtType(code, body))
    assert got == exts
    with pytest.raises(ValueError, match="extension type 5"):
        flax_msgpack.loads(msgpack.packb(msgpack.ExtType(5, b"x")))


def test_decoder_matches_flax_restore(monkeypatch):
    """Arrays of each dtype, a numpy scalar, a complex and a chunked array
    (flax's chunk size cut so that a small array is chunked)."""
    monkeypatch.setattr(serialization, "MAX_CHUNK_SIZE", 64)
    rng = np.random.default_rng(0)
    tree = {
        "f32": rng.standard_normal((3, 4)).astype(np.float32),
        "f64": rng.standard_normal(5),
        "f16": rng.standard_normal((2, 2)).astype(np.float16),
        "i32": np.arange(6, dtype=np.int32).reshape(2, 3), "u8": np.arange(4, dtype=np.uint8),
        "bool": np.array([True, False]), "empty": np.zeros((0, 3), np.float32),
        "scalar": np.float32(2.5), "count": np.int32(7), "z": 1 + 2j,
        "chunked": rng.standard_normal(100).astype(np.float32),
        "deep": {"a": {"b": np.ones((1, 1, 1), np.float32)}, "s": "text", "n": None},
        "bf16": jnp.asarray(rng.standard_normal(7), jnp.bfloat16),
    }
    data = serialization.to_bytes(tree)
    assert b"__msgpack_chunked_array__" in data
    ref = serialization.msgpack_restore(data)
    got = flax_msgpack.loads(data)
    assert got.keys() == ref.keys()
    bf16 = ref.pop("bf16")
    np.testing.assert_array_equal(got.pop("bf16"), np.asarray(bf16, np.float32))
    assert got["z"] == ref["z"] and isinstance(got["scalar"], np.float32)
    _assert_same_tree(got, ref)
    got["f32"][0, 0] = 1.0  # a writable copy


# --- the fixture ------------------------------------------------------------


def test_fixture_is_what_jax_wrote():
    """The committed state decodes to flax's restore leaf for leaf, has one
    Adam step, and JAX's UNet on it reproduces the committed output."""
    assert os.path.getsize(FIXTURE_CKPT) + os.path.getsize(FIXTURE_EVAL) < 200 * 1024
    with open(FIXTURE_CKPT, "rb") as f:
        data = f.read()
    raw = flax_msgpack.loads(data)
    _assert_same_tree(raw, serialization.msgpack_restore(data))
    assert int(raw["step"]) == int(raw["opt_state"]["0"]["count"]) == 1
    jm, template, _ = _jax_unet_state()
    state = jax_checkpoint.load_checkpoint(FIXTURE_CKPT, template)
    n = sum(a.size for a in jax.tree.leaves(state.params))
    assert n == 10374
    ev = np.load(FIXTURE_EVAL)
    y = jm.apply({"params": state.params, "batch_stats": state.batch_stats}, ev["x"],
                 train=False)
    np.testing.assert_allclose(np.asarray(y), ev["y"], atol=REPRODUCE_ATOL, rtol=0)


def test_port_serves_the_fixture():
    ev = np.load(FIXTURE_EVAL)
    denoiser = Denoiser.from_checkpoint("unet", FIXTURE_CKPT, max_batch=8, device="cpu")
    np.testing.assert_allclose(denoiser(ev["x"]), ev["y"], atol=SERVE_ATOL, rtol=0)
    model = load_model_weights(FIXTURE_CKPT, build_model("unet", device="cpu")).eval()
    with torch.no_grad():
        y = model(torch.from_numpy(ev["x"]))
    np.testing.assert_allclose(y.numpy(), ev["y"], atol=SERVE_ATOL, rtol=0)


def test_resumed_step_matches_jax():
    """The fixture resumed on both sides, then one Adam step (the second):
    loss 1e-5 relative, Adam's step 2 on both, and the gradients (JAX's
    from its moments: g = (mu_2 - 0.9 mu_1) / 0.1) and parameters at
    `chip_smoke.step_bars`."""
    import chip_smoke

    jm, template, tx = _jax_unet_state()
    jstate = jax_checkpoint.load_checkpoint(FIXTURE_CKPT, template)
    mu1 = jax.tree.map(np.asarray, jstate.opt_state[0].mu)
    j_train, _ = jax_epoch_fns(jm, tx, donate=False)
    state = load_checkpoint(FIXTURE_CKPT,
                            create_train_state(build_model("unet", device="cpu"), device="cpu"))
    assert state.step == 1
    mapped = unet_state_dict({"params": mu1})
    for name, p in state.model.named_parameters():
        torch.testing.assert_close(state.optimizer.state[p]["exp_avg"], mapped[name],
                                   atol=0, rtol=0, msg=name)
    p_train, _ = make_epoch_fns(state.model, state.optimizer)
    noisy, clean = _noisy_clean(BATCH, seed=17)
    jstate, ref = j_train(jstate, jnp.asarray(noisy), jnp.asarray(clean),
                          jax.random.PRNGKey(1), BATCH)
    got = p_train(torch.from_numpy(noisy), torch.from_numpy(clean),
                  torch.Generator().manual_seed(1), BATCH)
    np.testing.assert_allclose(got["loss"], float(ref["loss"]), rtol=LOSS_TOL)
    assert state.step == int(jstate.step) == 2
    mu2 = jax.tree.map(np.asarray, jstate.opt_state[0].mu)
    ref_grads = unet_state_dict({"params": jax.tree.map(lambda a, b: (a - 0.9 * b) / 0.1,
                                                        mu2, mu1)})
    ref_sd = unet_state_dict({"params": jstate.params, "batch_stats": jstate.batch_stats})
    params = dict(state.model.named_parameters())
    bars = chip_smoke.step_bars({k: p.grad for k, p in params.items()}, ref_grads,
                                {k: p.detach() for k, p in params.items()}, ref_sd)
    assert bars["ok"], chip_smoke.describe_bars(bars)


def test_port_serves_a_jax_ralenet_state(tmp_path):
    """A RA-LENet 'full' TrainState (about 13 MB) as JAX's save_checkpoint
    writes it, served by the port within 1e-4 of JAX's eval forward."""
    jm = JaxRaleNet(variant="full")
    v = random_variables(jm, jnp.zeros((2, 2, 256)), seed=18)
    state, _ = jax_train_state(jm, jax.random.PRNGKey(0), jnp.zeros((2, 2, 256)), variables=v)
    path = jax_checkpoint.save_checkpoint(
        jax_checkpoint.checkpoint_path(str(tmp_path), "ralenet", 10, "em", 0), state)
    assert find_model(str(tmp_path / "ralenet"), "ralenet") == path
    x = np.random.default_rng(19).standard_normal((3, 2, 256)).astype(np.float32)
    ref = jax.jit(lambda v, x: jm.apply(v, x, train=False))(v, x)
    denoiser = Denoiser.from_checkpoint("ralenet", path, max_batch=4, device="cpu")
    np.testing.assert_allclose(denoiser(x), np.asarray(ref), atol=SERVE_ATOL, rtol=0)


# The classifiers a JAX user trains (the cls CLIs): JAX's module and the
# port's with their arguments, and an input shape. Transformer1d at the
# small size of test_torch_port_transformer1d.py.
CLASSIFIERS = {
    "resnet_cls": (JaxResNetCls, ResNetCls, {}, (3, 2, 256), resnet_cls_state_dict),
    "transformer1d": (JaxTransformer1d, Transformer1d,
                      dict(num_class=9, in_channels=32, embed_dim=32, depths=(1, 1),
                           num_heads=(1, 2)), (2, 32, 64), transformer1d_state_dict),
}


@pytest.mark.parametrize("name", sorted(CLASSIFIERS))
def test_port_resumes_a_jax_classifier_state(tmp_path, name):
    jax_cls, port_cls, kw, shape, to_torch = CLASSIFIERS[name]
    jm = jax_cls(**kw)
    v = random_variables(jm, jnp.zeros(shape), seed=20)
    state, _ = jax_train_state(jm, jax.random.PRNGKey(0), jnp.zeros(shape), variables=v)
    rng = np.random.default_rng(21)

    def moments():
        return jax.tree.map(lambda a: jnp.asarray(
            np.abs(rng.standard_normal(a.shape)).astype(np.float32)), state.params)

    adam = state.opt_state[0]._replace(count=jnp.asarray(3, jnp.int32), mu=moments(),
                                       nu=moments())
    state = state.replace(opt_state=(adam, *state.opt_state[1:]),
                          step=jnp.asarray(3, jnp.int32))
    path = jax_checkpoint.save_checkpoint(
        jax_checkpoint.checkpoint_path(str(tmp_path), name, 3, "em", 0), state)
    port = load_checkpoint(path, create_train_state(port_cls(**kw), device="cpu"))
    assert port.step == 3
    ref_sd = to_torch({"params": state.params, "batch_stats": state.batch_stats})
    for key, val in port.model.state_dict().items():
        if not key.endswith("num_batches_tracked"):
            torch.testing.assert_close(val, ref_sd[key], atol=0, rtol=0, msg=key)
    mu, nu = to_torch({"params": adam.mu}), to_torch({"params": adam.nu})
    for key, p in port.model.named_parameters():
        st = port.optimizer.state[p]
        torch.testing.assert_close(st["exp_avg"], mu[key], atol=0, rtol=0, msg=key)
        torch.testing.assert_close(st["exp_avg_sq"], nu[key], atol=0, rtol=0, msg=key)
    x = np.random.default_rng(22).standard_normal(shape).astype(np.float32)
    ref = jax.jit(lambda v, x: jm.apply(v, x, train=False))(
        {"params": state.params, "batch_stats": state.batch_stats}, x)
    with torch.no_grad():
        y = port.model.eval()(torch.from_numpy(x))
    np.testing.assert_allclose(y.numpy(), np.asarray(ref), atol=SERVE_ATOL, rtol=0)


def test_find_model_picks_a_msgpack(tmp_path):
    for name in ("unet_10_em_intensity0.pth", "unet_20_em_intensity0.msgpack",
                 "unet_5_em_intensity0.msgpack", "ralenet_30_em_intensity0.pth"):
        (tmp_path / name).write_bytes(b"")
    assert find_model(str(tmp_path), "unet") == str(tmp_path / "unet_20_em_intensity0.msgpack")
    assert find_model(str(tmp_path), "unet", epoch=5) == str(
        tmp_path / "unet_5_em_intensity0.msgpack")
    assert find_model(str(tmp_path), "unet", epoch=10) == str(
        tmp_path / "unet_10_em_intensity0.pth")


def test_frozen_mask_state_is_not_resumed(tmp_path):
    """A state whose optax state is a frozen mask's multi_transform raises
    on resume and names the file; its weights still load, as JAX's
    load_variables reads them."""
    _, state, _ = _jax_unet_state(frozen=True)
    path = jax_checkpoint.save_checkpoint(str(tmp_path / "unet_1_em_intensity0.msgpack"), state)
    port = create_train_state(build_model("unet", device="cpu"), device="cpu")
    with pytest.raises(ValueError, match="unet_1_em_intensity0.msgpack"):
        load_checkpoint(path, port)
    assert port.step == 0
    model = load_model_weights(path, build_model("unet", device="cpu"))
    ref = unet_state_dict({"params": state.params, "batch_stats": state.batch_stats})
    for key, val in model.state_dict().items():
        if not key.endswith("num_batches_tracked"):
            torch.testing.assert_close(val, ref[key], atol=0, rtol=0, msg=key)
