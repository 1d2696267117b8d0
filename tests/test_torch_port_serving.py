"""The port's serving layer and HTTP server, on the CPU.

Bucketing, the zero-padded tail in the staging buffers, chunking beyond
max_batch, overlap-add records, checkpoint loading, the HTTP surface (on
port 0, in a thread) and the streaming denoiser. A Denoiser's output must
equal the model's own eval output on the same rows: float32 on one device,
so only batch composition differs (atol 1e-5). The port's
StreamingDenoiser and the JAX package's, over one numpy stand-in, run the
same numpy operations in the same order (atol 1e-6).
"""

import io
import json
import threading
import urllib.error
import urllib.request

import numpy as np
import pytest
import torch
torch.set_num_threads(1)  # six test workers share the host's cores: one intra-op thread each

from ecg_denoise_tpu_torch.cli.serve import make_server
from ecg_denoise_tpu_torch.models.ralenet import RaleNet
from ecg_denoise_tpu_torch.serving import Denoiser, StreamingDenoiser, _bucket

ATOL = 1e-5


@pytest.fixture(scope="module")
def model():
    torch.manual_seed(0)
    m = RaleNet(variant="full", depth=1)
    with torch.no_grad():
        for name, p in m.named_parameters():
            if "relative_position_bias_table" in name:
                p.normal_()
    return m.eval()


def _windows(n, seed=0):
    return np.random.default_rng(seed).standard_normal((n, 2, 256)).astype(np.float32)


def _direct(model, x):
    with torch.no_grad():
        return model(torch.from_numpy(x)).numpy()


def test_bucket_sizes():
    assert _bucket(1, 64) == 1
    assert _bucket(5, 64) == 8
    assert _bucket(64, 64) == 64
    assert _bucket(1000, 64) == 64  # capped at max_batch


def test_denoiser_pads_to_buckets_and_chunks(model):
    d = Denoiser(model, max_batch=16, device="cpu")
    assert d.inference_path == "torch+attn-plain:cpu"
    x = _windows(37)
    y, t = d.denoise_timed(x)  # 16 + 16 + 5 (in the 8-bucket)
    assert y.shape == x.shape and y.dtype == np.float32
    assert set(t) == {"pad_ms", "dispatch_ms", "fetch_ms"}
    np.testing.assert_allclose(y, _direct(model, x), atol=ATOL, rtol=0)
    np.testing.assert_allclose(d(x[0]), y[0], atol=ATOL, rtol=0)  # (C, L)


def test_staging_tail_is_zeroed(model):
    d = Denoiser(model, max_batch=16, device="cpu")
    x = _windows(7, seed=1)
    d(x)
    y = d(x[:5])  # reuses the 8-bucket staging buffer of the 7-row call
    np.testing.assert_array_equal(d._staging[8][5:].numpy(), 0.0)
    np.testing.assert_allclose(y, _direct(model, x[:5]), atol=ATOL, rtol=0)


def test_from_checkpoint_and_warmup(tmp_path, model):
    from ecg_denoise_tpu_torch.models import build_model

    torch.manual_seed(1)
    ref = build_model("ralenet_mlp", device="cpu").eval()
    path = tmp_path / "ralenet_mlp.pt"
    torch.save(ref.state_dict(), path)
    d = Denoiser.from_checkpoint("ralenet_mlp", str(path), max_batch=4,
                                 device="cpu")
    d.warmup(limit=3)
    assert set(d._staging) == set()  # warmup runs buckets 1, 2, 4 unstaged
    x = _windows(3, seed=2)
    np.testing.assert_allclose(d(x), _direct(ref, x), atol=ATOL, rtol=0)


class _Identity(torch.nn.Module):
    def forward(self, x):
        return x


@pytest.mark.parametrize("channels", [None, 5])
def test_warmup_takes_jax_signature(channels):
    """warmup(channels, length, limit), JAX's order: every bucket up to
    the limit's at `channels` (default: the served model's, 2 here)."""
    d = Denoiser(_Identity(), max_batch=4, device="cpu")
    seen = []
    d._fetch = lambda y: seen.append(tuple(y.shape))
    d.warmup(channels, 32, 3)
    want = 2 if channels is None else channels
    assert seen == [(1, want, 32), (2, want, 32), (4, want, 32)]


def test_denoise_record_identity_model_reproduces_record():
    d = Denoiser(_Identity(), max_batch=16, device="cpu")
    rec = np.random.default_rng(3).standard_normal((2, 1000)).astype(np.float32)
    np.testing.assert_allclose(d.denoise_record(rec, stride=100), rec, atol=1e-5)
    short = rec[:, :100]
    np.testing.assert_allclose(d.denoise_record(short), short, atol=1e-6)
    with pytest.raises(ValueError):
        d.denoise_record(rec, stride=0)


@pytest.fixture
def server(model):
    d = Denoiser(model, max_batch=16, device="cpu")
    meta = {"model": "ralenet", "ckpt": "none", "inference_path": d.inference_path}
    srv = make_server(d, meta, port=0)
    thread = threading.Thread(target=srv.serve_forever, daemon=True)
    thread.start()
    yield f"http://127.0.0.1:{srv.server_address[1]}", d
    srv.shutdown()
    srv.server_close()
    thread.join(timeout=10)
    assert not thread.is_alive()


def _post(url, x):
    buf = io.BytesIO()
    np.save(buf, x)
    with urllib.request.urlopen(urllib.request.Request(url, buf.getvalue()),
                                timeout=60) as r:
        return np.load(io.BytesIO(r.read())), r.headers


def test_http_server(server):
    url, d = server
    with urllib.request.urlopen(url + "/healthz", timeout=30) as r:
        meta = json.loads(r.read())
    assert meta["inference_path"] == "torch+attn-plain:cpu"
    assert meta["model"] == "ralenet"

    x = _windows(3, seed=4)
    y, headers = _post(url + "/denoise", x)
    np.testing.assert_array_equal(y, d(x))
    timing = json.loads(headers["X-Denoise-Timing"])
    assert {"decode_ms", "pad_ms", "dispatch_ms", "fetch_ms", "total_ms"} <= set(timing)

    rec = np.random.default_rng(5).standard_normal((2, 600)).astype(np.float32)
    y, _ = _post(url + "/denoise_record?stride=64", rec)
    np.testing.assert_array_equal(y, d.denoise_record(rec, stride=64))

    with pytest.raises(urllib.error.HTTPError) as e:
        urllib.request.urlopen(urllib.request.Request(url + "/denoise", b"junk"),
                               timeout=30)
    assert e.value.code == 400
    with pytest.raises(urllib.error.HTTPError) as e:
        urllib.request.urlopen(url + "/nope", timeout=30)
    assert e.value.code == 404


def test_denoiser_with_detected_r_peaks(model):
    """`r_pos="detect"` equals the model fed the detector's positions of
    the same rows; the zero-padded rows of a bucket do not touch them."""
    from ecg_denoise_tpu_torch.data.rpeaks import detect_r_peaks

    d = Denoiser(model, max_batch=8, r_pos="detect", device="cpu")
    assert d.inference_path == "torch+attn-plain+rpos:cpu"
    x = _windows(11, seed=6)  # 8, then 3 in the 4-bucket
    xt = torch.from_numpy(x)
    with torch.no_grad():
        ref = model(xt, r_pos=detect_r_peaks(xt)).numpy()
    np.testing.assert_allclose(d(x), ref, atol=ATOL, rtol=0)
    assert np.abs(ref - _direct(model, x)).max() > 100 * ATOL
    with pytest.raises(ValueError, match="r_pos"):
        Denoiser(model, r_pos="centre", device="cpu")


@pytest.mark.parametrize("name,r_pos", [("ralenet", "detect"), ("ralenet_nra", None)])
def test_serve_cli_builds_with_r_pos_detect(monkeypatch, tmp_path, capsys, name, r_pos):
    """`cli.serve --r_pos detect` serves detected positions; a model without
    the rel-pos tables ignores the flag, saying so, as the JAX CLI does."""
    import ecg_denoise_tpu_torch
    from ecg_denoise_tpu_torch.cli.serve import build
    from ecg_denoise_tpu_torch.models import build_model

    monkeypatch.setattr(ecg_denoise_tpu_torch, "default_device",
                        lambda: torch.device("cpu"))
    torch.manual_seed(3)
    path = tmp_path / f"{name}.pt"
    torch.save(build_model(name, device="cpu").state_dict(), path)
    server, d = build(["--model", name, "--ckpt", str(path), "--port", "0",
                       "--max_batch", "4", "--r_pos", "detect"])
    thread = threading.Thread(target=server.serve_forever, daemon=True)
    thread.start()
    try:
        assert d.r_pos == r_pos and d.device.type == "cpu"
        assert ("ignored for ralenet_nra" in capsys.readouterr().out) == (r_pos is None)
        x = _windows(3, seed=7)
        y, _ = _post(f"http://127.0.0.1:{server.server_address[1]}/denoise", x)
        np.testing.assert_array_equal(y, d(x))
    finally:
        server.shutdown()
        server.server_close()
    thread.join(timeout=10)
    assert not thread.is_alive()


class _LinearStandIn:
    """A numpy stand-in for a Denoiser: a fixed linear map of each window's
    256 samples, and the port's `denoise_record` over it (the streaming
    denoisers call it for streams shorter than a window; the JAX one passes
    `length`)."""

    def __init__(self, seed=0):
        rng = np.random.default_rng(seed)
        self.map = (np.eye(256) + 0.05 * rng.standard_normal((256, 256))).astype(np.float32)

    def __call__(self, windows):
        return windows @ self.map

    def denoise_record(self, signal, stride=128, length=256):
        assert length == 256
        return Denoiser.denoise_record(self, signal, stride=stride)


@pytest.mark.parametrize("t", [1000, 777, 512, 300, 100])
@pytest.mark.parametrize("stride", [128, 96, 256])
def test_streaming_matches_jax_streaming(t, stride):
    """Push by push, the port's StreamingDenoiser emits what the JAX
    package's emits, over the same stand-in, record and seeded chunk sizes;
    together the pieces are the stand-in's denoise_record."""
    from ecg_denoise_tpu.serving import StreamingDenoiser as JaxStreamingDenoiser

    stand_in = _LinearStandIn()
    rng = np.random.default_rng(t + stride)
    record = rng.standard_normal((2, t)).astype(np.float32)
    port = StreamingDenoiser(stand_in, stride=stride)
    ref = JaxStreamingDenoiser(stand_in, stride=stride, length=256)
    pieces, i = [], 0
    while i < t:
        n = int(rng.integers(1, 300))
        got, want = port.push(record[:, i:i + n]), ref.push(record[:, i:i + n])
        assert got.shape == want.shape
        np.testing.assert_allclose(got, want, atol=1e-6, rtol=0)
        pieces.append(got)
        i += n
    got, want = port.flush(), ref.flush()
    np.testing.assert_allclose(got, want, atol=1e-6, rtol=0)
    out = np.concatenate(pieces + [got], axis=1)
    assert out.shape == record.shape
    np.testing.assert_allclose(out, stand_in.denoise_record(record, stride=stride),
                               atol=1e-5, rtol=0)


def test_streaming_push_and_flush_equal_denoise_record(model):
    d = Denoiser(model, max_batch=16, device="cpu")
    rec = np.random.default_rng(8).standard_normal((2, 700)).astype(np.float32)
    stream = d.streaming(stride=128)
    pieces = [stream.push(rec[:, i:i + 150]) for i in range(0, 700, 150)]
    out = np.concatenate(pieces + [stream.flush()], axis=1)
    np.testing.assert_allclose(out, d.denoise_record(rec, stride=128), atol=ATOL, rtol=0)


def test_streaming_errors():
    d = Denoiser(_Identity(), device="cpu")
    for stride in (0, 257):
        with pytest.raises(ValueError, match="stride"):
            d.streaming(stride=stride)
    with pytest.raises(ValueError, match="push wants"):
        d.streaming().push(np.zeros(5, np.float32))
    assert d.streaming().flush().shape == (0, 0)  # an empty stream
    stream = d.streaming()
    stream.push(np.zeros((2, 10), np.float32))
    stream.flush()
    with pytest.raises(RuntimeError, match="flushed"):
        stream.push(np.zeros((2, 10), np.float32))
    with pytest.raises(RuntimeError, match="flushed"):
        stream.flush()
