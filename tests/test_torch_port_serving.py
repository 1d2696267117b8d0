"""The port's serving layer and HTTP server, on the CPU.

Bucketing, the zero-padded tail in the staging buffers, chunking beyond
max_batch, overlap-add records, checkpoint loading and the HTTP surface
(on port 0, in a thread). A Denoiser's output must equal the model's own
eval output on the same rows: float32 on one device, so only batch
composition differs (atol 1e-5).
"""

import io
import json
import threading
import urllib.error
import urllib.request

import numpy as np
import pytest
import torch

from ecg_denoise_tpu_torch.cli.serve import make_server
from ecg_denoise_tpu_torch.models.ralenet import RaleNet
from ecg_denoise_tpu_torch.serving import Denoiser, _bucket

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
