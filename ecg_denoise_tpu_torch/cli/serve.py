"""Minimal HTTP denoising service (stdlib only; JAX counterpart: cli/serve.py).

POST /denoise with a raw .npy payload of shape (N, C, 256) float32 returns
the denoised .npy, with the host timing breakdown in the X-Denoise-Timing
header; C is 2, or 12 for `--model newrale` (the 12-lead transfer model).
POST /denoise_record?stride=K takes one (C, T) record of any length and
overlap-add stitches it. GET /healthz returns the model, the checkpoint
and the inference path. Batches are padded to power-of-two buckets (see
ecg_denoise_tpu_torch.serving.Denoiser). `--model` takes any name of
`models.build_model`: unet, DANet, ralenet_nra, ralenet_mlp, ralenet,
ACDAE, newrale.

Example (the checkpoint is a torch.save'd state_dict of the port's model,
a checkpoint written by `python -m ecg_denoise_tpu_torch.cli.main`, or one
the JAX package wrote, `<name>_<epoch>_<noise>_intensity<k>.msgpack`;
`--r_pos detect` centres each window's R-wave attention bias on its own
detected R peak):
    python -m ecg_denoise_tpu_torch.cli.serve --model ralenet \
        --ckpt ralenet.pt --r_pos detect &
    python - <<'PY'
    import io, urllib.request, numpy as np
    x = np.random.randn(5, 2, 256).astype(np.float32)
    buf = io.BytesIO(); np.save(buf, x)
    r = urllib.request.urlopen(
        urllib.request.Request('http://127.0.0.1:8787/denoise',
                               buf.getvalue()), timeout=120)
    print(np.load(io.BytesIO(r.read())).shape)
    PY

`--n_data k` serves on k cards, one replica each (a power of two; buckets
round up from k, `Denoiser`'s `n_data`). `--use_pallas` has no
counterpart, since the kernels always run on the card.
"""

from __future__ import annotations

import argparse
import io
import json
import time
from http.server import BaseHTTPRequestHandler, ThreadingHTTPServer
from urllib.parse import parse_qs, urlparse

import numpy as np

_HEADER_READERS = {(1, 0): np.lib.format.read_array_header_1_0,
                   (2, 0): np.lib.format.read_array_header_2_0}


def _decode_npy(raw: bytearray) -> np.ndarray:
    """Zero-copy .npy decode: parse the header in place and view the data."""
    buf = io.BytesIO(raw)
    version = np.lib.format.read_magic(buf)
    if version not in _HEADER_READERS:
        raise ValueError(f"unsupported .npy format version {version}")
    shape, fortran, dtype = _HEADER_READERS[version](buf)
    if fortran:
        raise ValueError("fortran-order payloads not supported")
    return np.frombuffer(memoryview(raw)[buf.tell():], dtype=dtype).reshape(shape)


def make_server(denoiser, meta: dict, host: str = "127.0.0.1",
                port: int = 8787) -> ThreadingHTTPServer:
    """An HTTP server for `denoiser` (not started; port 0 picks a free
    port, see `server.server_address`). The caller runs `serve_forever`
    and, when done, `shutdown` and `server_close`."""

    class Handler(BaseHTTPRequestHandler):
        # Keep-alive: a warm client reuses its TCP connection.
        protocol_version = "HTTP/1.1"

        def log_message(self, *a):  # quiet
            pass

        def do_GET(self):
            if self.path != "/healthz":
                self.send_error(404)
                return
            body = json.dumps(meta).encode()
            self.send_response(200)
            self.send_header("Content-Type", "application/json")
            self.send_header("Content-Length", str(len(body)))
            self.end_headers()
            self.wfile.write(body)

        def do_POST(self):
            url = urlparse(self.path)
            if url.path not in ("/denoise", "/denoise_record"):
                self.send_error(404)
                return
            try:
                t0 = time.perf_counter()
                stride = int(parse_qs(url.query).get("stride", ["128"])[0])
                n = int(self.headers.get("Content-Length", 0))
                raw = bytearray(n)
                view = memoryview(raw)
                got = 0
                while got < n:
                    r = self.rfile.readinto(view[got:])
                    if not r:
                        break
                    got += r
                x = _decode_npy(raw)
                t1 = time.perf_counter()
                if url.path == "/denoise_record":
                    y, seg = denoiser.denoise_record(x, stride=stride), {}
                else:
                    y, seg = denoiser.denoise_timed(x)
                t2 = time.perf_counter()
                y = np.ascontiguousarray(y)
                hdr = io.BytesIO()
                np.lib.format.write_array_header_2_0(
                    hdr, np.lib.format.header_data_from_array_1_0(y))
                header_bytes = hdr.getvalue()
                timing = {"decode_ms": round((t1 - t0) * 1e3, 3), **seg,
                          "total_ms": round((t2 - t0) * 1e3, 3)}
                self.send_response(200)
                self.send_header("Content-Type", "application/octet-stream")
                self.send_header("Content-Length",
                                 str(len(header_bytes) + y.nbytes))
                self.send_header("X-Denoise-Timing", json.dumps(timing))
                self.end_headers()
                self.wfile.write(header_bytes)
                self.wfile.write(memoryview(y).cast("B"))
            except Exception as e:  # noqa: BLE001 — reported to the client
                msg = f"{type(e).__name__}: {e}".encode()
                self.send_response(400)
                self.send_header("Content-Length", str(len(msg)))
                self.end_headers()
                self.wfile.write(msg)

    return ThreadingHTTPServer((host, port), Handler)


def build(argv=None):
    """Parse the CLI's flags and build its server (not started) and
    Denoiser: (server, denoiser)."""
    from ecg_denoise_tpu_torch.utils.compile_cache import enable_compilation_cache

    enable_compilation_cache()
    p = argparse.ArgumentParser(description=__doc__,
                                formatter_class=argparse.RawDescriptionHelpFormatter)
    p.add_argument("--model", type=str, default="ralenet")
    p.add_argument("--ckpt", type=str, required=True,
                   help="a .pth of the port or a .msgpack of the JAX package")
    p.add_argument("--host", type=str, default="127.0.0.1")
    p.add_argument("--port", type=int, default=8787)
    p.add_argument("--max_batch", type=int, default=1024)
    p.add_argument("--warmup_max", type=int, default=0,
                   help="run batch buckets up to this size at start (0 = none)")
    p.add_argument("--r_pos", type=str, default=None, choices=["detect"],
                   help="per-window R-peak-centred attention biases "
                        "(RaleNet-family checkpoints with the rel-pos "
                        "tables, i.e. ralenet/ralenet_mlp)")
    p.add_argument("--n_data", type=int, default=0,
                   help="data-parallel serving: one replica on each of this many "
                        "cards (a power of two; batches split across them)")
    args = p.parse_args(argv)

    from ecg_denoise_tpu_torch.serving import Denoiser

    r_pos = args.r_pos
    if r_pos and args.model not in ("ralenet", "ralenet_mlp"):
        print(f"--r_pos needs a rel-pos-bias model; ignored for {args.model}")
        r_pos = None
    denoiser = Denoiser.from_checkpoint(args.model, args.ckpt,
                                        max_batch=args.max_batch, r_pos=r_pos,
                                        n_data=max(args.n_data, 1))
    if args.warmup_max:
        denoiser.warmup(limit=args.warmup_max)
    meta = {"model": args.model, "ckpt": args.ckpt,
            "inference_path": denoiser.inference_path}
    return make_server(denoiser, meta, args.host, args.port), denoiser


def main(argv=None) -> None:
    server, _ = build(argv)
    host, port = server.server_address[:2]
    print(f"serving on http://{host}:{port}", flush=True)
    try:
        server.serve_forever()
    finally:
        server.server_close()


if __name__ == "__main__":
    main()
