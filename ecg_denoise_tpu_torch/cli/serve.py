"""Minimal HTTP denoising service (stdlib only; JAX counterpart: cli/serve.py).

POST /denoise with a raw .npy payload of shape (N, 2, 256) float32 returns
the denoised .npy, with the host timing breakdown in the X-Denoise-Timing
header. POST /denoise_record?stride=K takes one (2, T) record of any
length and overlap-add stitches it. GET /healthz returns the model, the
checkpoint and the inference path. Batches are padded to power-of-two
buckets (see ecg_denoise_tpu_torch.serving.Denoiser).

Example (the checkpoint is a torch.save'd state_dict of the port's model):
    python -m ecg_denoise_tpu_torch.cli.serve --model ralenet \
        --ckpt ralenet.pt &
    python - <<'PY'
    import io, urllib.request, numpy as np
    x = np.random.randn(5, 2, 256).astype(np.float32)
    buf = io.BytesIO(); np.save(buf, x)
    r = urllib.request.urlopen(
        urllib.request.Request('http://127.0.0.1:8787/denoise',
                               buf.getvalue()), timeout=120)
    print(np.load(io.BytesIO(r.read())).shape)
    PY

`--r_pos`, `--n_data` and `--use_pallas` of the JAX CLI come with later
slices.
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


def main(argv=None) -> None:
    p = argparse.ArgumentParser(description=__doc__,
                                formatter_class=argparse.RawDescriptionHelpFormatter)
    p.add_argument("--model", type=str, default="ralenet")
    p.add_argument("--ckpt", type=str, required=True)
    p.add_argument("--host", type=str, default="127.0.0.1")
    p.add_argument("--port", type=int, default=8787)
    p.add_argument("--max_batch", type=int, default=1024)
    p.add_argument("--warmup_max", type=int, default=0,
                   help="run batch buckets up to this size at start (0 = none)")
    args = p.parse_args(argv)

    from ecg_denoise_tpu_torch.serving import Denoiser

    denoiser = Denoiser.from_checkpoint(args.model, args.ckpt,
                                        max_batch=args.max_batch)
    if args.warmup_max:
        denoiser.warmup(limit=args.warmup_max)
    meta = {"model": args.model, "ckpt": args.ckpt,
            "inference_path": denoiser.inference_path}
    server = make_server(denoiser, meta, args.host, args.port)
    print(f"serving {args.model} on http://{args.host}:{server.server_address[1]}",
          flush=True)
    try:
        server.serve_forever()
    finally:
        server.server_close()


if __name__ == "__main__":
    main()
