"""Inference/serving layer (JAX counterpart: serving.py `Denoiser`).

* `Denoiser.from_checkpoint` loads a `torch.save`d state_dict of the
  port's model, or the "model" part of a training checkpoint
  (`train/checkpoint.py`), the counterpart of the JAX package's
  `load_variables`, and serves it in eval mode.
* Requests are padded to power-of-two batch buckets up to `max_batch`, so
  the card sees a handful of batch shapes whatever the request sizes; the
  zero-padded tail lives in persistent per-bucket staging buffers (pinned
  host memory on the card), and longer requests run in max_batch chunks.
* Input and output are numpy (host) arrays: one host-to-device and one
  device-to-host copy per chunk, and each chunk's fetch ends in a
  `torch.cuda.synchronize`.
* `r_pos="detect"` centres each window's R-wave attention bias on its own
  detected R peak (the paper's namesake mechanism): `detect_r_peaks` runs
  on the staged bucket on the model's device, inside the same
  `inference_mode` forward.

Data-parallel serving and `StreamingDenoiser` come with later slices.
"""

from __future__ import annotations

import threading
import time
from typing import Optional

import numpy as np
import torch

from ecg_denoise_tpu_torch import full_float32, resolve_device
from ecg_denoise_tpu_torch.data.rpeaks import detect_r_peaks
from ecg_denoise_tpu_torch.models import build_model

WINDOW = 256  # samples per window: RA-LENet's fixed input length


def _bucket(n: int, max_batch: int, floor: int = 1) -> int:
    b = floor
    while b < n and b < max_batch:
        b *= 2
    return b


class Denoiser:
    """A servable denoiser: numpy (N, C, L) in -> denoised numpy out.

    `device` defaults to the card (and raises without one); the model is
    moved there and put in eval mode. On the card, float32 runs in full
    float32 (`full_float32`). `r_pos="detect"` feeds each window's detected
    R-peak position to the model (RaleNet's `r_pos`).
    """

    def __init__(self, model: torch.nn.Module, max_batch: int = 1024,
                 r_pos: Optional[str] = None, device=None):
        if r_pos not in (None, "detect"):
            raise ValueError(f"r_pos must be None or 'detect', got {r_pos!r}")
        self.r_pos = r_pos
        self.device = resolve_device(device)
        if self.device.type == "cuda":
            full_float32()
        self.model = model.to(self.device).eval()
        self.max_batch = max_batch
        self._staging = {}  # per-bucket persistent padding buffers
        # Shared staging buffers on one card: serialise calls (the HTTP
        # front end is threaded).
        self._lock = threading.Lock()
        attn = "cuda" if self.device.type == "cuda" else "plain"
        rpos = "+rpos" if r_pos else ""
        self.inference_path = f"torch+attn-{attn}{rpos}:{self.device.type}"

    @classmethod
    def from_checkpoint(cls, name_or_index, ckpt_path: str,
                        max_batch: int = 1024,
                        dtype: torch.dtype = torch.float32,
                        r_pos: Optional[str] = None, device=None):
        """Serve a `torch.save(model.state_dict())` file of the port's
        model `name_or_index`, or a training checkpoint's "model" part."""
        device = resolve_device(device)
        model = build_model(name_or_index, dtype=dtype, device=device)
        state = torch.load(ckpt_path, map_location=device, weights_only=True)
        model.load_state_dict(state.get("model", state))
        return cls(model, max_batch, r_pos=r_pos, device=device)

    def __call__(self, x: np.ndarray) -> np.ndarray:
        return self.denoise_timed(x)[0]

    def denoise_timed(self, x: np.ndarray):
        """Denoise + per-segment host timing breakdown (ms).

        Segments: pad (bucket copy), dispatch (host-to-device copy and the
        forward's launches — returns once the work is enqueued), fetch
        (device-to-host copy, which waits for the forward, then a
        synchronize).
        """
        x = np.ascontiguousarray(x, np.float32)
        squeeze = x.ndim == 2
        if squeeze:
            x = x[None]
        out = np.empty_like(x)
        t = {"pad_ms": 0.0, "dispatch_ms": 0.0, "fetch_ms": 0.0}
        with self._lock:
            self._denoise_into(x, out, t)
        t = {k: round(v, 3) for k, v in t.items()}
        return (out[0] if squeeze else out), t

    def _staged(self, chunk: np.ndarray, b: int) -> torch.Tensor:
        """`chunk` zero-padded to `b` rows in the bucket's staging buffer."""
        m = chunk.shape[0]
        padded = self._staging.get(b)
        if padded is None or padded.shape[1:] != chunk.shape[1:]:
            padded = torch.zeros((b, *chunk.shape[1:]),
                                 pin_memory=self.device.type == "cuda")
            self._staging[b] = padded
        else:
            # Only the tail may hold rows of a larger earlier request.
            padded[m:] = 0.0
        padded[:m] = torch.from_numpy(chunk)
        return padded

    def _forward(self, batch: torch.Tensor) -> torch.Tensor:
        with torch.inference_mode():
            x = batch.to(self.device, non_blocking=True)
            if self.r_pos == "detect":
                return self.model(x, r_pos=detect_r_peaks(x))
            return self.model(x)

    def _fetch(self, y: torch.Tensor) -> np.ndarray:
        y = y.float().cpu()
        if self.device.type == "cuda":
            torch.cuda.synchronize(self.device)
        return y.numpy()

    def _denoise_into(self, x, out, t) -> None:
        n = x.shape[0]
        i = 0
        while i < n:
            chunk = x[i:i + self.max_batch]
            m = chunk.shape[0]
            b = _bucket(m, self.max_batch)
            t0 = time.perf_counter()
            # A full bucket needs no copy; the staging buffer is reused
            # only after the previous chunk's fetch has synchronised.
            padded = torch.from_numpy(chunk) if m == b else self._staged(chunk, b)
            t1 = time.perf_counter()
            y = self._forward(padded)
            t2 = time.perf_counter()
            np.copyto(out[i:i + m], self._fetch(y[:m]))
            t3 = time.perf_counter()
            t["pad_ms"] += (t1 - t0) * 1e3
            t["dispatch_ms"] += (t2 - t1) * 1e3
            t["fetch_ms"] += (t3 - t2) * 1e3
            i += m

    def denoise_record(self, signal: np.ndarray, stride: int = 128) -> np.ndarray:
        """Denoise an arbitrary-length (C, T) record by overlap-add.

        Slides a WINDOW-sample window every `stride` samples (plus a final
        window at T - WINDOW so the tail is covered), denoises all windows
        in one batched call, and blends the overlaps with a Hann taper
        normalised by the accumulated weight. Positions only one window
        covers reproduce that window's output exactly. Records shorter
        than a window are reflect-padded, denoised as one window and
        cropped. Returns the input's shape.
        """
        sig = np.asarray(signal, np.float32)
        if sig.ndim != 2:
            raise ValueError(f"denoise_record wants (C, T), got {sig.shape}")
        c, t = sig.shape
        if t < WINDOW:
            pad = WINDOW - t
            padded = np.pad(sig, ((0, 0), (0, pad)),
                            mode="reflect" if t > 1 else "edge")
            return self(padded[None])[0][:, :t]
        if stride < 1 or stride > WINDOW:
            raise ValueError(f"stride must be in 1..{WINDOW}, got {stride}")
        starts = list(range(0, t - WINDOW + 1, stride))
        if starts[-1] != t - WINDOW:
            starts.append(t - WINDOW)
        denoised = self(np.stack([sig[:, s:s + WINDOW] for s in starts]))
        w = (np.hanning(WINDOW) + 1e-6).astype(np.float32)
        num = np.zeros((c, t), np.float32)
        den = np.zeros((t,), np.float32)
        for s, y in zip(starts, denoised):
            num[:, s:s + WINDOW] += w * y
            den[s:s + WINDOW] += w
        return num / den

    def warmup(self, limit: Optional[int] = None) -> None:
        """Run every batch bucket up to `limit` (default: max_batch) once,
        so the first real request of each size finds the kernels built and
        the allocator's pools sized. `limit` rounds up to its bucket."""
        limit = min(_bucket(limit or self.max_batch, self.max_batch),
                    self.max_batch)
        b = 1
        while b <= limit:
            x = torch.zeros(b, self.model.in_channels, WINDOW)
            self._fetch(self._forward(x))
            b *= 2
