"""Inference/serving layer (JAX counterpart: serving.py `Denoiser`).

* `Denoiser.from_checkpoint` loads a `torch.save`d state_dict of the
  port's model, the "model" part of a training checkpoint, or the weights
  of a JAX `.msgpack` checkpoint (`train/checkpoint.py`'s
  `load_model_weights`, the counterpart of the JAX package's
  `load_variables`), and serves it in eval mode.
* Requests are padded to power-of-two batch buckets up to `max_batch`, so
  the card sees a handful of batch shapes whatever the request sizes; the
  zero-padded tail lives in persistent per-bucket staging buffers (pinned
  host memory on the card), and longer requests run in max_batch chunks.
* Input and output are numpy (host) arrays: one host-to-device and one
  device-to-host copy per chunk, and each chunk's fetch ends in a
  `torch.cuda.synchronize`.
* Any denoiser of `models.build_model` serves: the 2-lead families take
  (N, 2, L) and `newrale` (N, 12, L), its `in_channels`. L is 256 unless
  the caller passes another `length` to `denoise_record`, `streaming` and
  `warmup`; the conv families take any multiple of 16, and a length a
  model cannot take raises (RA-LENet's rel-pos biases are built for 256).
* `r_pos="detect"` centres each window's R-wave attention bias on its own
  detected R peak (the paper's namesake mechanism): `detect_r_peaks` runs
  on the staged bucket on the model's device, inside the same
  `inference_mode` forward.
* `StreamingDenoiser` (`Denoiser.streaming`) denoises a live sample stream
  with `denoise_record`'s windows and taper, emitting each sample once it
  is final.
* `n_data` > 1 serves data parallel, the counterpart of the JAX
  Denoiser's `mesh`: one replica of the model on each of `n_data` devices
  (cuda:0 to cuda:n-1 by default); a bucket splits into contiguous equal
  slices, one a replica, and the outputs are gathered in order on the
  first device, then fetched as one. Buckets round up from `n_data` (a
  power of two, so each divides), and `inference_path` gains `+dp{n}`, as
  JAX's does.
"""

from __future__ import annotations

import copy
import threading
import time
from collections.abc import Sequence
from typing import Optional

import numpy as np
import torch

from ecg_denoise_tpu_torch import full_float32, resolve_device
from ecg_denoise_tpu_torch.data.rpeaks import detect_r_peaks
from ecg_denoise_tpu_torch.models import apply, build_model
from ecg_denoise_tpu_torch.ops.attention import MSAttention

WINDOW = 256  # samples per window by default: RA-LENet's fixed input length


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
    R-peak position to the model (RaleNet's `r_pos`). `channels`, the
    served window's channel count, is the model's `in_channels` (12 for
    newrale; 2 for a module that names none, as in JAX's Denoiser).

    `n_data` replicas (a power of two) serve each bucket's contiguous
    slices on `devices` (default: cuda:0 to cuda:n_data-1, or the CPU
    n_data times where `device` is the CPU; `device` is then the first of
    them). Each replica is a copy of `model`, which serves on the first.
    """

    def __init__(self, model: torch.nn.Module, max_batch: int = 1024,
                 r_pos: Optional[str] = None, device=None, n_data: int = 1,
                 devices: Optional[Sequence] = None):
        if r_pos not in (None, "detect"):
            raise ValueError(f"r_pos must be None or 'detect', got {r_pos!r}")
        if n_data < 1 or n_data & (n_data - 1):
            raise ValueError(f"mesh 'data' size {n_data} must be a power of two "
                             "(bucket divisibility)")
        if n_data > 1 and devices is None:
            on = resolve_device(device).type  # the card, or raise; the CPU if asked
            devices = [f"cuda:{i}" if on == "cuda" else on for i in range(n_data)]
        if devices is not None:
            if len(devices) != n_data:
                raise ValueError(f"{len(devices)} devices for {n_data} replicas")
            device = devices[0]
        self.r_pos = r_pos
        self.device = resolve_device(device)
        if self.device.type == "cuda":
            full_float32()
        self.model = model.to(self.device).eval()
        # (model, device) of each replica: `model` itself on the first.
        self.replicas = [(self.model, self.device)] + [
            (copy.deepcopy(self.model).to(d), d)
            for d in (torch.device(d) for d in (devices or [])[1:])]
        self.channels = getattr(model, "in_channels", 2)
        self.n_data = n_data
        # Buckets round up from n_data, so every bucket splits evenly.
        self.max_batch = max(max_batch, n_data)
        self._staging = {}  # per-bucket persistent padding buffers
        # Shared staging buffers on one card: serialise calls (the HTTP
        # front end is threaded).
        self._lock = threading.Lock()
        # The attention's route, for the models that have one.
        attn = ("" if not any(isinstance(m, MSAttention) for m in model.modules())
                else "+attn-cuda" if self.device.type == "cuda" else "+attn-plain")
        rpos = "+rpos" if r_pos else ""
        dp = f"+dp{n_data}" if n_data > 1 else ""
        self.inference_path = f"torch{attn}{rpos}{dp}:{self.device.type}"

    @classmethod
    def from_checkpoint(cls, name_or_index, ckpt_path: str,
                        max_batch: int = 1024,
                        dtype: torch.dtype = torch.float32,
                        r_pos: Optional[str] = None, device=None, n_data: int = 1,
                        devices: Optional[Sequence] = None):
        """Serve a `torch.save(model.state_dict())` file of the port's
        model `name_or_index`, a training checkpoint's "model" part, or the
        weights of a JAX `.msgpack` checkpoint (`load_model_weights`)."""
        from ecg_denoise_tpu_torch.train.checkpoint import load_model_weights

        device = resolve_device(devices[0] if devices else device)
        model = build_model(name_or_index, dtype=dtype, device=device)
        load_model_weights(ckpt_path, model)
        return cls(model, max_batch, r_pos=r_pos, device=device, n_data=n_data,
                   devices=devices)

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
        """The model's output for `batch`; with replicas, each runs its
        contiguous slice on its device (all enqueued before any output is
        waited for), and the outputs are gathered in order on the first."""
        outs = []
        with torch.inference_mode():
            for (model, device), rows in zip(self.replicas, batch.chunk(self.n_data)):
                x = rows.to(device, non_blocking=True)
                outs.append(apply(model, x,
                                  detect_r_peaks(x) if self.r_pos == "detect" else None))
            if len(outs) == 1:
                return outs[0]
            return torch.cat([y.to(self.device, non_blocking=True) for y in outs])

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
            b = _bucket(m, self.max_batch, self.n_data)
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

    def denoise_record(self, signal: np.ndarray, stride: int = 128,
                       length: int = WINDOW) -> np.ndarray:
        """Denoise an arbitrary-length (C, T) record by overlap-add.

        Slides a `length`-sample window every `stride` samples (plus a
        final window at T - length so the tail is covered), denoises all windows
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
        if t < length:
            pad = length - t
            padded = np.pad(sig, ((0, 0), (0, pad)),
                            mode="reflect" if t > 1 else "edge")
            return self(padded[None])[0][:, :t]
        if stride < 1 or stride > length:
            raise ValueError(f"stride must be in 1..{length}, got {stride}")
        starts = list(range(0, t - length + 1, stride))
        if starts[-1] != t - length:
            starts.append(t - length)
        denoised = self(np.stack([sig[:, s:s + length] for s in starts]))
        w = (np.hanning(length) + 1e-6).astype(np.float32)
        num = np.zeros((c, t), np.float32)
        den = np.zeros((t,), np.float32)
        for s, y in zip(starts, denoised):
            num[:, s:s + length] += w * y
            den[s:s + length] += w
        return num / den

    def streaming(self, stride: int = 128, length: int = WINDOW) -> "StreamingDenoiser":
        """A stateful online denoiser over this Denoiser (live monitors)."""
        return StreamingDenoiser(self, stride=stride, length=length)

    def warmup(self, channels: Optional[int] = None, length: int = WINDOW,
               limit: Optional[int] = None) -> None:
        """Run every batch bucket up to `limit` (default: max_batch) once
        at `channels` (default: the served model's, 12 for NewRale) and
        `length`, so the first real request of each size finds the kernels
        built and the allocator's pools sized. `limit` rounds up to its
        bucket. JAX's signature (serving.py `warmup`); an explicit
        `channels=0` is honoured, as JAX honours it."""
        channels = self.channels if channels is None else channels
        limit = min(_bucket(limit or self.max_batch, self.max_batch, self.n_data),
                    self.max_batch)
        b = self.n_data
        while b <= limit:
            self._fetch(self._forward(torch.zeros(b, channels, length)))
            b *= 2


class StreamingDenoiser:
    """Online (live-feed) denoising with bounded latency (JAX counterpart:
    serving.py `StreamingDenoiser`).

    `push` takes any number of new samples and returns the samples whose
    denoising is final — every window that can cover them has been
    accumulated — so output never changes afterwards. Latency is at most
    one window (`length` samples); in steady state length - stride plus
    the wait for the next window start.

    The window placement and Hann-taper overlap-add are `denoise_record`'s:
    a whole record fed through push() and flush(), in chunks of any size,
    gives `denoise_record(record, stride)` (the same window starts,
    including the off-grid tail window, and the same weights), up to how
    the windows fall into batches.
    """

    def __init__(self, denoiser: Denoiser, stride: int = 128, length: int = WINDOW):
        if stride < 1 or stride > length:
            raise ValueError(f"stride must be in 1..{length}, got {stride}")
        self.denoiser = denoiser
        self.stride = stride
        self.length = length
        self._w = (np.hanning(length) + 1e-6).astype(np.float32)
        self._buf = None      # (C, n) inputs from self._anchor onward
        self._num = None      # weighted-output accumulator, same span
        self._den = None
        self._anchor = 0      # absolute sample index of _buf[:, 0]
        self._next_start = 0  # absolute start of the next grid window
        self._emitted = 0     # absolute index of the first unemitted sample
        self._total = 0       # samples received
        self._flushed = False

    def push(self, samples: np.ndarray) -> np.ndarray:
        """Feed (C, k) new samples; return the (C, m) samples made final
        (m is 0 while the first window fills)."""
        if self._flushed:
            raise RuntimeError("stream already flushed")
        x = np.asarray(samples, np.float32)
        if x.ndim != 2:
            raise ValueError(f"push wants (C, k), got {x.shape}")
        if self._buf is None:
            self._buf = np.zeros((x.shape[0], 0), np.float32)
            self._num = np.zeros((x.shape[0], 0), np.float32)
            self._den = np.zeros((0,), np.float32)
        self._buf = np.concatenate([self._buf, x], axis=1)
        self._num = np.concatenate([self._num, np.zeros_like(x)], axis=1)
        self._den = np.concatenate([self._den, np.zeros((x.shape[1],), np.float32)])
        self._total += x.shape[1]

        starts = []
        while self._next_start + self.length <= self._total:
            starts.append(self._next_start)
            self._next_start += self.stride
        if not starts:
            return self._buf[:, :0]
        self._accumulate(starts)
        # Samples before the last start are final: every later window
        # begins at or after it. Emit before re-anchoring, which drops them.
        out = self._emit(starts[-1])
        self._anchor_to(starts[-1])
        return out

    def flush(self) -> np.ndarray:
        """End of stream: add the tail window (denoise_record's last start
        at T - length, if off the stride grid) and return every remaining
        sample. A stream shorter than a window is denoised as
        denoise_record denoises a short record (reflect-padded)."""
        if self._flushed:
            raise RuntimeError("stream already flushed")
        self._flushed = True
        if self._buf is None or self._total == 0:
            return np.zeros((0, 0), np.float32)
        t = self._total
        if t < self.length:
            return self.denoiser.denoise_record(self._buf, stride=self.stride,
                                                length=self.length)
        last_grid = self._next_start - self.stride
        if t - self.length > last_grid or last_grid < 0:
            self._accumulate([t - self.length])
        return self._emit(t)

    def _accumulate(self, starts) -> None:
        a = self._anchor
        n = self.length
        outs = self.denoiser(np.stack([self._buf[:, s - a:s - a + n] for s in starts]))
        for s, y in zip(starts, outs):
            self._num[:, s - a:s - a + n] += self._w * y
            self._den[s - a:s - a + n] += self._w

    def _anchor_to(self, new_anchor: int) -> None:
        # Everything below the new anchor is emitted already.
        drop = new_anchor - self._anchor
        if drop > 0:
            self._buf = self._buf[:, drop:]
            self._num = self._num[:, drop:]
            self._den = self._den[drop:]
            self._anchor = new_anchor

    def _emit(self, upto: int) -> np.ndarray:
        a = self._anchor
        lo, hi = self._emitted - a, upto - a
        if hi <= lo:
            return self._buf[:, :0]
        out = self._num[:, lo:hi] / self._den[lo:hi]
        self._emitted = upto
        return out
