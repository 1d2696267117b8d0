"""Minimal WFDB record reader (format 212), replacing the `wfdb` dependency
(JAX counterpart: data/wfdb_io.py, copied because the port imports nothing
of that package; numpy only).

The reference reads PhysioNet records via `wfdb.rdrecord(..., physical=False)
.d_signal` (reference: local_utils/local_utils.py:19-38,47-65). MIT-BIH
Arrhythmia and Noise-Stress-Test records are stored in WFDB format 212
(two 12-bit two's-complement samples packed into 3 bytes). This module
parses the `.hea` header and unpacks the `.dat` payload to the raw digital
signal (equivalent to wfdb's `d_signal`), with no external dependency.

Only what the pipeline needs is implemented: single-segment records, format
212, arbitrary channel count.
"""

from __future__ import annotations

import os
from dataclasses import dataclass

import numpy as np


@dataclass
class WfdbHeader:
    record_name: str
    n_sig: int
    fs: float
    sig_len: int
    file_names: list
    formats: list


def read_header(hea_path: str) -> WfdbHeader:
    with open(hea_path, "r") as f:
        lines = [ln.strip() for ln in f if ln.strip() and not ln.startswith("#")]
    first = lines[0].split()
    record_name = first[0].split("/")[0]
    n_sig = int(first[1])
    fs = float(first[2]) if len(first) > 2 else 250.0
    sig_len = int(first[3]) if len(first) > 3 else 0
    file_names, formats = [], []
    for ln in lines[1 : 1 + n_sig]:
        parts = ln.split()
        file_names.append(parts[0])
        formats.append(parts[1].split("x")[0].split(":")[0].split("+")[0])
    return WfdbHeader(record_name, n_sig, fs, sig_len, file_names, formats)


def _unpack_212(raw: np.ndarray, n_samples_total: int) -> np.ndarray:
    """Unpack WFDB format 212: 3 bytes -> two 12-bit signed samples."""
    if raw.size % 3:
        raw = raw[: raw.size - raw.size % 3]
    b = raw.reshape(-1, 3).astype(np.int32)
    s0 = ((b[:, 1] & 0x0F) << 8) | b[:, 0]
    s1 = ((b[:, 1] & 0xF0) << 4) | b[:, 2]
    out = np.empty(b.shape[0] * 2, dtype=np.int32)
    out[0::2] = s0
    out[1::2] = s1
    out = np.where(out > 2047, out - 4096, out)  # 12-bit two's complement
    return out[:n_samples_total]


def rdrecord_digital(record_path: str) -> np.ndarray:
    """Read a WFDB record's digital signal, shape (sig_len, n_sig).

    `record_path` is the path without extension (like wfdb.rdrecord).
    Equivalent to wfdb.rdrecord(record_path, physical=False).d_signal for
    single-segment format-212 records.
    """
    hdr = read_header(record_path + ".hea")
    base_dir = os.path.dirname(record_path)
    if any(fmt != "212" for fmt in hdr.formats):
        raise NotImplementedError(f"only format 212 supported, got {hdr.formats}")
    if len(set(hdr.file_names)) != 1:
        raise NotImplementedError("multi-file records not supported")
    dat_path = os.path.join(base_dir, hdr.file_names[0])
    raw = np.fromfile(dat_path, dtype=np.uint8)
    flat = _unpack_212(raw, hdr.sig_len * hdr.n_sig)
    return flat.reshape(-1, hdr.n_sig)


# --- MIT annotation (.atr) format ------------------------------------------
#
# The reference's cls_data derives N/V beat windows from MIT-BIH .atr beat
# annotations (reference train_cls.py:17-37 consumes the resulting caches).
# MIT annotation format (WFDB spec, annot(5)): a stream of little-endian
# 16-bit words; high 6 bits = type code A, low 10 bits = interval I (time
# delta in samples). A in 1..49 is an annotation at t += I. Pseudo-codes:
# SKIP(59) with I == 0 -> next two words hold a 32-bit interval (high 16
# bits first, PDP-11 long convention); NUM(60)/SUB(61)/CHN(62) carry field
# updates in I; AUX(63) is followed by ceil(I/2) words of aux bytes.
# A == 0 and I == 0 terminates the stream.

_CODE2SYM = {
    1: "N", 2: "L", 3: "R", 4: "a", 5: "V", 6: "F", 7: "J", 8: "A", 9: "S",
    10: "E", 11: "j", 12: "/", 13: "Q", 14: "~", 16: "|", 18: "s", 19: "T",
    20: "*", 21: "D", 22: '"', 23: "=", 24: "p", 25: "B", 26: "^", 27: "t",
    28: "+", 29: "u", 30: "?", 31: "!", 32: "[", 33: "]", 34: "e", 35: "n",
    36: "@", 37: "x", 38: "f", 39: "(", 40: ")", 41: "r",
}
_SYM2CODE = {v: k for k, v in _CODE2SYM.items()}

_SKIP, _NUM, _SUB, _CHN, _AUX = 59, 60, 61, 62, 63


def rdann(record_path: str, ext: str = "atr"):
    """Read a WFDB annotation file -> (samples (n,) int64, symbols list).

    Equivalent to wfdb.rdann(record_path, ext) restricted to the
    (sample, symbol) pair the beat-cache builder needs; NUM/SUB/CHN/AUX
    field updates are parsed and discarded.
    """
    raw = np.fromfile(f"{record_path}.{ext}", dtype=np.uint8)
    words = raw[: raw.size - raw.size % 2].view("<u2")
    t = 0
    samples, symbols = [], []
    i = 0
    n = words.size
    while i < n:
        w = int(words[i])
        i += 1
        code, interval = w >> 10, w & 0x3FF
        if code == 0 and interval == 0:
            break
        if code == _SKIP:
            if interval == 0 and i + 1 < n:
                # The 32-bit SKIP interval is SIGNED in the WFDB C
                # reference (annot(5) 'long' — negative skips move time
                # backwards); reconstruct via two's complement.
                skip = (int(words[i]) << 16) | int(words[i + 1])
                if skip >= 1 << 31:
                    skip -= 1 << 32
                t += skip
                i += 2
            # (a nonzero-interval SKIP advances time like an annotation
            # but emits nothing)
            else:
                t += interval
        elif code == _AUX:
            i += (interval + 1) // 2  # skip aux bytes (word-padded)
        elif code in (_NUM, _SUB, _CHN):
            pass  # field updates; values not needed here
        elif 1 <= code <= 49:
            t += interval
            samples.append(t)
            symbols.append(_CODE2SYM.get(code, "?"))
    return np.asarray(samples, np.int64), symbols


def wrann(record_path: str, samples, symbols, ext: str = "atr") -> None:
    """Write a minimal WFDB annotation file (inverse of rdann).

    Used by the roundtrip tests (no real PhysioNet files are available in
    this environment) and for exporting detector outputs in the standard
    format.
    """
    samples = np.asarray(samples, np.int64)
    out = []
    t = 0
    for s, sym in zip(samples, symbols):
        delta = int(s) - t
        t = int(s)
        code = _SYM2CODE.get(sym, 13)  # unknown -> Q
        if delta >= 1024 or delta < 0:
            out.append(_SKIP << 10)
            out.append((delta >> 16) & 0xFFFF)
            out.append(delta & 0xFFFF)
            delta = 0
        out.append((code << 10) | delta)
    out.append(0)  # terminator
    np.asarray(out, dtype="<u2").tofile(f"{record_path}.{ext}")


def _pack_212(flat: np.ndarray) -> np.ndarray:
    """Pack int samples (12-bit two's complement range) into WFDB format
    212 bytes — the exact inverse of _unpack_212."""
    flat = np.asarray(flat, np.int32)
    if np.any((flat < -2048) | (flat > 2047)):
        raise ValueError("format 212 samples must fit 12-bit signed range")
    if flat.size % 2:
        flat = np.concatenate([flat, np.zeros(1, np.int32)])
    u = flat & 0xFFF  # two's complement into 12 bits
    s0, s1 = u[0::2], u[1::2]
    out = np.empty((s0.size, 3), np.uint8)
    out[:, 0] = s0 & 0xFF
    out[:, 1] = ((s0 >> 8) & 0x0F) | (((s1 >> 8) & 0x0F) << 4)
    out[:, 2] = s1 & 0xFF
    return out.reshape(-1)


def wrsamp_212(record_path: str, signal: np.ndarray, fs: float = 360.0,
               units_per_mv: int = 200) -> None:
    """Write a single-segment format-212 WFDB record (.hea + .dat) —
    the inverse of rdrecord_digital.

    Exists so miniature 212 fixtures can be committed for the end-to-end
    real-data ingestion rehearsal (tests/test_wfdb_e2e.py; no real
    PhysioNet files are downloadable in this environment) and so detector/
    denoiser outputs can be exported in the standard format.

    signal: (sig_len, n_sig) DIGITAL integer samples in [-2048, 2047].
    """
    signal = np.asarray(signal)
    if signal.ndim != 2:
        raise ValueError(f"signal must be (sig_len, n_sig), got {signal.shape}")
    sig_len, n_sig = signal.shape
    base = os.path.basename(record_path)
    dat_name = base + ".dat"
    lines = [f"{base} {n_sig} {fs:g} {sig_len}"]
    for i in range(n_sig):
        # file fmt gain adc_res adc_zero init_value checksum block_size desc
        lines.append(f"{dat_name} 212 {units_per_mv} 11 0 "
                     f"{int(signal[0, i])} 0 0 sig{i}")
    with open(record_path + ".hea", "w") as f:
        f.write("\n".join(lines) + "\n")
    _pack_212(signal.reshape(-1)).tofile(
        os.path.join(os.path.dirname(record_path), dat_name))


# Record ids used by the reference data pipeline.
MITBIH_RECORDS = [
    100, 101, 102, 103, 104, 105, 106, 107, 108, 109, 111, 112, 113, 114, 115,
    116, 117, 118, 119, 121, 122, 123, 124, 200, 201, 202, 203, 205, 207, 208,
    209, 210, 212, 213, 214, 215, 217, 219, 220, 221, 222, 223, 228, 230, 231,
    232, 233, 234,
]
NSTDB_NOISE_RECORDS = ["bw", "ma", "em"]
