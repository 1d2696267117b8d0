"""Run logging, the reference's `train_log` decorator (JAX counterpart:
utils/run_log.py; the reference wraps `train()` in `@train_log()` from its
unvendored `global_utils`, denoise_train.py:9,14).

Each run appends one JSON line to `train_log.jsonl`: the timestamp, the
function, the keyword arguments of record (str, int, float and bool ones:
model, noise, epochs), the wall time and the outcome.

If ECG_NOTIFY_CMD is set, the finished record is piped to that shell
command's standard input after every run, success or failure (the
reference's `easymail`, as a hook that composes with whatever transport
the operator has). The hook runs detached and its failures never fail the
run.
"""

from __future__ import annotations

import functools
import json
import os
import subprocess
import time
from datetime import datetime
from typing import Callable


def train_log(log_file: str = "./train_log.jsonl") -> Callable:
    def deco(fn: Callable) -> Callable:
        @functools.wraps(fn)
        def wrapper(*args, **kwargs):
            rec = {
                "ts": datetime.now().isoformat(timespec="seconds"),
                "fn": fn.__name__,
                "kwargs": {k: v for k, v in kwargs.items()
                           if isinstance(v, (str, int, float, bool))},
            }
            t0 = time.time()
            try:
                out = fn(*args, **kwargs)
                rec["status"] = "ok"
                return out
            except Exception as e:  # noqa: BLE001 — logged, then re-raised
                rec["status"] = f"error: {type(e).__name__}: {e}"
                raise
            finally:
                rec["wall_s"] = round(time.time() - t0, 2)
                line = json.dumps(rec)
                try:
                    with open(log_file, "a") as f:
                        f.write(line + "\n")
                except OSError:
                    pass
                _notify(line)

        return wrapper

    return deco


def _notify(line: str) -> None:
    """Pipe the run record to ECG_NOTIFY_CMD, if set (best effort,
    detached: a slow or hung notifier does not hold up the run)."""
    cmd = os.environ.get("ECG_NOTIFY_CMD")
    if not cmd:
        return
    try:
        proc = subprocess.Popen(cmd, shell=True, stdin=subprocess.PIPE,
                                stdout=subprocess.DEVNULL, stderr=subprocess.DEVNULL,
                                start_new_session=True)
        if proc.stdin is not None:
            try:
                proc.stdin.write(line.encode())
                proc.stdin.close()
            except (BrokenPipeError, OSError):
                pass
    except (OSError, subprocess.SubprocessError):
        pass
