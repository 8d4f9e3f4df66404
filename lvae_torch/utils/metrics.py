"""Structured metrics logging and device observability (port of
lvae_tpu.utils.metrics).

A JSONL metrics stream per run (one record per epoch, append-only, the JAX
package's format), the CUDA caching allocator's memory statistics, and a
wall-clock step timer that waits for the card before it stops.
"""

from __future__ import annotations

import json
import os
import time
from typing import Optional

import numpy as np
import torch


class MetricsLogger:
    """Append-only JSONL metrics writer; buffered, explicit flush."""

    def __init__(self, out_dir: Optional[str], filename: str = "metrics.jsonl"):
        self.path = os.path.join(out_dir, filename) if out_dir else None
        self._buf: list = []
        self._t0 = time.perf_counter()

    def log(self, step: int, metrics: dict) -> None:
        rec = {"step": step, "t": round(time.perf_counter() - self._t0, 4)}
        rec.update({k: float(v) for k, v in metrics.items()})
        self._buf.append(rec)
        if len(self._buf) >= 50:
            self.flush()

    def flush(self) -> None:
        if not self.path or not self._buf:
            self._buf.clear()
            return
        os.makedirs(os.path.dirname(os.path.abspath(self.path)), exist_ok=True)
        with open(self.path, "a") as f:
            for rec in self._buf:
                f.write(json.dumps(rec) + "\n")
        self._buf.clear()


def device_memory_stats() -> dict:
    """Per-card memory statistics of the caching allocator (bytes in use,
    peak and the card's total); empty without CUDA."""
    out = {}
    if not torch.cuda.is_available():
        return out
    for i in range(torch.cuda.device_count()):
        stats = torch.cuda.memory_stats(i)
        out[f"cuda:{i}"] = {
            "bytes_in_use": stats.get("allocated_bytes.all.current"),
            "peak_bytes_in_use": stats.get("allocated_bytes.all.peak"),
            "bytes_limit": torch.cuda.get_device_properties(i).total_memory,
        }
    return out


class StepTimer:
    """Wall-clock step timing; a call on the card ends in a synchronise."""

    def __init__(self):
        self.times: list = []

    def time(self, fn, *args, **kwargs):
        t0 = time.perf_counter()
        out = fn(*args, **kwargs)
        if torch.cuda.is_available() and torch.cuda.is_initialized():
            torch.cuda.synchronize()
        self.times.append(time.perf_counter() - t0)
        return out

    @property
    def median_ms(self) -> float:
        return float(np.median(self.times) * 1000) if self.times else float("nan")
