"""Training metrics: throughput, MFU and the emission contract (port of
``kubeflow_tpu/train/metrics.py``).

MFU divides by the card's own dense bf16 tensor-core peak, looked up by
its name (``torch.cuda.get_device_name()``). On the CPU, or on a card the
table does not know, there is no peak and ``mfu`` is left out: no peak is
made up. Emission writes ``name=value`` lines to stdout and JSON lines to
an optional file, as the JAX package does."""

from __future__ import annotations

import json
import sys
import time
from typing import Optional, TextIO

#: Dense bf16 tensor-core peaks (FLOP/s) from NVIDIA's data sheets, by a
#: substring of the device name; the first match wins.
BF16_PEAKS = (
    ("H100 PCIe", 756e12),
    ("H100 NVL", 835e12),
    ("H100", 989e12),        # SXM
    ("H200", 989e12),
)


def bf16_peak_flops(device_name: Optional[str]) -> Optional[float]:
    """The card's dense bf16 peak, or None (CPU, unknown card)."""
    if not device_name:
        return None
    for key, peak in BF16_PEAKS:
        if key in device_name:
            return peak
    return None


class Throughput:
    """Steady-state throughput over a sliding window (EMA of step time)."""

    def __init__(self, tokens_per_step: float, num_chips: int,
                 flops_per_token: float, generation: Optional[str] = None):
        self.tokens_per_step = tokens_per_step
        self.num_chips = num_chips
        self.flops_per_token = flops_per_token
        self.peak_flops = bf16_peak_flops(generation)
        self._last: Optional[float] = None
        self._ema_dt: Optional[float] = None

    @property
    def ema_step_time_s(self) -> Optional[float]:
        """Smoothed steady step time (seconds); None before two ticks."""
        return self._ema_dt

    def tick(self, steps_elapsed: int = 1) -> dict:
        """Update with the wall time since the previous tick, which covered
        ``steps_elapsed`` train steps."""
        now = time.perf_counter()
        out: dict = {}
        if self._last is not None and steps_elapsed > 0:
            dt = (now - self._last) / steps_elapsed
            self._ema_dt = dt if self._ema_dt is None \
                else 0.9 * self._ema_dt + 0.1 * dt
            tps = self.tokens_per_step / self._ema_dt
            out = {
                "step_time_ms": self._ema_dt * 1e3,
                "tokens_per_sec": tps,
                "tokens_per_sec_per_chip": tps / self.num_chips,
            }
            if self.peak_flops:
                out["mfu"] = (self.flops_per_token * tps) / (
                    self.num_chips * self.peak_flops)
        self._last = now
        return out


class MetricsEmitter:
    """Writes `name=value` lines to stdout (tune collector contract) and
    JSON lines to an optional file (operator scrape)."""

    def __init__(self, jsonl_path: Optional[str] = None,
                 stream: Optional[TextIO] = None):
        self.stream = stream or sys.stdout
        self.jsonl_path = jsonl_path
        self.jsonl = open(jsonl_path, "a") if jsonl_path else None

    def emit(self, step: int, metrics: dict) -> None:
        flat = {k: (float(v) if hasattr(v, "item")
                    or isinstance(v, (int, float)) else v)
                for k, v in metrics.items()}
        parts = " ".join(f"{k}={v:.6g}" if isinstance(v, float) else f"{k}={v}"
                         for k, v in sorted(flat.items()))
        print(f"step={step} {parts}", file=self.stream, flush=True)
        if self.jsonl:
            self.jsonl.write(json.dumps({"step": step, **flat}) + "\n")
            self.jsonl.flush()

    def close(self) -> None:
        if self.jsonl:
            self.jsonl.close()
