"""Metrics registry: counters, gauges and histograms for the pipeline.

The generation stack reports quantities, not just stage times: rows
written, bytes flushed, write-queue depth, backpressure stalls, shard
commit latency.  :class:`MetricsRegistry` is the one place they live —
get-or-create by name, thread-safe updates, one ``snapshot()`` consumed
by ``--metrics-out``, wrapped in the envelope :func:`bench_envelope`
builds (schema version, git SHA, host, torch, CUDA and card).

Histograms keep a bounded sample buffer (uniform reservoir past
``HIST_MAX_SAMPLES``) plus exact count/sum/min/max, and report
p50/p95/p99 — shard commit latency at production shard counts stays
O(1) memory.
"""
from __future__ import annotations

import json
import os
import random
import subprocess
import sys
import threading
import time
from typing import Any, Dict, List, Optional

__all__ = ["Counter", "Gauge", "Histogram", "MetricsRegistry",
           "run_env", "bench_envelope", "write_bench", "SCHEMA_VERSION"]

#: bump when the --metrics-out envelope changes shape
SCHEMA_VERSION = 2

#: histogram sample cap — past this, uniform reservoir replacement
HIST_MAX_SAMPLES = 8192


class Counter:
    """Monotonic sum (float increments allowed — stall seconds are a
    counter too)."""

    kind = "counter"
    __slots__ = ("name", "unit", "_v", "_lock")

    def __init__(self, name: str, unit: str = ""):
        self.name = name
        self.unit = unit
        self._v = 0.0
        self._lock = threading.Lock()

    def inc(self, n: float = 1.0) -> None:
        with self._lock:
            self._v += n

    @property
    def value(self) -> float:
        with self._lock:
            return self._v

    def snapshot(self) -> Dict[str, Any]:
        return {"name": self.name, "kind": self.kind, "unit": self.unit,
                "value": self.value}


class Gauge:
    """Last-set value, with the observed max kept alongside (queue depth
    is read as 'how deep did it get', not just 'where did it end')."""

    kind = "gauge"
    __slots__ = ("name", "unit", "_v", "_max", "_lock")

    def __init__(self, name: str, unit: str = ""):
        self.name = name
        self.unit = unit
        self._v = 0.0
        self._max = float("-inf")
        self._lock = threading.Lock()

    def set(self, v: float) -> None:
        with self._lock:
            self._v = v
            if v > self._max:
                self._max = v

    @property
    def value(self) -> float:
        with self._lock:
            return self._v

    @property
    def max(self) -> float:
        with self._lock:
            return self._max if self._max != float("-inf") else 0.0

    def snapshot(self) -> Dict[str, Any]:
        return {"name": self.name, "kind": self.kind, "unit": self.unit,
                "value": self.value, "max": self.max}


class Histogram:
    """Bounded-memory distribution: exact count/sum/min/max + a uniform
    sample for quantiles (exact until ``HIST_MAX_SAMPLES`` observations,
    reservoir-replaced after)."""

    kind = "histogram"
    __slots__ = ("name", "unit", "_samples", "_count", "_sum", "_min",
                 "_max", "_rng", "_lock", "_cap")

    def __init__(self, name: str, unit: str = "",
                 max_samples: int = HIST_MAX_SAMPLES):
        self.name = name
        self.unit = unit
        self._samples: List[float] = []
        self._count = 0
        self._sum = 0.0
        self._min = float("inf")
        self._max = float("-inf")
        self._rng = random.Random(0xB0B)   # deterministic reservoir
        self._lock = threading.Lock()
        self._cap = max_samples

    def observe(self, v: float) -> None:
        with self._lock:
            self._count += 1
            self._sum += v
            if v < self._min:
                self._min = v
            if v > self._max:
                self._max = v
            if len(self._samples) < self._cap:
                self._samples.append(v)
            else:
                j = self._rng.randrange(self._count)
                if j < self._cap:
                    self._samples[j] = v

    @property
    def count(self) -> int:
        with self._lock:
            return self._count

    def percentile(self, p: float) -> float:
        """Nearest-rank percentile of the kept sample, ``p`` in [0, 100]."""
        with self._lock:
            if not self._samples:
                return 0.0
            s = sorted(self._samples)
        idx = min(len(s) - 1, max(0, int(round(p / 100.0 * (len(s) - 1)))))
        return s[idx]

    def snapshot(self) -> Dict[str, Any]:
        with self._lock:
            count, total = self._count, self._sum
            mn = self._min if count else 0.0
            mx = self._max if count else 0.0
        return {"name": self.name, "kind": self.kind, "unit": self.unit,
                "count": count, "sum": total, "min": mn, "max": mx,
                "mean": (total / count if count else 0.0),
                "p50": self.percentile(50), "p95": self.percentile(95),
                "p99": self.percentile(99)}


class MetricsRegistry:
    """Get-or-create metric store.  Asking for an existing name with a
    different kind raises — one name, one meaning."""

    def __init__(self):
        self._metrics: Dict[str, Any] = {}
        self._lock = threading.Lock()

    def _get(self, cls, name: str, unit: str):
        with self._lock:
            m = self._metrics.get(name)
            if m is None:
                m = self._metrics[name] = cls(name, unit)
            elif not isinstance(m, cls):
                raise TypeError(f"metric {name!r} already registered as "
                                f"{m.kind}, not {cls.kind}")
            return m

    def counter(self, name: str, unit: str = "") -> Counter:
        return self._get(Counter, name, unit)

    def gauge(self, name: str, unit: str = "") -> Gauge:
        return self._get(Gauge, name, unit)

    def histogram(self, name: str, unit: str = "") -> Histogram:
        return self._get(Histogram, name, unit)

    def names(self) -> List[str]:
        with self._lock:
            return sorted(self._metrics)

    def snapshot(self) -> List[Dict[str, Any]]:
        """Deterministically ordered per-metric dicts."""
        with self._lock:
            metrics = [self._metrics[k] for k in sorted(self._metrics)]
        return [m.snapshot() for m in metrics]


# ---------------------------------------------------------------------------
# run environment + the --metrics-out envelope
# ---------------------------------------------------------------------------

def _git_sha() -> Optional[str]:
    sha = os.environ.get("GITHUB_SHA")
    if sha:
        return sha
    try:
        out = subprocess.run(["git", "rev-parse", "HEAD"],
                             capture_output=True, timeout=10,
                             cwd=os.path.dirname(os.path.abspath(__file__)))
        if out.returncode == 0:
            return out.stdout.decode().strip() or None
    except (OSError, subprocess.SubprocessError):
        pass
    return None


def gpu_line() -> Optional[str]:
    """The first card's ``name, power.limit`` as ``nvidia-smi
    --query-gpu=name,power.limit --format=csv,noheader`` prints it
    (``"NVIDIA H100 80GB HBM3, 700.00 W"``); None where ``nvidia-smi``
    is missing or names no card."""
    try:
        out = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                              "--format=csv,noheader"], capture_output=True,
                             text=True, timeout=60)
    except (OSError, subprocess.SubprocessError):
        return None
    lines = out.stdout.strip().splitlines()
    return lines[0].strip() if out.returncode == 0 and lines else None


def run_env() -> Dict[str, Any]:
    """Host/device provenance stamped on every benchmark/metrics file —
    numbers without the machine that produced them don't trend."""
    import platform
    env: Dict[str, Any] = {
        "git_sha": _git_sha(),
        "host": platform.node(),
        "platform": platform.platform(),
        "python": sys.version.split()[0],
        "cpu_count": os.cpu_count(),
    }
    try:
        import torch
        env["torch"] = torch.__version__
        env["cuda"] = torch.version.cuda
        n = torch.cuda.device_count() if torch.cuda.is_available() else 0
        env["device"] = "cuda" if n else "cpu"
        env["n_devices"] = n
        env["card"] = torch.cuda.get_device_name(0) if n else None
    except Exception:        # noqa: BLE001 — env report must never fail
        env.update(torch=None, cuda=None, device=None, n_devices=None,
                   card=None)
    # a card's times hold only beside its power limit (it may be set
    # below the maximum, and then runs slower under load)
    line = gpu_line() if env["card"] else None
    env["power_limit"] = (line.rsplit(",", 1)[1].strip()
                          if line and "," in line else None)
    return env


def bench_envelope(suite: str, metrics: Any,
                   extra: Optional[Dict[str, Any]] = None
                   ) -> Dict[str, Any]:
    """Wrap a payload in the versioned envelope: schema version, suite
    name, created timestamp, git SHA + host/device env, payload under
    ``"metrics"``."""
    out: Dict[str, Any] = {"schema_version": SCHEMA_VERSION, "suite": suite,
                           "created_unix": time.time(), "env": run_env(),
                           "metrics": metrics}
    if extra:
        out.update(extra)
    return out


def write_bench(suite: str, metrics: Any, path: str,
                extra: Optional[Dict[str, Any]] = None) -> Dict[str, Any]:
    """Serialize :func:`bench_envelope` to ``path`` (dirs created)."""
    payload = bench_envelope(suite, metrics, extra)
    os.makedirs(os.path.dirname(path) or ".", exist_ok=True)
    with open(path, "w") as f:
        json.dump(payload, f, indent=1)
    return payload
