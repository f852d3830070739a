"""Structured metrics registry.

Replaces the reference's scattered hot-path prints (delivered fps every 100
frames, inference fps, TTS first-chunk latency — reference: webrtc.py:82-89,
lipreal.py:128-133, ttsreal.py:65-67) with named counters/gauges/rate meters
that engines update and the server exposes.
"""
from __future__ import annotations

import threading
import time
from collections import defaultdict, deque


class RateMeter:
    """Sliding-window event-rate meter (e.g. frames/sec)."""

    def __init__(self, window: float = 5.0):
        self.window = window
        self._events: list[tuple[float, int]] = []
        self._lock = threading.Lock()

    def tick(self, n: int = 1) -> None:
        now = time.monotonic()
        with self._lock:
            self._events.append((now, n))
            cutoff = now - self.window
            while self._events and self._events[0][0] < cutoff:
                self._events.pop(0)

    @property
    def rate(self) -> float:
        now = time.monotonic()
        with self._lock:
            cutoff = now - self.window
            total = sum(n for t, n in self._events if t >= cutoff)
        return total / self.window


class LatencyMeter:
    """Tracks last / mean latency in seconds, and the newest ``window``
    samples for quantiles."""

    def __init__(self, window: int = 1024):
        self.last = 0.0
        self.count = 0
        self.total = 0.0
        self._samples: deque[float] = deque(maxlen=window)
        self._lock = threading.Lock()

    def observe(self, seconds: float) -> None:
        with self._lock:
            self.last = seconds
            self.count += 1
            self.total += seconds
            self._samples.append(seconds)

    def reset(self) -> None:
        """Forget every sample (a new measurement window)."""
        with self._lock:
            self.last, self.count, self.total = 0.0, 0, 0.0
            self._samples.clear()

    def quantile(self, q: float) -> float:
        """Nearest-rank quantile of the retained samples (0.0 when empty)."""
        with self._lock:
            ordered = sorted(self._samples)
        if not ordered:
            return 0.0
        return ordered[min(len(ordered) - 1, int(q * len(ordered)))]

    @property
    def mean(self) -> float:
        with self._lock:
            return self.total / self.count if self.count else 0.0


class MetricsRegistry:
    def __init__(self):
        self._counters: dict[str, float] = defaultdict(float)
        self._gauges: dict[str, float] = {}
        self._rates: dict[str, RateMeter] = {}
        self._latencies: dict[str, LatencyMeter] = {}
        self._lock = threading.Lock()

    def counter(self, name: str, inc: float = 1.0) -> None:
        with self._lock:
            self._counters[name] += inc

    def gauge(self, name: str, value: float) -> None:
        with self._lock:
            self._gauges[name] = value

    def rate(self, name: str) -> RateMeter:
        with self._lock:
            if name not in self._rates:
                self._rates[name] = RateMeter()
            return self._rates[name]

    def latency(self, name: str) -> LatencyMeter:
        with self._lock:
            if name not in self._latencies:
                self._latencies[name] = LatencyMeter()
            return self._latencies[name]

    def snapshot(self) -> dict:
        with self._lock:
            return {
                "counters": dict(self._counters),
                "gauges": dict(self._gauges),
                "rates": {k: v.rate for k, v in self._rates.items()},
                "latencies_ms": {
                    k: {"last": v.last * 1e3, "mean": v.mean * 1e3,
                        "p50": v.quantile(0.5) * 1e3}
                    for k, v in self._latencies.items()
                },
            }


metrics = MetricsRegistry()
