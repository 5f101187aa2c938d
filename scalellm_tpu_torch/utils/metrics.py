"""Metrics registry — counters, gauges, histograms with a Prometheus
text-format exporter.

Equivalent of the reference's prometheus-cpp macro layer
(reference: src/common/metrics.h:24-100 DEFINE_COUNTER/GAUGE/HISTOGRAM,
COUNTER_ADD, GAUGE_SET, HISTOGRAM_OBSERVE). Metric names match the
reference's serving metrics so the Grafana dashboard ports over:
time_to_first_token_latency_seconds, inter_token_latency_seconds,
end_2_end_latency_seconds, kv_cache_utilization_perc, etc.
(reference: continuous_scheduler.cpp:27-54, response_handler.cpp:24-27,
llm_handler.cpp:22-47).
"""

from __future__ import annotations

import bisect
import threading
from typing import Dict, List, Optional, Sequence, Tuple

# Histogram bucket ladders (reference: continuous_scheduler.cpp:46-54 uses
# 1ms–1s; response_handler.cpp:24-27 uses 0.2–60s).
LATENCY_BUCKETS_FAST = (
    0.001, 0.002, 0.005, 0.01, 0.02, 0.05, 0.1, 0.2, 0.5, 1.0,
)
LATENCY_BUCKETS_SLOW = (0.2, 0.5, 1.0, 2.0, 5.0, 10.0, 20.0, 30.0, 60.0)


class _Counter:
    __slots__ = ("value", "help")

    def __init__(self, help: str = ""):
        self.value = 0.0
        self.help = help


class _Gauge:
    __slots__ = ("value", "help")

    def __init__(self, help: str = ""):
        self.value = 0.0
        self.help = help


class _Histogram:
    __slots__ = ("buckets", "counts", "total", "count", "help")

    def __init__(self, buckets: Sequence[float], help: str = ""):
        self.buckets = tuple(sorted(buckets))
        self.counts = [0] * (len(self.buckets) + 1)
        self.total = 0.0
        self.count = 0
        self.help = help

    def observe(self, v: float) -> None:
        i = bisect.bisect_left(self.buckets, v)
        self.counts[i] += 1
        self.total += v
        self.count += 1


class _Family:
    """A thread-safe family of metrics of one kind."""

    def __init__(self, kind: str):
        self._kind = kind
        self._metrics: Dict[str, object] = {}
        self._lock = threading.Lock()


class CounterFamily(_Family):
    def __init__(self):
        super().__init__("counter")

    def inc(self, name: str, value: float = 1.0) -> None:
        with self._lock:
            c = self._metrics.get(name)
            if c is None:
                c = self._metrics[name] = _Counter()
            c.value += value

    def get(self, name: str) -> float:
        with self._lock:
            c = self._metrics.get(name)
            return c.value if c else 0.0


class GaugeFamily(_Family):
    def __init__(self):
        super().__init__("gauge")

    def set(self, name: str, value: float) -> None:
        with self._lock:
            g = self._metrics.get(name)
            if g is None:
                g = self._metrics[name] = _Gauge()
            g.value = float(value)

    def get(self, name: str) -> float:
        with self._lock:
            g = self._metrics.get(name)
            return g.value if g else 0.0


class HistogramFamily(_Family):
    def __init__(self):
        super().__init__("histogram")
        self._default_buckets: Dict[str, Sequence[float]] = {}

    def define(self, name: str, buckets: Sequence[float]) -> None:
        self._default_buckets[name] = buckets

    def observe(self, name: str, value: float) -> None:
        with self._lock:
            h = self._metrics.get(name)
            if h is None:
                buckets = self._default_buckets.get(name, LATENCY_BUCKETS_FAST)
                h = self._metrics[name] = _Histogram(buckets)
            h.observe(value)

    def get(self, name: str) -> Optional[_Histogram]:
        with self._lock:
            return self._metrics.get(name)


COUNTERS = CounterFamily()
# The scheduler's step counters: every engine step (one a dispatch), and of
# them the async dispatches and the multi-step ones (multi_step_fraction =
# num_multi_steps / num_engine_steps). Registered at 0 so /metrics shows them
# before the first step.
STEP_COUNTERS = ("num_engine_steps", "num_async_steps", "num_multi_steps")
for _name in STEP_COUNTERS:
    COUNTERS.inc(_name, 0.0)
GAUGES = GaugeFamily()
HISTOGRAMS = HistogramFamily()
HISTOGRAMS.define("time_to_first_token_latency_seconds", LATENCY_BUCKETS_FAST)
HISTOGRAMS.define("inter_token_latency_seconds", LATENCY_BUCKETS_FAST)
HISTOGRAMS.define("end_2_end_latency_seconds", LATENCY_BUCKETS_SLOW)
HISTOGRAMS.define("scheduling_latency_seconds", LATENCY_BUCKETS_FAST)
HISTOGRAMS.define("execute_model_latency_seconds", LATENCY_BUCKETS_FAST)


def export_prometheus() -> str:
    """Render all metrics in Prometheus text exposition format
    (the /metrics payload — reference: main.cpp:146-149, api_server.py:57-60)."""
    lines: List[str] = []
    with COUNTERS._lock:
        for name, c in sorted(COUNTERS._metrics.items()):
            lines.append(f"# TYPE {name} counter")
            lines.append(f"{name} {c.value}")
    with GAUGES._lock:
        for name, g in sorted(GAUGES._metrics.items()):
            lines.append(f"# TYPE {name} gauge")
            lines.append(f"{name} {g.value}")
    with HISTOGRAMS._lock:
        for name, h in sorted(HISTOGRAMS._metrics.items()):
            lines.append(f"# TYPE {name} histogram")
            cum = 0
            for b, cnt in zip(h.buckets, h.counts):
                cum += cnt
                lines.append(f'{name}_bucket{{le="{b}"}} {cum}')
            cum += h.counts[-1]
            lines.append(f'{name}_bucket{{le="+Inf"}} {cum}')
            lines.append(f"{name}_sum {h.total}")
            lines.append(f"{name}_count {h.count}")
    return "\n".join(lines) + "\n"


def reset_all() -> None:
    """Clear all metrics (test isolation)."""
    with COUNTERS._lock:
        COUNTERS._metrics.clear()
    with GAUGES._lock:
        GAUGES._metrics.clear()
    with HISTOGRAMS._lock:
        HISTOGRAMS._metrics.clear()
