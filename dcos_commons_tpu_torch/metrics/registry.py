"""Counter/gauge registry with Prometheus text exposition.

Reference: metrics/Metrics.java — counters incremented on the hot path
(offers received/processed, revives, declines, suppresses, operation
types, task statuses) and scraped at /v1/metrics/prometheus.  StatsD
push is env-gated as in the reference (STATSD_UDP_HOST/PORT,
Metrics.java:74-79).
"""

from __future__ import annotations

import os
import re
import socket
import threading
import time
from bisect import bisect_left
from collections import deque
from typing import Callable, Dict, List, Optional, Tuple


def percentile(ordered, q: int) -> float:
    """Nearest-rank percentile over an ASCENDING-sorted sequence —
    the one convention shared by the registry's timer aggregates, the
    serve engine's TTFT gauges, and bench percentiles (three copies
    of this formula once disagreed off-by-one at small counts)."""
    n = len(ordered)
    return ordered[min(n - 1, max(0, -(-q * n // 100) - 1))]


# Prometheus metric-name charset: [a-zA-Z_:][a-zA-Z0-9_:]*.  Metric
# names here are dotted and may embed runtime ids with arbitrary
# characters (ha.replication.lag.<puller-id>): everything outside the
# charset becomes "_", and a leading digit gets a "_" prefix — an
# invalid line would make a scraper reject the WHOLE exposition.
_PROM_INVALID = re.compile(r"[^a-zA-Z0-9_:]")


def prometheus_name(name: str) -> str:
    metric = _PROM_INVALID.sub("_", name.lower())
    if metric and metric[0].isdigit():
        metric = "_" + metric
    return metric


# histogram bucket upper bounds (seconds) for timer exposition: the
# offer cycle lives in the 0.1ms..10s band, so a log-ish ladder over
# that range keeps per-record cost to one bisect over 14 floats
TIMER_BUCKETS: Tuple[float, ...] = (
    0.0001, 0.00025, 0.0005, 0.001, 0.0025, 0.005, 0.01, 0.025,
    0.05, 0.1, 0.25, 0.5, 1.0, 2.5, 5.0, 10.0,
)


class MetricHistory:
    """Bounded time-series rings over registry snapshots.

    One deque of ``(t, value)`` per metric name, drop-oldest at
    ``capacity`` samples — the "recent past" behind
    ``GET /v1/debug/health``.  Counters additionally support windowed
    rate derivation (``rate()``: delta over the observed window), so a
    monotonic ``offers.evaluated`` reads as evaluations/second without
    a Prometheus server in the loop.  Sampling is driven by the health
    monitor (one ``Metrics.snapshot()`` per sample, time-throttled),
    not per increment: recording N metrics costs N deque appends.
    """

    def __init__(self, capacity: int = 240):
        self.capacity = max(1, int(capacity))
        self._series: Dict[str, deque] = {}
        self._counter_names: set = set()
        self._lock = threading.Lock()

    def record(
        self,
        snapshot: Dict[str, float],
        counter_names=(),
        t: Optional[float] = None,
    ) -> None:
        now = time.time() if t is None else t
        with self._lock:
            self._counter_names.update(counter_names)
            for name, value in snapshot.items():
                series = self._series.get(name)
                if series is None:
                    series = self._series[name] = deque(
                        maxlen=self.capacity
                    )
                series.append((now, float(value)))

    def names(self) -> List[str]:
        with self._lock:
            return sorted(self._series)

    def series(self, name: str, since: float = 0.0) -> List[Tuple[float, float]]:
        """Samples of one metric, oldest first, optionally only those
        at wall time > ``since``."""
        with self._lock:
            samples = list(self._series.get(name, ()))
        if since:
            samples = [s for s in samples if s[0] > since]
        return samples

    def rate(self, name: str, window_s: float = 60.0) -> Optional[float]:
        """Per-second delta of a COUNTER over (up to) the trailing
        window; None for non-counters or <2 samples.  A counter reset
        (registry rebuild) clamps to 0 rather than reporting a huge
        negative rate."""
        with self._lock:
            if name not in self._counter_names:
                return None
            samples = list(self._series.get(name, ()))
        if len(samples) < 2:
            return None
        t1, v1 = samples[-1]
        t0, v0 = samples[0]
        for t, v in reversed(samples):
            if t1 - t > window_s:
                break
            t0, v0 = t, v
        if t1 <= t0:
            return None
        return max(0.0, (v1 - v0) / (t1 - t0))

    def summary(self) -> Dict[str, dict]:
        """One compact row per metric: last value, window min/max,
        sample count, and (counters) the derived rate — the
        ``history`` block of ``/v1/debug/health``."""
        with self._lock:
            names = sorted(self._series)
        out: Dict[str, dict] = {}
        for name in names:
            samples = self.series(name)
            if not samples:
                continue
            values = [v for _, v in samples]
            row = {
                "last": values[-1],
                "min": min(values),
                "max": max(values),
                "n": len(values),
                "span_s": round(samples[-1][0] - samples[0][0], 3),
            }
            rate = self.rate(name)
            if rate is not None:
                row["rate_per_s"] = round(rate, 6)
            out[name] = row
        return out


class Metrics:
    def __init__(self) -> None:
        self._counters: Dict[str, float] = {}
        self._gauges: Dict[str, Callable[[], float]] = {}
        self._timers: Dict[str, list] = {}
        self._timer_totals: Dict[str, int] = {}
        # monotonic per-timer aggregates for Prometheus: total seconds
        # and per-bucket counts (cumulative at exposition time) — the
        # 256-sample ring re-aggregates and so can only ever be a
        # gauge; rate()/histogram_quantile() need these instead
        self._timer_sums: Dict[str, float] = {}
        self._timer_buckets: Dict[str, List[int]] = {}
        # bounded time-series rings behind /v1/debug/health; sampling
        # is pull-driven (sample_history()), never per-increment
        self.history = MetricHistory()
        self._lock = threading.Lock()
        self._statsd: Optional[socket.socket] = None
        self._statsd_addr = None
        host = os.environ.get("STATSD_UDP_HOST")
        port = os.environ.get("STATSD_UDP_PORT")
        if host and port:
            self._statsd = socket.socket(socket.AF_INET, socket.SOCK_DGRAM)
            self._statsd_addr = (host, int(port))

    def incr(self, name: str, value: float = 1.0) -> None:
        with self._lock:
            self._counters[name] = self._counters.get(name, 0.0) + value
        if self._statsd is not None:
            try:
                self._statsd.sendto(
                    f"{name}:{value}|c".encode(), self._statsd_addr
                )
            except OSError:
                pass

    def gauge(self, name: str, fn: Callable[[], float]) -> None:
        with self._lock:
            self._gauges[name] = fn

    def time(self, name: str):
        """Context manager recording wall seconds (offers.process timer)."""
        registry = self

        class _Timer:
            def __enter__(self):
                self._t0 = time.monotonic()
                return self

            def __exit__(self, *exc):
                elapsed = time.monotonic() - self._t0
                with registry._lock:
                    registry._timers.setdefault(name, []).append(elapsed)
                    del registry._timers[name][:-256]  # ring buffer
                    registry._timer_totals[name] = (
                        registry._timer_totals.get(name, 0) + 1
                    )
                    registry._timer_sums[name] = (
                        registry._timer_sums.get(name, 0.0) + elapsed
                    )
                    buckets = registry._timer_buckets.get(name)
                    if buckets is None:
                        buckets = registry._timer_buckets[name] = (
                            [0] * (len(TIMER_BUCKETS) + 1)
                        )
                    buckets[bisect_left(TIMER_BUCKETS, elapsed)] += 1
                if registry._statsd is not None:
                    # timers push like counters do (reference:
                    # Metrics.getTimer — StatsD timing datagrams in
                    # milliseconds, the `|ms` type)
                    try:
                        registry._statsd.sendto(
                            f"{name}:{elapsed * 1000.0:.3f}|ms".encode(),
                            registry._statsd_addr,
                        )
                    except OSError:
                        pass
                return False

        return _Timer()

    def counters(self) -> Dict[str, float]:
        with self._lock:
            return dict(self._counters)

    def timer_count(self, name: str) -> int:
        """Total recordings of one timer since process start — NOT
        capped by the 256-sample ring, so callers can window samples
        across a phase boundary without index drift."""
        with self._lock:
            return self._timer_totals.get(name, 0)

    def timer_samples(self, name: str, since_count: int = 0) -> list:
        """Copy of the retained samples (newest-last, last 256) for
        one timer, optionally only those recorded after a prior
        ``timer_count()`` reading.  When the ring has trimmed past the
        requested boundary, returns what survives — the newest
        samples, which is what phase-window callers want."""
        with self._lock:
            samples = list(self._timers.get(name, ()))
            fresh = self._timer_totals.get(name, 0) - since_count
        if fresh <= 0:
            return []
        return samples[-fresh:] if fresh < len(samples) else samples

    def snapshot(self) -> Dict[str, float]:
        out = self.counters()
        with self._lock:
            gauges = dict(self._gauges)
            for name, samples in self._timers.items():
                if samples:
                    ordered = sorted(samples)
                    n = len(ordered)
                    mean = sum(ordered) / n
                    out[f"{name}.count"] = float(n)
                    out[f"{name}.min_s"] = ordered[0]
                    out[f"{name}.mean_s"] = mean
                    out[f"{name}.avg_s"] = mean  # legacy alias
                    out[f"{name}.max_s"] = ordered[-1]
                    # nearest-rank p95 over the ring buffer window
                    out[f"{name}.p95_s"] = percentile(ordered, 95)
        for name, fn in gauges.items():
            try:
                out[name] = float(fn())
            except Exception:  # sdklint: disable=swallowed-exception — one broken gauge must not break the whole snapshot/scrape
                pass
        return out

    def sample_history(self, t: Optional[float] = None) -> None:
        """Append one snapshot to the bounded history rings (called by
        the health monitor on its sampling cadence)."""
        with self._lock:
            counter_names = set(self._counters)
        self.history.record(self.snapshot(), counter_names, t=t)

    def prometheus(self) -> str:
        """Prometheus text format (reference: Metrics.java:85-97).

        ``incr()`` entries are monotonic and expose as ``counter`` (so
        ``rate()`` works on them downstream); registered gauges and
        the windowed timer aggregates (min/mean/max/p95 over the
        256-sample ring) expose as ``gauge``.  Each timer additionally
        exposes a full ``histogram`` family — monotonic cumulative
        ``_bucket{le=...}`` counts plus ``_sum``/``_count`` — so
        ``rate()``/``histogram_quantile()`` work downstream (the
        ring's ``.count`` aggregate is superseded by the monotonic
        ``_count`` and skipped here to avoid the name collision).
        Names are sanitized to the Prometheus charset
        (``prometheus_name``): dotted names with embedded runtime ids
        like ``ha.replication.lag.<id>`` must never emit an invalid
        line, and a sanitization collision keeps the first name only
        (duplicate series without labels are invalid too)."""
        with self._lock:
            counter_names = set(self._counters)
            timer_names = set(self._timers)
            timer_totals = dict(self._timer_totals)
            timer_sums = dict(self._timer_sums)
            timer_buckets = {
                name: list(counts)
                for name, counts in self._timer_buckets.items()
            }
        skip = {f"{name}.count" for name in timer_names}
        lines = []
        seen = set()
        for name, value in sorted(self.snapshot().items()):
            if name in skip:
                continue
            metric = prometheus_name(name)
            if metric in seen:
                continue
            seen.add(metric)
            kind = "counter" if name in counter_names else "gauge"
            lines.append(f"# TYPE {metric} {kind}")
            lines.append(f"{metric} {value}")
        for name in sorted(timer_names):
            metric = prometheus_name(name)
            if metric in seen:
                continue
            seen.add(metric)
            lines.append(f"# TYPE {metric} histogram")
            cumulative = 0
            counts = timer_buckets.get(
                name, [0] * (len(TIMER_BUCKETS) + 1)
            )
            for bound, count in zip(TIMER_BUCKETS, counts):
                cumulative += count
                lines.append(
                    f'{metric}_bucket{{le="{bound}"}} {cumulative}'
                )
            lines.append(
                f'{metric}_bucket{{le="+Inf"}} {timer_totals.get(name, 0)}'
            )
            lines.append(f"{metric}_sum {timer_sums.get(name, 0.0)}")
            lines.append(f"{metric}_count {timer_totals.get(name, 0)}")
        return "\n".join(lines) + "\n"
