"""Metrics registry: counters, gauges, histograms under shared names.

Replaces the scattered per-backend ``stats`` dicts as the source of truth:
every serving layer emits into a :class:`MetricsRegistry` and its protocol
``stats()`` becomes a *view* over the registry.  The cross-backend metric
names live in :data:`CATALOG`; :meth:`MetricsRegistry.standard`
pre-registers the whole catalog so the metric-name *set* is identical
across backends by construction — a backend that never preempts still
reports ``preemptions == 0`` instead of omitting the name, which is what
lets one dashboard / one test read real, DES and fluid runs side by side.

Histogram percentiles are exact nearest-rank over the raw observations
(rank = ceil(q/100·n) clamped to [1, n]) — the same rounding as
``serving.scheduler.latency_percentile``, kept in sync by a test, so a
registry histogram reproduces the engine's legacy percentile numbers
bit-for-bit.
"""
from __future__ import annotations

import math
from typing import Dict, Iterable, Iterator, List, Mapping, Optional, Set, \
    Tuple

__all__ = ["CATALOG", "CORE_METRICS", "Counter", "Gauge", "Histogram",
           "LABEL_KEYS", "MetricsRegistry", "nearest_rank_percentile"]

# the canonical label schema (re-exported by ``obs/aggregate.py``, where the
# reference keeps it): every labeled child series and every registry-level constant label uses
# keys from this set
LABEL_KEYS = ("region", "slo_class", "kv_layout", "phase", "role")


def nearest_rank_percentile(values: List[float], q: float) -> float:
    """Exact nearest-rank percentile (ceil(q/100·n), clamped to [1, n])."""
    if not values:
        return 0.0
    s = sorted(values)
    rank = math.ceil(q / 100.0 * len(s))
    return s[min(max(rank, 1), len(s)) - 1]


class Counter:
    """Monotonically increasing count (requests, joules, tokens, ...)."""

    __slots__ = ("name", "value")
    kind = "counter"

    def __init__(self, name: str):
        self.name = name
        self.value = 0.0

    def inc(self, amount: float = 1.0) -> None:
        assert amount >= 0, f"counter {self.name} decremented by {amount}"
        self.value += amount


class Gauge:
    """Last-written value plus its observed peak (occupancy, backlog, ...)."""

    __slots__ = ("name", "value", "peak")
    kind = "gauge"

    def __init__(self, name: str):
        self.name = name
        self.value = 0.0
        self.peak = 0.0

    def set(self, value: float) -> None:
        self.value = float(value)
        self.peak = max(self.peak, self.value)


class Histogram:
    """Raw-sample histogram with exact nearest-rank percentiles.

    Keeps every observation (serving sessions are bounded — tens to tens of
    thousands of samples); ``percentile`` is exact, not a bucket
    approximation, because the SLA numbers the paper reports are tail
    quantiles and bucketing error lands exactly there."""

    __slots__ = ("name", "samples")
    kind = "histogram"

    def __init__(self, name: str):
        self.name = name
        self.samples: List[float] = []

    def observe(self, value: float) -> None:
        self.samples.append(float(value))

    @property
    def count(self) -> int:
        return len(self.samples)

    @property
    def sum(self) -> float:
        return float(sum(self.samples))

    @property
    def mean(self) -> float:
        return self.sum / self.count if self.samples else 0.0

    def percentile(self, q: float) -> float:
        return nearest_rank_percentile(self.samples, q)


# =============================================================================
# shared metric-name catalog
# =============================================================================
# The cross-backend contract: every serving backend (real slotted, real
# paged, DES, fluid) and the fleet's per-region telemetry report under
# exactly these names.  Extending the serving layer means extending this
# table — tests assert the emitted name set equals the catalog.
CATALOG: Dict[str, str] = {
    # request flow
    "requests_submitted": "counter",
    "requests_served": "counter",
    "tokens_generated": "counter",
    "deadline_misses": "counter",
    "preemptions": "counter",
    "holds_released": "counter",    # requests a policy held then released
    # energy / carbon attribution
    "energy_j": "counter",
    "carbon_g": "counter",
    # latency distributions (seconds)
    "latency_s": "histogram",
    "queue_delay_s": "histogram",
    "ttft_s": "histogram",
    "held_s": "histogram",          # policy-hold portion of the queue delay
    "accuracy": "histogram",        # per-request serving-variant accuracy
    # engine internals (zero on analytic backends — the names still exist)
    "decode_steps": "counter",
    "decode_dispatches": "counter",  # decode dispatches (fused: 1 per k steps)
    # host↔device traffic of the decode hot path.  ``h2d_transfers`` counts
    # host→device uploads of loop state (event-driven only: steady-state
    # pipelined decode must add ZERO per tick — the regression gate of the
    # device-resident loop).  ``host_syncs`` counts *non-overlapped* blocking
    # device round-trips: a same-tick readback (slotted per-step argmax,
    # forced pipeline flushes); a landing that had a full tick of lookahead
    # overlap is not a sync.
    "host_syncs": "counter",
    "h2d_transfers": "counter",
    "prefill_chunks": "counter",
    "prefix_hit_tokens": "counter",
    "swapin_pages_copied": "counter",
    "swapin_pages_saved": "counter",
    # prefill→decode disaggregation (serving.disagg): sequences handed off
    # and the filled KV pages that moved with them (zero on monolithic and
    # analytic backends — the names still exist)
    "handoffs": "counter",
    "handoff_pages": "counter",
    "compile_retraces": "counter",  # post-warmup shape misses
    "blocks_in_use": "gauge",       # .peak = blocks_peak
    "occupied_rows": "gauge",
    # phase-level profiling (labeled by ``phase``: prefill_chunk /
    # decode_dispatch / decode_land / swap_d2h / swap_h2d — see obs.profile)
    "phase_latency_s": "histogram",
    # session
    "wall_s": "gauge",
}

# the subset every backend genuinely measures (used by parity tests to
# assert the values — not just the names — were filled in)
CORE_METRICS = ("requests_submitted", "requests_served", "energy_j",
                "carbon_g", "latency_s", "queue_delay_s", "wall_s")


class MetricsRegistry:
    """Named metrics under one roof; get-or-create with kind checking.

    ``labels`` are constant labels stamped on the registry itself (e.g. a
    fleet region's ``{"region": "CA"}`` or an engine session's
    ``{"kv_layout": "paged"}``) — the exporter merges them into every
    exposed sample.  :meth:`labeled` fans a CATALOG metric out into child
    series keyed by label values (``slo_class``, ``phase``, ...); children
    live in a separate table so :meth:`names` — the cross-backend parity
    contract — still returns exactly the unlabeled catalog.

    ``streaming=True`` swaps histograms for bounded-memory mergeable
    :class:`~repro_torch.obs.aggregate.StreamingHistogram` instances (exact
    below ``max_raw_samples`` observations, log-bucket sketch above) —
    the fleet-rollup configuration.
    """

    def __init__(self, backend: str = "backend",
                 labels: Optional[Mapping[str, str]] = None,
                 streaming: bool = False, max_raw_samples: int = 4096,
                 alpha: float = 0.01):
        self.backend = backend
        self.labels: Dict[str, str] = dict(labels or {})
        self.streaming = streaming
        self.max_raw_samples = max_raw_samples
        self.alpha = alpha
        self._metrics: Dict[str, object] = {}
        # (name, ((k, v), ...)) → child metric; kept out of _metrics so
        # names() stays exactly the catalog
        self._labeled: Dict[Tuple[str, Tuple[Tuple[str, str], ...]],
                            object] = {}

    @classmethod
    def standard(cls, backend: str = "backend",
                 labels: Optional[Mapping[str, str]] = None,
                 streaming: bool = False, max_raw_samples: int = 4096,
                 alpha: float = 0.01) -> "MetricsRegistry":
        """A registry with the whole :data:`CATALOG` pre-registered — the
        constructor every serving backend uses, so metric-name sets are
        identical across backends by construction."""
        reg = cls(backend, labels=labels, streaming=streaming,
                  max_raw_samples=max_raw_samples, alpha=alpha)
        for name, kind in CATALOG.items():
            reg._register(name, kind)
        return reg

    # --- get-or-create -------------------------------------------------------
    def _make(self, name: str, kind: str):
        if kind == "histogram" and self.streaming:
            from repro_torch.obs.aggregate import StreamingHistogram
            return StreamingHistogram(name, max_raw=self.max_raw_samples,
                                      alpha=self.alpha)
        ctor = {"counter": Counter, "gauge": Gauge,
                "histogram": Histogram}[kind]
        return ctor(name)

    def _register(self, name: str, kind: str):
        m = self._metrics.get(name)
        if m is not None:
            assert m.kind == kind, \
                f"metric {name!r} is a {m.kind}, requested as {kind}"
            return m
        m = self._make(name, kind)
        self._metrics[name] = m
        return m

    def labeled(self, name: str, **labels: str):
        """Child series of CATALOG metric ``name`` for the given labels
        (e.g. ``reg.labeled("ttft_s", slo_class="interactive")``).  Same
        kind as the parent; label keys must come from the canonical schema
        (:data:`LABEL_KEYS`)."""
        assert labels, f"labeled({name!r}) called without labels"
        for k in labels:
            assert k in LABEL_KEYS, \
                f"unknown label key {k!r} (schema: {LABEL_KEYS})"
        parent = self._metrics.get(name)
        assert parent is not None, f"no CATALOG metric {name!r} registered"
        key = (name, tuple(sorted((k, str(v)) for k, v in labels.items())))
        m = self._labeled.get(key)
        if m is None:
            m = self._make(name, parent.kind)
            self._labeled[key] = m
        return m

    def labeled_series(self, name: Optional[str] = None
                       ) -> Iterator[Tuple[str, Dict[str, str], object]]:
        """Yield ``(name, labels, metric)`` for every labeled child
        (optionally restricted to one metric name), in insertion order."""
        for (n, lk), m in self._labeled.items():
            if name is None or n == name:
                yield n, dict(lk), m

    def counter(self, name: str) -> Counter:
        return self._register(name, "counter")

    def gauge(self, name: str) -> Gauge:
        return self._register(name, "gauge")

    def histogram(self, name: str) -> Histogram:
        return self._register(name, "histogram")

    # --- introspection -------------------------------------------------------
    def names(self) -> Set[str]:
        return set(self._metrics)

    def __contains__(self, name: str) -> bool:
        return name in self._metrics

    def get(self, name: str):
        return self._metrics.get(name)

    def value(self, name: str) -> float:
        """Scalar value of a counter/gauge (histograms: use the object)."""
        m = self._metrics[name]
        assert m.kind != "histogram", f"{name} is a histogram"
        return m.value

    def snapshot(self, percentiles: Iterable[float] = (50.0, 95.0, 99.0)
                 ) -> Dict[str, float]:
        """Flat scalar view: counters/gauges by name (gauges also emit
        ``<name>_peak``), histograms expanded to ``<name>_pNN`` +
        ``<name>_count`` / ``<name>_mean``."""
        out: Dict[str, float] = {}
        for name, m in sorted(self._metrics.items()):
            if m.kind == "histogram":
                out[f"{name}_count"] = float(m.count)
                out[f"{name}_mean"] = m.mean
                for q in percentiles:
                    out[f"{name}_p{q:g}"] = m.percentile(q)
            elif m.kind == "gauge":
                out[name] = m.value
                out[f"{name}_peak"] = m.peak
            else:
                out[name] = m.value
        return out
