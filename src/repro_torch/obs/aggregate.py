"""Fleet-scope aggregation: labeled series, streaming histograms, rollups —
the port's copy of the reference package's ``obs/aggregate.py``.

Every backend reports under one metric catalog; this module is the layer
that makes those registries legible at FLEET scale:

  * **labels** — the canonical label schema (:data:`LABEL_KEYS`:
    ``region`` / ``slo_class`` / ``kv_layout`` / ``phase``).  A registry
    carries constant labels (e.g. its region) and any CATALOG metric can
    fan out labeled child series via ``MetricsRegistry.labeled``; the
    metric-NAME set stays exactly the CATALOG, so the cross-backend parity
    contract is untouched;
  * :class:`StreamingHistogram` — a bounded-memory, *mergeable* histogram
    behind the exact ``Histogram`` API.  Below ``max_raw`` observations it
    IS the exact histogram (raw samples, nearest-rank percentiles —
    bit-identical to :class:`~repro_torch.obs.metrics.Histogram`); past that it
    spills into log-spaced buckets with relative accuracy ``alpha``
    (DDSketch-style), so a 10^6-request replay costs a few thousand ints
    instead of a million floats.  ``count``/``sum``/``mean`` stay exact in
    both modes — that is what makes rollup conservation bit-exact;
  * :class:`FleetRollup` — merges per-region registries into one
    fleet-scope registry: counters and gauges sum in region-insertion
    order (so ``sum(per-region) == fleet`` holds bit-exactly, not merely
    to a tolerance), histograms merge (exact concat while small, sketch
    merge at scale), and every per-region scalar survives as a
    ``region``-labeled child series for the exporter.

Stdlib + numpy only, like the rest of ``repro_torch.obs``.
"""
from __future__ import annotations

import math
from typing import Dict, Iterable, List, Optional, Tuple

import numpy as np

from repro_torch.obs.metrics import LABEL_KEYS, Histogram, \
    MetricsRegistry, nearest_rank_percentile

__all__ = ["LABEL_KEYS", "StreamingHistogram", "FleetRollup",
           "check_conservation"]


class StreamingHistogram(Histogram):
    """Bounded-memory mergeable histogram behind the ``Histogram`` API.

    Exact mode (n ≤ ``max_raw``): raw samples, nearest-rank percentiles —
    indistinguishable from the exact histogram, which is what the small-n
    parity test pins.  Spilled mode: log-spaced buckets at relative
    accuracy ``alpha`` (bucket i covers (γ^(i-1), γ^i] with
    γ = (1+α)/(1−α); a quantile estimate is off by at most α of the true
    value).  Bucket keys are clamped to ±``_KEY_LIM``, so memory is
    bounded by construction regardless of the sample count or dynamic
    range.  ``count``/``sum``/``mean`` are exact in both modes.

    Merging (:meth:`merge`) accepts exact histograms and streaming
    histograms of the same ``alpha``: counts/sums add exactly; sample
    stores concatenate while both sides are small and bucket-add once
    either side spilled — the operation :class:`FleetRollup` is built on.
    """

    __slots__ = ("max_raw", "alpha", "_gamma", "_lg", "_raw", "_count",
                 "_sum", "_spilled", "_buckets")
    kind = "histogram"

    _KEY_LIM = 2400          # |key| bound ≈ values in [1e-21, 1e21] at α=1%
    _EPS = 1e-300            # below this magnitude a value is "zero"

    def __init__(self, name: str, max_raw: int = 4096, alpha: float = 0.01):
        assert max_raw >= 1 and 0.0 < alpha < 1.0
        self.name = name
        self.max_raw = int(max_raw)
        self.alpha = float(alpha)
        self._gamma = (1.0 + alpha) / (1.0 - alpha)
        self._lg = math.log(self._gamma)
        self._raw: List[float] = []
        self._count = 0
        self._sum = 0.0
        self._spilled = False
        # (sign, idx) → count; sign 0 is the zero bucket (idx ignored)
        self._buckets: Dict[Tuple[int, int], int] = {}

    # --- the exact-Histogram surface -----------------------------------------
    @property
    def samples(self) -> List[float]:
        """Raw observations while in exact mode (empty once spilled —
        boundedness is the whole point)."""
        return self._raw

    @property
    def spilled(self) -> bool:
        return self._spilled

    @property
    def n_buckets(self) -> int:
        return len(self._buckets)

    def observe(self, value: float) -> None:
        v = float(value)
        self._count += 1
        self._sum += v
        if not self._spilled:
            self._raw.append(v)
            if len(self._raw) > self.max_raw:
                self._spill()
        else:
            k = self._key(v)
            self._buckets[k] = self._buckets.get(k, 0) + 1

    def observe_many(self, values) -> None:
        """Vectorized bulk ingest (the 10^6-scale replay path): one numpy
        pass for the count/sum and the bucket keys instead of a million
        Python-level ``observe`` calls."""
        arr = np.asarray(values, np.float64).reshape(-1)
        if arr.size == 0:
            return
        self._count += int(arr.size)
        self._sum += float(arr.sum())
        if not self._spilled and len(self._raw) + arr.size <= self.max_raw:
            self._raw.extend(float(v) for v in arr)
            return
        if not self._spilled:
            self._spill()
        mag = np.abs(arr)
        nz = mag > self._EPS
        zero_n = int((~nz).sum())
        if zero_n:
            k0 = (0, 0)
            self._buckets[k0] = self._buckets.get(k0, 0) + zero_n
        if nz.any():
            idx = np.ceil(np.log(mag[nz]) / self._lg).astype(np.int64)
            np.clip(idx, -self._KEY_LIM, self._KEY_LIM, out=idx)
            sign = np.where(arr[nz] > 0.0, 1, -1)
            keys, counts = np.unique(
                np.stack([sign, idx], axis=1), axis=0, return_counts=True)
            for (s, i), c in zip(keys.tolist(), counts.tolist()):
                k = (int(s), int(i))
                self._buckets[k] = self._buckets.get(k, 0) + int(c)

    @property
    def count(self) -> int:
        return self._count

    @property
    def sum(self) -> float:
        return self._sum

    @property
    def mean(self) -> float:
        return self._sum / self._count if self._count else 0.0

    def percentile(self, q: float) -> float:
        if not self._spilled:
            return nearest_rank_percentile(self._raw, q)
        if self._count == 0:
            return 0.0
        rank = min(max(math.ceil(q / 100.0 * self._count), 1), self._count)
        seen = 0
        for key in sorted(self._buckets, key=self._bucket_value):
            seen += self._buckets[key]
            if seen >= rank:
                return self._bucket_value(key)
        return self._bucket_value(max(self._buckets,
                                      key=self._bucket_value))

    # --- merge (the rollup primitive) ----------------------------------------
    def merge(self, other: Histogram) -> None:
        """Fold ``other`` (exact or streaming) into this histogram.
        Counts and sums add exactly; sample state concatenates while both
        sides fit ``max_raw`` and buckets add otherwise."""
        if isinstance(other, StreamingHistogram):
            assert other.alpha == self.alpha, \
                f"merging α={other.alpha} sketch into α={self.alpha}"
            self._count += other._count
            self._sum += other._sum
            if not other._spilled:
                self._absorb_raw(other._raw)
            else:
                if not self._spilled:
                    self._spill()
                for k, c in other._buckets.items():
                    self._buckets[k] = self._buckets.get(k, 0) + c
        else:
            self._count += other.count
            self._sum += other.sum
            self._absorb_raw(other.samples)

    def _absorb_raw(self, samples: Iterable[float]) -> None:
        samples = list(samples)
        if not self._spilled and len(self._raw) + len(samples) <= self.max_raw:
            self._raw.extend(samples)
            return
        if not self._spilled:
            self._spill()
        for v in samples:
            k = self._key(v)
            self._buckets[k] = self._buckets.get(k, 0) + 1

    # --- internals -----------------------------------------------------------
    def _key(self, v: float) -> Tuple[int, int]:
        mag = abs(v)
        if mag <= self._EPS:
            return (0, 0)
        idx = math.ceil(math.log(mag) / self._lg)
        idx = min(max(idx, -self._KEY_LIM), self._KEY_LIM)
        return (1 if v > 0.0 else -1, idx)

    def _bucket_value(self, key: Tuple[int, int]) -> float:
        """Representative value of a bucket: the geometric midpoint
        2γ^i/(γ+1) of (γ^(i-1), γ^i], which bounds relative error by α."""
        sign, idx = key
        if sign == 0:
            return 0.0
        return sign * 2.0 * self._gamma ** idx / (self._gamma + 1.0)

    def _spill(self) -> None:
        raw, self._raw = self._raw, []
        self._spilled = True
        for v in raw:
            k = self._key(v)
            self._buckets[k] = self._buckets.get(k, 0) + 1


# =============================================================================
# fleet rollup
# =============================================================================
class FleetRollup:
    """Merge per-region :class:`MetricsRegistry` instances to fleet scope.

    ``add`` registers a region's registry (region name from its ``region``
    constant label, falling back to its backend name); :meth:`merged`
    builds the fleet registry:

      * counters: fleet value accumulates region values in insertion
        order — exactly the order :func:`check_conservation` sums them in,
        so conservation is an ``==``, not an approx;
      * gauges: fleet value/peak are the sums of region values/peaks (a
        fleet's blocks-in-use is the sum over regions);
      * histograms: merged via :class:`StreamingHistogram` (exact concat
        while small, sketch merge at 10^6 scale) — count/sum stay exact;
      * every region scalar also lands as a ``region``-labeled child on
        the fleet registry, and the regions' own labeled children are
        re-labeled with their region, so one OpenMetrics scrape of the
        rollup shows fleet totals AND the per-region breakdown.
    """

    def __init__(self, name: str = "fleet", streaming: bool = True,
                 max_raw: int = 4096, alpha: float = 0.01):
        self.name = name
        self.streaming = streaming
        self.max_raw = max_raw
        self.alpha = alpha
        self.regions: Dict[str, MetricsRegistry] = {}
        self._merged: Optional[MetricsRegistry] = None

    def add(self, registry: MetricsRegistry,
            region: Optional[str] = None) -> None:
        region = (region or registry.labels.get("region")
                  or registry.backend)
        assert region not in self.regions, f"duplicate region {region!r}"
        self.regions[region] = registry
        self._merged = None

    def merged(self) -> MetricsRegistry:
        """The fleet-scope registry (rebuilt lazily after ``add``)."""
        if self._merged is not None:
            return self._merged
        out = MetricsRegistry.standard(self.name, streaming=self.streaming,
                                       max_raw_samples=self.max_raw,
                                       alpha=self.alpha)
        for region, reg in self.regions.items():
            for name in sorted(reg.names()):
                m = reg.get(name)
                if m.kind == "counter":
                    out.counter(name).inc(m.value)
                    out.labeled(name, region=region).inc(m.value)
                elif m.kind == "gauge":
                    g = out.gauge(name)
                    g.value += m.value
                    g.peak += m.peak
                    child = out.labeled(name, region=region)
                    child.value += m.value
                    child.peak += m.peak
                else:
                    tgt = out.histogram(name)
                    if isinstance(tgt, StreamingHistogram):
                        tgt.merge(m)
                    else:
                        tgt.samples.extend(m.samples)
            for name, labels, m in reg.labeled_series():
                labels = {"region": region, **labels}
                child = out.labeled(name, **labels)
                if m.kind == "counter":
                    child.inc(m.value)
                elif m.kind == "gauge":
                    child.value += m.value
                    child.peak += m.peak
                elif isinstance(child, StreamingHistogram):
                    child.merge(m)
                else:
                    child.samples.extend(m.samples)
        self._merged = out
        return out

    def conservation(self, names: Tuple[str, ...] = ("energy_j", "carbon_g")
                     ) -> Dict[str, float]:
        """Assert bit-exact conservation for the given counters and return
        the fleet totals.  ``sum`` walks regions in the same insertion
        order ``merged`` accumulated them, so the comparison is ``==``."""
        return check_conservation(self, names)


def check_conservation(rollup: FleetRollup,
                       names: Tuple[str, ...] = ("energy_j", "carbon_g")
                       ) -> Dict[str, float]:
    """Bit-exact conservation check: for each counter in ``names``, the
    region values summed in insertion order must equal the fleet total
    EXACTLY (same float additions in the same order — any mismatch means
    a region was double-counted or dropped, not rounding)."""
    fleet = rollup.merged()
    out: Dict[str, float] = {}
    for name in names:
        expect = 0.0
        for reg in rollup.regions.values():
            expect += reg.counter(name).value
        got = fleet.counter(name).value
        assert got == expect, \
            f"rollup conservation broken for {name!r}: fleet {got!r} != " \
            f"sum over {len(rollup.regions)} regions {expect!r}"
        # every histogram's count/sum is exact in both modes, so totals of
        # merged distributions conserve too
        out[name] = got
    return out
