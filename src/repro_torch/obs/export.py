"""OpenMetrics exposition + periodic JSON snapshots for registries/rollups
— the port's copy of the reference package's ``obs/export.py`` (the
family names keep the reference's ``repro_`` prefix, so the two
expositions are equal text).

One renderer, one parser, one invariant: ``render(parse(render(x))) ==
render(x)``.  The text format is the OpenMetrics/Prometheus subset a real
scraper understands —

  * every family gets ``# HELP`` and ``# TYPE`` lines, names prefixed
    ``repro_``; counters expose as ``<name>_total`` per the OpenMetrics
    counter convention;
  * gauges expose their value, with the observed peak as a separate
    ``<name>_peak`` gauge family (a peak is not a sample of the gauge);
  * histograms expose as OpenMetrics *summaries*: one ``quantile``-labeled
    sample per exposed percentile plus ``_count``/``_sum`` — quantiles
    because the registry's nearest-rank percentiles are exact, so shipping
    fixed buckets would only add quantization error;
  * registry constant labels (region/kv_layout/...) merge into every
    sample; labeled child series render as additional samples of the same
    family.  Labels are sorted by key (``quantile`` forced last), values
    via ``repr(float)`` so floats round-trip exactly;
  * the exposition ends with ``# EOF`` (the OpenMetrics framing marker).

Round-trip identity is by construction, not by effort: both
:func:`to_openmetrics` and re-export of a parsed exposition funnel through
the same ``_render`` over the same ordered family structure.

:class:`SnapshotWriter` is the pull-less alternative: appends the
registry's flat ``snapshot()`` dict to a JSONL file at a fixed cadence —
the scrape-by-file mode for long runs.
"""
from __future__ import annotations

import json
import os
from typing import Dict, List, Optional, Tuple

from repro_torch.obs.metrics import MetricsRegistry

__all__ = ["PREFIX", "QUANTILES", "to_openmetrics", "parse_openmetrics",
           "render_families", "SnapshotWriter"]

PREFIX = "repro_"
QUANTILES = (0.5, 0.95, 0.99)

# family structure: name → {"type": str, "help": str,
#                           "samples": [(sample_name, labels, value_str)]}
# kept insertion-ordered; this is what _render consumes and parse rebuilds.


def _fmt(value: float) -> str:
    """Exact float→text: repr() round-trips any finite float."""
    return repr(float(value))


def _label_str(labels: List[Tuple[str, str]]) -> str:
    if not labels:
        return ""
    # sort by key, quantile last — stable ordering makes re-export identical
    ordered = sorted(labels, key=lambda kv: (kv[0] == "quantile", kv[0]))
    body = ",".join(f'{k}="{v}"' for k, v in ordered)
    return "{" + body + "}"


def _collect(reg: MetricsRegistry) -> Dict[str, dict]:
    """Build the ordered family structure from a registry (or a rollup —
    anything with ``merged()`` collapses to its fleet registry first)."""
    if hasattr(reg, "merged"):
        reg = reg.merged()
    const = sorted(reg.labels.items())
    families: Dict[str, dict] = {}

    def fam(name: str, mtype: str, help_: str) -> dict:
        f = families.get(name)
        if f is None:
            f = {"type": mtype, "help": help_, "samples": []}
            families[name] = f
        return f

    def emit(m, labels: List[Tuple[str, str]]) -> None:
        base = PREFIX + m.name
        lbl = list(const) + labels
        if m.kind == "counter":
            f = fam(base, "counter", f"{m.name} (counter)")
            f["samples"].append((base + "_total", list(lbl), _fmt(m.value)))
        elif m.kind == "gauge":
            f = fam(base, "gauge", f"{m.name} (gauge)")
            f["samples"].append((base, list(lbl), _fmt(m.value)))
            fp = fam(base + "_peak", "gauge", f"{m.name} observed peak")
            fp["samples"].append((base + "_peak", list(lbl), _fmt(m.peak)))
        else:
            f = fam(base, "summary", f"{m.name} (summary)")
            for q in QUANTILES:
                f["samples"].append(
                    (base, list(lbl) + [("quantile", _fmt(q))],
                     _fmt(m.percentile(q * 100.0))))
            f["samples"].append((base + "_count", list(lbl),
                                 _fmt(float(m.count))))
            f["samples"].append((base + "_sum", list(lbl), _fmt(m.sum)))

    for name in sorted(reg.names()):
        emit(reg.get(name), [])
    # labeled children group under the same family as their parent; sort
    # for a deterministic exposition regardless of observation order
    children = sorted(reg.labeled_series(),
                      key=lambda t: (t[0], sorted(t[1].items())))
    for name, labels, m in children:
        emit(m, sorted(labels.items()))
    return families


def render_families(families: Dict[str, dict]) -> str:
    lines: List[str] = []
    for name, f in families.items():
        lines.append(f"# HELP {name} {f['help']}")
        lines.append(f"# TYPE {name} {f['type']}")
        for sname, labels, value in f["samples"]:
            lines.append(f"{sname}{_label_str(labels)} {value}")
    lines.append("# EOF")
    return "\n".join(lines) + "\n"


def to_openmetrics(reg: MetricsRegistry) -> str:
    """OpenMetrics text exposition of a registry or fleet rollup."""
    return render_families(_collect(reg))


def parse_openmetrics(text: str) -> Dict[str, dict]:
    """Parse an exposition back into the ordered family structure (so
    ``render_families(parse_openmetrics(t)) == t``).  Strict about the
    subset this module emits: unknown line shapes raise."""
    families: Dict[str, dict] = {}
    cur: Optional[str] = None
    saw_eof = False
    for line in text.splitlines():
        if not line:
            continue
        assert not saw_eof, "sample after # EOF"
        if line.startswith("# HELP "):
            name, help_ = line[len("# HELP "):].split(" ", 1)
            families[name] = {"type": "untyped", "help": help_,
                              "samples": []}
            cur = name
        elif line.startswith("# TYPE "):
            name, mtype = line[len("# TYPE "):].split(" ", 1)
            assert name == cur, f"TYPE {name} without preceding HELP"
            families[name]["type"] = mtype
        elif line == "# EOF":
            saw_eof = True
        else:
            sname, labels, value = _parse_sample(line)
            # a sample belongs to the family whose name prefixes it
            # (handles _total/_count/_sum/_peak suffixes)
            fname = _family_of(sname, families)
            families[fname]["samples"].append((sname, labels, value))
    assert saw_eof, "exposition missing # EOF"
    return families


def _family_of(sample_name: str, families: Dict[str, dict]) -> str:
    if sample_name in families:
        return sample_name
    for suffix in ("_total", "_count", "_sum"):
        if sample_name.endswith(suffix):
            base = sample_name[: -len(suffix)]
            if base in families:
                return base
    raise AssertionError(f"sample {sample_name!r} matches no family")


def _parse_sample(line: str) -> Tuple[str, List[Tuple[str, str]], str]:
    if "{" in line:
        name, rest = line.split("{", 1)
        body, tail = rest.rsplit("}", 1)
        labels = []
        for part in body.split(","):
            k, v = part.split("=", 1)
            assert v.startswith('"') and v.endswith('"'), \
                f"unquoted label value in {line!r}"
            labels.append((k, v[1:-1]))
        return name, labels, tail.strip()
    name, value = line.rsplit(" ", 1)
    return name.strip(), [], value


class SnapshotWriter:
    """Periodic JSONL snapshots of a registry — the file-based 'scrape'.

    ``maybe_write(t, reg)`` appends one line at most every ``interval_s``
    of *sim/session* time; ``write`` forces one (e.g. at drain).  Each
    line is ``{"t", "backend", "labels", "metrics": reg.snapshot()}``.
    """

    def __init__(self, path: str, interval_s: float = 60.0):
        self.path = path
        self.interval_s = float(interval_s)
        self.last_t: Optional[float] = None
        self.writes = 0

    def maybe_write(self, t: float, reg: MetricsRegistry) -> bool:
        if self.last_t is not None and t - self.last_t < self.interval_s:
            return False
        self.write(t, reg)
        return True

    def write(self, t: float, reg: MetricsRegistry) -> None:
        if hasattr(reg, "merged"):
            reg = reg.merged()
        rec = {"t": float(t), "backend": reg.backend,
               "labels": dict(reg.labels), "metrics": reg.snapshot()}
        d = os.path.dirname(self.path)
        if d:
            os.makedirs(d, exist_ok=True)
        with open(self.path, "a", encoding="utf-8") as fh:
            fh.write(json.dumps(rec) + "\n")
        self.last_t = float(t)
        self.writes += 1
