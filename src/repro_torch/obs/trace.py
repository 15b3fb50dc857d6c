"""Request-lifecycle tracing: a low-overhead span/event recorder (a copy
of the reference package's ``obs/trace.py``).

One :class:`TraceRecorder` captures a serving backend's whole request
lifecycle — arrival → hold/release (policy decision + reason) → admission →
chunked-prefill chunks → decode ticks (batched: ONE event per tick carrying
the occupant set) → preempt / swap-out / partial swap-in → completion — and
exports it two ways:

  * **JSONL** (:meth:`TraceRecorder.to_jsonl`): one record per line, the
    machine-readable schema tests and offline analysis consume;
  * **Chrome-trace JSON** (:meth:`TraceRecorder.to_chrome_trace`): a
    ``{"traceEvents": [...]}`` object loadable in Perfetto
    (https://ui.perfetto.dev) — every request renders as its own track
    (tid = rid), the engine's tick/counter stream renders on track 0, and
    span args carry the request's attributed joules/gCO2, so the trace is a
    visual audit of the carbon attribution.

Record schema (JSONL; all times are backend-clock seconds, session-relative):

  span     {"kind": "span", "name": str, "rid": int|null,
            "t0": float, "t1": float, "args": {...}}
  instant  {"kind": "instant", "name": str, "rid": int|null,
            "t": float, "args": {...}}
  counter  {"kind": "counter", "name": str, "t": float, "value": float}

The **conservation invariant** (:func:`validate_trace`): every span opened
is closed, and the ``energy_j`` attributed across ``request`` spans sums to
the engine's session total exactly — an unclosed span or a joule that
appears in the engine total but in no request's span tree is an attribution
bug, not a rendering artifact.
"""
from __future__ import annotations

import json
from typing import Dict, List, Optional

__all__ = ["TraceRecorder", "validate_trace", "validate_chrome_events"]

_US = 1e6     # seconds → Chrome-trace microseconds


def _json_default(o):
    """numpy scalars/arrays → plain JSON (the recorder never imports numpy;
    callers may still pass its scalars through span args)."""
    if hasattr(o, "item"):
        return o.item()
    if hasattr(o, "tolist"):
        return o.tolist()
    raise TypeError(f"not JSON serializable: {type(o).__name__}")


class TraceRecorder:
    """Append-only span/event log for one backend.

    Overhead discipline: recording is a dict append — no I/O, no
    serialization, no clock reads (callers pass their own timestamps, so
    the recorder works identically on the real engine's wall clock and the
    DES's simulated clock).  Export and validation walk the log after the
    session.  Persistent across serve sessions: a fleet probe loop reuses
    one recorder and the traces concatenate."""

    def __init__(self, backend: str = "backend"):
        self.backend = backend
        self.records: List[dict] = []
        self._open: Dict[int, dict] = {}     # sid → record still open

    # --- recording -----------------------------------------------------------
    def open_span(self, name: str, t: float, rid: Optional[int] = None,
                  **args) -> int:
        rec = {"kind": "span", "name": name, "rid": rid,
               "t0": float(t), "t1": None, "args": args}
        sid = len(self.records)
        self.records.append(rec)
        self._open[sid] = rec
        return sid

    def close_span(self, sid: int, t: float, **args) -> None:
        rec = self._open.pop(sid)
        rec["t1"] = float(t)
        if args:
            rec["args"].update(args)

    def span(self, name: str, t0: float, t1: float,
             rid: Optional[int] = None, **args) -> int:
        """Record an already-closed span (e.g. a policy hold reconstructed
        at completion from the policy's hold log)."""
        sid = self.open_span(name, t0, rid, **args)
        self.close_span(sid, t1)
        return sid

    def instant(self, name: str, t: float, rid: Optional[int] = None,
                **args) -> None:
        self.records.append({"kind": "instant", "name": name, "rid": rid,
                             "t": float(t), "args": args})

    def counter(self, name: str, t: float, value: float) -> None:
        self.records.append({"kind": "counter", "name": name,
                             "t": float(t), "value": float(value)})

    def annotate(self, sid: int, **args) -> None:
        """Attach args to a span after the fact — how the engine writes the
        finalized per-request joules/gCO2 onto request spans that closed at
        completion time (the idle-floor share only exists at drain)."""
        self.records[sid]["args"].update(args)

    # --- introspection -------------------------------------------------------
    @property
    def open_spans(self) -> int:
        return len(self._open)

    def spans(self, name: Optional[str] = None) -> List[dict]:
        return [r for r in self.records if r["kind"] == "span"
                and (name is None or r["name"] == name)]

    def instants(self, name: Optional[str] = None) -> List[dict]:
        return [r for r in self.records if r["kind"] == "instant"
                and (name is None or r["name"] == name)]

    # --- export --------------------------------------------------------------
    def to_jsonl(self, path: str) -> None:
        with open(path, "w") as f:
            for rec in self.records:
                f.write(json.dumps(rec, default=_json_default) + "\n")

    def chrome_events(self) -> List[dict]:
        """Chrome-trace event list: spans → complete ("X") events, instants
        → thread-scoped "i", counters → "C".  One pid per recorder; request
        tracks keyed by rid (tid = rid + 1; tid 0 is the engine track)."""
        pid = 1
        ev: List[dict] = [
            {"ph": "M", "name": "process_name", "pid": pid, "tid": 0,
             "args": {"name": self.backend}},
            {"ph": "M", "name": "thread_name", "pid": pid, "tid": 0,
             "args": {"name": "engine"}},
        ]
        named_tids = set()
        for rec in self.records:
            rid = rec.get("rid")
            tid = 0 if rid is None else int(rid) + 1
            if rid is not None and tid not in named_tids:
                named_tids.add(tid)
                ev.append({"ph": "M", "name": "thread_name", "pid": pid,
                           "tid": tid, "args": {"name": f"req {rid}"}})
            if rec["kind"] == "span":
                t1 = rec["t1"] if rec["t1"] is not None else rec["t0"]
                ev.append({"ph": "X", "name": rec["name"], "pid": pid,
                           "tid": tid, "ts": rec["t0"] * _US,
                           "dur": max((t1 - rec["t0"]) * _US, 0.0),
                           "args": rec["args"]})
            elif rec["kind"] == "instant":
                ev.append({"ph": "i", "name": rec["name"], "pid": pid,
                           "tid": tid, "ts": rec["t"] * _US, "s": "t",
                           "args": rec["args"]})
            else:   # counter
                ev.append({"ph": "C", "name": rec["name"], "pid": pid,
                           "tid": 0, "ts": rec["t"] * _US,
                           "args": {"value": rec["value"]}})
        return ev

    def to_chrome_trace(self, path: str) -> None:
        with open(path, "w") as f:
            json.dump({"traceEvents": self.chrome_events(),
                       "displayTimeUnit": "ms"}, f, default=_json_default)


# =============================================================================
# validation — the instrumentation contract
# =============================================================================
def validate_trace(tr: TraceRecorder,
                   expect_energy_j: Optional[float] = None,
                   expect_requests: Optional[int] = None,
                   rel: float = 1e-9) -> Dict[str, float]:
    """Enforce the conservation invariant on a recorded trace.

    Checks (AssertionError on violation):
      1. every span opened was closed (no dangling lifecycle state);
      2. every ``request`` span carries an ``energy_j`` attribution;
      3. the span-attributed joules sum to ``expect_energy_j`` (the
         backend's session total) within ``rel`` — i.e. the trace accounts
         for every joule the engine charged, no more, no less;
      4. optional: the number of request spans matches ``expect_requests``.

    Returns a summary dict (spans, requests, attributed energy/carbon).
    """
    assert tr.open_spans == 0, \
        f"{tr.open_spans} span(s) never closed: " \
        f"{[r['name'] for r in tr._open.values()][:5]}"
    reqs = tr.spans("request")
    for r in reqs:
        assert r["t1"] is not None and r["t1"] >= r["t0"], \
            f"request {r['rid']} span has bad bounds"
        assert "energy_j" in r["args"], \
            f"request {r['rid']} span carries no energy attribution"
    total_j = sum(r["args"].get("energy_j", 0.0) for r in reqs)
    total_g = sum(r["args"].get("carbon_g", 0.0) for r in reqs)
    if expect_requests is not None:
        assert len(reqs) == expect_requests, \
            f"{len(reqs)} request spans != {expect_requests} served"
    if expect_energy_j is not None:
        tol = rel * max(abs(expect_energy_j), 1e-12)
        assert abs(total_j - expect_energy_j) <= tol, \
            f"span-attributed joules {total_j!r} != engine total " \
            f"{expect_energy_j!r} (conservation violated)"
    return {"spans": len(tr.spans()), "requests": len(reqs),
            "energy_j": total_j, "carbon_g": total_g,
            "records": len(tr.records)}


_REQUIRED = {"X": ("name", "ph", "ts", "dur", "pid", "tid"),
             "i": ("name", "ph", "ts", "pid", "tid"),
             "C": ("name", "ph", "ts", "pid", "args"),
             "M": ("name", "ph", "pid", "args")}


def validate_chrome_events(events: List[dict]) -> int:
    """Schema check for a Chrome-trace event list (what Perfetto's legacy
    JSON importer requires).  Returns the number of non-metadata events."""
    assert isinstance(events, list) and events, "empty trace"
    n = 0
    for e in events:
        ph = e.get("ph")
        assert ph in _REQUIRED, f"unknown phase {ph!r}"
        for key in _REQUIRED[ph]:
            assert key in e, f"{ph!r} event missing {key!r}: {e}"
        if ph != "M":
            n += 1
            assert isinstance(e["ts"], (int, float)) and e["ts"] >= 0, e
        if ph == "X":
            assert e["dur"] >= 0, e
    # the whole list must survive a JSON round-trip (Perfetto reads a file)
    json.loads(json.dumps(events, default=_json_default))
    return n
