"""Two-class fleet workload (fleet layer) — the port's copy of the
reference package's ``fleet/workload.py``.

The single-cluster simulator serves one Poisson stream under an SLA.  Real
inference fleets also carry delay-tolerant batch work — embedding backfills,
offline evals, nightly re-scoring — that has a *deadline*, not a tail-latency
target.  That second class is exactly the lever temporal shifting needs: its
execution window is wide enough to reach the next low-carbon valley.

  interactive  — rate ``interactive_rps``, served immediately, p95 ≤ SLA.
  deferrable   — ``DeferrableJob``s: ``work_req`` requests that may be served
                 any time in [arrival_s, deadline_s].
"""
from __future__ import annotations

import dataclasses
import random
from typing import List, Optional, Sequence

import numpy as np

from repro_torch.serving.api import DEFERRABLE, INTERACTIVE, InferenceRequest


@dataclasses.dataclass(frozen=True)
class DeferrableJob:
    job_id: str
    arrival_s: float               # earliest start
    work_req: float                # total requests to serve
    deadline_s: float              # all work done by here

    @property
    def slack_s(self) -> float:
        return self.deadline_s - self.arrival_s

    def feasible_in(self, t0: float, t1: float) -> bool:
        """May this job run (partially) inside window [t0, t1]?  Work placed
        in a window must finish by the deadline, so the window must end in
        time."""
        return t0 >= self.arrival_s and t1 <= self.deadline_s


@dataclasses.dataclass(frozen=True)
class FleetWorkload:
    interactive_rps: float         # fleet-wide interactive arrival rate
    jobs: Sequence[DeferrableJob]

    @property
    def deferrable_work(self) -> float:
        return sum(j.work_req for j in self.jobs)

    def total_work(self, duration_s: float) -> float:
        return self.interactive_rps * duration_s + self.deferrable_work


def make_workload(interactive_rps: float, duration_s: float,
                  deferrable_frac: float = 0.25, n_jobs: int = 12,
                  min_slack_s: float = 6 * 3600.0,
                  max_slack_s: float = 18 * 3600.0,
                  seed: int = 0) -> FleetWorkload:
    """Deferrable work totals ``deferrable_frac`` of the interactive volume,
    split into ``n_jobs`` jobs arriving through the first half of the horizon
    with uniform slack in [min_slack, max_slack] (clamped to the horizon).

    The last-arrival cap keeps every job at least ``min_slack_s`` of runway,
    so a feasible schedule exists whenever aggregate capacity does."""
    rng = random.Random(seed)
    total_deferrable = deferrable_frac * interactive_rps * duration_s
    latest_arrival = min(duration_s / 2.0, duration_s - min_slack_s)
    if latest_arrival < 0:
        raise ValueError("horizon shorter than min_slack_s")
    shares = [rng.uniform(0.5, 1.5) for _ in range(n_jobs)]
    scale = total_deferrable / sum(shares)
    jobs: List[DeferrableJob] = []
    for i, share in enumerate(shares):
        arrival = rng.uniform(0.0, latest_arrival)
        slack = rng.uniform(min_slack_s, max_slack_s)
        deadline = min(arrival + slack, duration_s)
        jobs.append(DeferrableJob(f"job{i:02d}", arrival, share * scale,
                                  deadline))
    return FleetWorkload(interactive_rps, tuple(jobs))


def request_stream(workload: FleetWorkload, duration_s: float, *,
                   vocab_size: int, prompt_lens: Sequence[int] = (6,),
                   n_new: int = 8, time_scale: float = 1.0,
                   max_interactive: Optional[int] = None,
                   requests_per_job: int = 2, seed: int = 0
                   ) -> List[InferenceRequest]:
    """Materialize the two-class fluid workload as typed
    :class:`~repro_torch.serving.api.InferenceRequest`s for the unified
    ``ServingBackend`` protocol — the bridge between the fleet's aggregate
    arithmetic (rates + deferrable jobs) and per-request backends (real
    engine, DES).

    Interactive requests arrive Poisson at ``interactive_rps`` (capped at
    ``max_interactive``) with priority 1; each deferrable job contributes
    ``requests_per_job`` requests at priority 0 carrying the job's deadline
    — exactly what EDF and the carbon-aware hold policy key on.
    ``time_scale`` compresses the fleet's hour-scale clock onto a backend's
    (e.g. 1/3600 turns a 2 h workload into a 2 s wall-clock demo); request
    ids are dense and unique across both classes."""
    rng = np.random.default_rng(seed)
    reqs: List[InferenceRequest] = []
    rid = 0
    n_int = int(workload.interactive_rps * duration_s)
    if max_interactive is not None:
        n_int = min(n_int, max_interactive)
    if n_int > 0:
        # Poisson arrivals conditioned on the count: uniform order stats
        arrivals = np.sort(rng.uniform(0.0, duration_s, size=n_int))
        for a in arrivals:
            reqs.append(InferenceRequest(
                rid=rid, prompt=rng.integers(
                    0, vocab_size,
                    size=int(prompt_lens[rid % len(prompt_lens)])
                ).astype(np.int32),
                max_new_tokens=n_new, slo=INTERACTIVE, priority=1,
                arrival_s=float(a) * time_scale))
            rid += 1
    for job in workload.jobs:
        for _ in range(requests_per_job):
            reqs.append(InferenceRequest(
                rid=rid, prompt=rng.integers(
                    0, vocab_size,
                    size=int(prompt_lens[rid % len(prompt_lens)])
                ).astype(np.int32),
                max_new_tokens=n_new, slo=DEFERRABLE, priority=0,
                arrival_s=float(job.arrival_s) * time_scale,
                deadline_s=float(job.deadline_s) * time_scale))
            rid += 1
    reqs.sort(key=lambda r: (r.arrival_s, r.rid))
    return reqs


# =============================================================================
# shaped load generators (CarbonShiftML-style diurnal shapes)
# =============================================================================
# Arrival densities over a normalized horizon x ∈ [0, 1].  A uniform draw is
# the "random" shape; "linear" ramps 0 → peak (a growing service); "peak" is
# one mid-horizon gaussian bump (a business-hours service); "camel" is two
# bumps at 0.25/0.75 (morning + evening commute).  All are sampled by
# inverse-CDF over a dense grid, so any n produces exactly-shaped arrivals
# and two seeds never collide in shape — only in jitter.
WORKLOAD_SHAPES = ("random", "linear", "peak", "camel")

_SHAPE_GRID = 512


def _shape_density(shape: str, x: np.ndarray) -> np.ndarray:
    if shape == "random":
        return np.ones_like(x)
    if shape == "linear":
        return 0.1 + 0.9 * x               # never fully silent at the start
    if shape == "peak":
        return 0.1 + np.exp(-0.5 * ((x - 0.5) / 0.12) ** 2)
    if shape == "camel":
        return (0.1 + np.exp(-0.5 * ((x - 0.25) / 0.08) ** 2)
                + np.exp(-0.5 * ((x - 0.75) / 0.08) ** 2))
    raise ValueError(f"unknown workload shape {shape!r} "
                     f"(have {WORKLOAD_SHAPES})")


def shaped_arrival_times(n: int, duration_s: float, shape: str = "random",
                         seed: int = 0) -> np.ndarray:
    """``n`` sorted arrival timestamps in [0, duration_s] following the
    named load shape (inverse-CDF sampling of the shape's density)."""
    assert n >= 0 and duration_s > 0.0
    if n == 0:
        return np.zeros((0,), np.float64)
    rng = np.random.default_rng(seed)
    x = np.linspace(0.0, 1.0, _SHAPE_GRID)
    dens = _shape_density(shape, x)
    cdf = np.cumsum(dens)
    cdf = (cdf - cdf[0]) / (cdf[-1] - cdf[0])
    u = np.sort(rng.uniform(0.0, 1.0, size=n))
    return np.interp(u, cdf, x) * duration_s


def shaped_request_stream(n: int, duration_s: float, *, vocab_size: int,
                          shape: str = "random",
                          prompt_lens: Sequence[int] = (6,), n_new: int = 8,
                          slo: str = INTERACTIVE, priority: int = 1,
                          deadline_slack_s: Optional[float] = None,
                          seed: int = 0) -> List[InferenceRequest]:
    """``n`` typed requests whose arrivals follow the named load shape —
    the per-request analogue of :func:`make_workload`'s fluid rates, for
    driving any ``ServingBackend`` under realistic diurnal load instead of
    flat Poisson.  ``deadline_slack_s`` (if given) stamps each request with
    ``arrival + slack`` as its deadline, which is what EDF and the carbon
    policies key on."""
    arrivals = shaped_arrival_times(n, duration_s, shape, seed)
    rng = np.random.default_rng(seed + 1)
    reqs: List[InferenceRequest] = []
    for rid, a in enumerate(arrivals):
        reqs.append(InferenceRequest(
            rid=rid, prompt=rng.integers(
                0, vocab_size,
                size=int(prompt_lens[rid % len(prompt_lens)])
            ).astype(np.int32),
            max_new_tokens=n_new, slo=slo, priority=priority,
            arrival_s=float(a),
            deadline_s=(float(a) + deadline_slack_s
                        if deadline_slack_s is not None else None)))
    return reqs
