"""Unified request/response serving API (the request-centric surface).

Clover's runtime is fundamentally request-centric — SLA attainment, accuracy
mix and carbon are all properties of individual requests flowing through the
system — yet the execution paths historically exposed three incompatible
surfaces: the real engine took bare token lists, the DES took synthetic rate
parameters, and the fluid simulator took aggregate RPS.  This module is the
one surface all of them serve:

  * :class:`InferenceRequest` — a typed request: prompt tokens, decode
    budget, SLO class (interactive vs deferrable), priority, deadline,
    arrival time on the backend's clock, and an optional per-token stream
    callback;
  * :class:`InferenceResponse` — the full per-request account: generated
    tokens, queue delay, TTFT, end-to-end latency, **attributed energy and
    carbon** (occupancy-weighted tick energy × the serving window's carbon
    intensity), and the preemption count;
  * :class:`ServingBackend` — the ``submit / step / drain / stats`` protocol
    implemented by ``RealEngine`` (both KV layouts), the per-request DES
    (``serving.queue.DESBackend``) and the fluid-window model
    (``serving.backends.FluidBackend``), so the fleet layer and the Clover
    controller drive all three through one interface.

Backends own their clocks: the real engine measures wall seconds, the DES
and the fluid model advance simulated seconds.  ``arrival_s`` and
``deadline_s`` are expressed on that backend clock, relative to the start of
the serve session.  This module is deliberately torch-free (numpy only) so the
fleet layer can build workloads without touching the device stack.
"""
from __future__ import annotations

import dataclasses
from typing import Callable, Dict, List, Optional, Protocol, Sequence, \
    runtime_checkable

import numpy as np

__all__ = ["INTERACTIVE", "DEFERRABLE", "QUEUED", "RUNNING", "PREEMPTED",
           "DONE", "InferenceRequest", "InferenceResponse", "ServingBackend",
           "serve_workload", "serve_prompts", "summarize_responses"]

# SLO classes (paper's two-class workload: tail-latency vs deadline)
INTERACTIVE = "interactive"
DEFERRABLE = "deferrable"

# request lifecycle states:  QUEUED → RUNNING → DONE, with RUNNING →
# PREEMPTED → QUEUED when a paged engine swaps a victim out under
# decode-time block pressure (the K/V pages move to host memory and the
# request re-enters the queue; on re-admission they are restored bit-exactly
# so greedy outputs are preemption-invariant)
QUEUED = "queued"
RUNNING = "running"
PREEMPTED = "preempted"
DONE = "done"


@dataclasses.dataclass
class InferenceRequest:
    """One inference request on a backend's clock.

    ``arrival_s`` is the release time relative to the serve session start
    (None = visible immediately); ``deadline_s`` is an absolute completion
    deadline on the same clock (only EDF / carbon-aware policies read it).
    ``on_token`` is invoked as ``on_token(rid, token)`` for every generated
    token as the engine emits it — real backends stream, analytic backends
    (DES / fluid) never call it.

    Mixed-quality serving (``serving.quality``): ``min_accuracy`` is a hard
    per-request floor — a quality selector never places the request on a
    variant whose accuracy proxy falls below it; ``quality_hint`` pins the
    request to a named ladder rung when that rung is available (the
    "Greening AI Inference" per-request quality-class API shape).  Both are
    ignored by a backend running without a selector."""
    rid: int
    prompt: np.ndarray
    max_new_tokens: int = 8
    slo: str = INTERACTIVE
    priority: int = 0                  # larger = more important
    deadline_s: Optional[float] = None
    arrival_s: Optional[float] = None
    on_token: Optional[Callable[[int, int], None]] = None
    min_accuracy: Optional[float] = None   # hard per-request accuracy floor
    quality_hint: Optional[str] = None     # pin to a named variant if present

    def __post_init__(self) -> None:
        self.prompt = np.asarray(self.prompt, np.int32).reshape(-1)
        assert self.max_new_tokens >= 1, "need at least one generated token"
        assert self.slo in (INTERACTIVE, DEFERRABLE), self.slo
        assert self.min_accuracy is None or 0.0 <= self.min_accuracy <= 1.0

    @property
    def prompt_len(self) -> int:
        return int(self.prompt.shape[0])


@dataclasses.dataclass
class InferenceResponse:
    """Per-request outcome, including the attributed energy/carbon account.

    ``energy_j`` is the request's share of every tick it held resources for
    (decode tick energy split over the occupant rows, prefill charged to the
    prefilling request, plus an equal share of the session's idle floor);
    summed over a session's responses it equals the backend's total energy.
    ``carbon_g`` is that energy × the backend's serving-window carbon
    intensity (gCO2/kWh)."""
    rid: int
    tokens: Optional[np.ndarray]       # None for analytic backends (DES/fluid)
    slo: str = INTERACTIVE
    priority: int = 0
    state: str = DONE
    t_arrival: float = 0.0             # backend-clock timestamps
    t_finish: float = 0.0
    queue_delay_s: float = 0.0         # arrival → first admission
    ttft_s: float = 0.0                # arrival → first generated token
    latency_s: float = 0.0             # arrival → completion
    energy_j: float = 0.0
    carbon_g: float = 0.0
    preemptions: int = 0
    accuracy: float = 0.0              # the SERVED variant's accuracy proxy
    variant: Optional[str] = None      # ladder rung the request actually ran
                                       # on (None when no selector routed it)
    deadline_s: Optional[float] = None
    held_s: float = 0.0                # policy-hold portion of queue_delay_s
    release_reason: Optional[str] = None   # "valley"/"threshold"/"runway"
    # role-split joules (serving.disagg): {"prefill": J, "decode": J,
    # "handoff": J} on a disaggregated engine ({"both": J} monolithic);
    # values sum to energy_j, so per-phase carbon is per-request too
    energy_by_role: Dict[str, float] = dataclasses.field(
        default_factory=dict)

    @property
    def n_tokens(self) -> int:
        return 0 if self.tokens is None else int(len(self.tokens))

    @property
    def deadline_met(self) -> bool:
        return self.deadline_s is None or self.t_finish <= self.deadline_s


@runtime_checkable
class ServingBackend(Protocol):
    """The one serving surface: submit requests, advance, collect responses.

    ``submit`` enqueues a request (its ``arrival_s`` gates visibility on the
    backend's clock); ``step`` advances the backend by one scheduling unit
    (one engine tick / one DES event / one fluid window) and returns the
    requests that completed on it; ``drain`` runs until every submitted
    request has completed and returns all responses of the session;
    ``stats`` reports the last session's aggregate metrics."""

    def submit(self, req: InferenceRequest) -> None: ...

    def step(self) -> List[InferenceResponse]: ...

    def drain(self) -> List[InferenceResponse]: ...

    def stats(self) -> Dict[str, float]: ...


def serve_workload(backend: ServingBackend,
                   requests: Sequence[InferenceRequest]
                   ) -> List[InferenceResponse]:
    """Submit a whole workload and run it to completion (the one-call path
    the examples and the fleet probe use on every backend)."""
    for req in requests:
        backend.submit(req)
    return backend.drain()


def serve_prompts(backend: ServingBackend, prompts: Sequence,
                  n_new: int = 8, arrival_s: Optional[Sequence[float]] = None
                  ) -> Dict[str, float]:
    """Bulk-prompt convenience over the typed path: wrap bare token lists
    into :class:`InferenceRequest`s (rid = position), drain, and return the
    backend's session stats.  The one-liner examples/benchmarks use now
    that the engine's ``serve(prompts=...)`` shim is gone — callers that
    need per-request metadata build their own requests."""
    if arrival_s is not None:
        assert len(arrival_s) == len(prompts)
    for i, p in enumerate(prompts):
        backend.submit(InferenceRequest(
            rid=i, prompt=np.asarray(p, np.int32).reshape(-1),
            max_new_tokens=n_new,
            arrival_s=None if arrival_s is None else float(arrival_s[i])))
    backend.drain()
    return backend.stats()


def summarize_responses(responses: Sequence[InferenceResponse]
                        ) -> Dict[str, float]:
    """Cross-backend workload summary (per-class tails + attribution sums)."""
    from repro_torch.serving.scheduler import latency_percentile

    inter = [r for r in responses if r.slo == INTERACTIVE]
    defer = [r for r in responses if r.slo == DEFERRABLE]
    out = {
        "served": len(responses),
        "energy_j": sum(r.energy_j for r in responses),
        "carbon_g": sum(r.carbon_g for r in responses),
        "preemptions": sum(r.preemptions for r in responses),
        "deadline_misses": sum(not r.deadline_met for r in responses),
        "p95_s": (latency_percentile([r.latency_s for r in responses], 95.0)
                  if responses else 0.0),
    }
    if inter:
        out["interactive_p95_s"] = latency_percentile(
            [r.latency_s for r in inter], 95.0)
        out["interactive_ttft_p95_s"] = latency_percentile(
            [r.ttft_s for r in inter], 95.0)
    if defer:
        out["deferrable_served"] = len(defer)
        # the carbon policies move exactly this number: deferrable work's
        # attributed gCO2 (held work served in a cleaner window shows here)
        out["deferrable_carbon_g"] = sum(r.carbon_g for r in defer)
        out["deferrable_queue_delay_p95_s"] = latency_percentile(
            [r.queue_delay_s for r in defer], 95.0)
    return out
