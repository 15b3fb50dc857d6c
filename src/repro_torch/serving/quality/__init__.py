"""Mixed-quality request path: per-request variant selection (a copy of
the reference package's ``serving/quality``).

Clover trades a little model quality for a lot of operational carbon under
an accuracy constraint.  A
:class:`~repro_torch.serving.quality.selectors.QualitySelector` puts that
knob on the request path: it sits between the scheduling policy (which
decides *when* a request runs) and the engine instances (which decide
*where*) and picks *at what quality* — a ladder rung from
``build_engine_family`` — for every request at admission time.  The
decision clock is the request's ``arrival_s``, so one workload yields the
same decision sequence on the port's engine as on the reference's backends.

Selectors (``make_selector``): ``static`` per-SLO-class pinning, ``greedy``
dirty-grid downshifting over a ``ci_fn``, and ``governed`` — the greedy
downshifter behind a windowed per-class accuracy-floor governor that
refuses downshifts which would breach the configured floor.  Stdlib only.
"""
from __future__ import annotations

from repro_torch.serving.quality.selectors import AccuracyFloorGovernor, \
    GreedyDownshiftSelector, QualityDecision, QualitySelector, \
    StaticPinSelector, make_selector

__all__ = ["AccuracyFloorGovernor", "GreedyDownshiftSelector",
           "QualityDecision", "QualitySelector", "StaticPinSelector",
           "make_selector"]
