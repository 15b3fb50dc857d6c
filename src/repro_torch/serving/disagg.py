"""Prefill/decode disaggregated serving — the port's counterpart of the
reference package's ``serving/disagg.py``.

Splits :class:`~repro_torch.serving.engine.RealEngine` into PREFILL
workers and DECODE workers behind the same ``ServingBackend`` protocol, so
callers (and the fleet's ``probe_window``) drive it unchanged.

Why split: prefill is compute-bound, decode is bandwidth-bound.  Running
both phases on one worker makes long prompts stall running decodes (and
vice versa); splitting them lets each pool batch its own phase, and makes
the split a CARBON lever: compute-heavy prefill workers can ride low-CI
windows while the decode pool holds the SLA.  The per-role joules the
engine reports (``prefill_energy_j`` / ``decode_energy_j`` /
``handoff_energy_j``, plus ``energy_by_role`` on every response) make the
placement of the two pools measurable.

The lifecycle:

  1. a fresh request admits onto a PREFILL worker (``RealEngine._takes``
     routes by role); chunked prefill runs exactly as in the monolithic
     engine, radix prefix sharing included, and the final chunk's argmax
     becomes the first generated token (read back asynchronously);
  2. once that first token LANDS, the sequence is extracted as a
     :class:`BlockHandoff`: its filled pages are gathered into a staged
     host image (``PagedInstance.handoff_out``: ``index_select`` over the
     arena's block axis, copied to pinned host memory behind an event) and
     the prefill worker's row and blocks are freed for the next admission;
  3. the handoff is placed on a DECODE worker of the same variant through
     the ordinary ``can_resume`` / ``resume`` path (``_restore_pages``,
     ``index_copy_`` into fresh blocks: the same bit-exact page restore as
     a swap-in, with no preemption counted), and its prompt is registered
     in the decode-side radix tree, so concurrent handoffs sharing a
     prefix share blocks again;
  4. decode, preemption/swap and partial swap-in proceed on the decode
     worker exactly as in the monolithic paged engine, so greedy outputs
     do not depend on the handoff.

The three steps run in this order on one stream.  Handoff wall time is
charged at busy power under the ``"handoff"`` role tag on both ends, so
prefill + decode + handoff joules sum to the session total
(``obs.validate.check_disagg_conservation``).

``mesh=`` (a rank mesh, ``launch.ranks``) runs both pools on it: every
rank runs this engine with its shard, each worker's arena holding the
rank's KV heads, and a handoff stages and restores each rank's own
heads' pages, with no collective.
"""
from __future__ import annotations

import dataclasses
import time
from collections import deque
from typing import Deque, List, Optional

from repro_torch.core import perf_model as PM
from repro_torch.obs import PhaseProfiler
from repro_torch.serving.api import InferenceResponse
from repro_torch.serving.engine import PagedInstance, RealEngine, \
    _PagedSeq, _SwapState

__all__ = ["BlockHandoff", "DisaggEngine"]


@dataclasses.dataclass
class BlockHandoff:
    """One prefill→decode transfer: everything a decode worker needs to
    continue the sequence bit-exactly.

    The filled pages travel as the staged host image inside ``swap``
    (``_SwapState``, the machinery preemption uses): the prefill worker's
    block ids are released at staging, and the decode worker's allocator
    assigns fresh ones at placement, re-acquiring radix-tree-resident
    prefix pages by reference instead of copying when its tree is warm.
    ``table`` snapshots the prefill-side block table for observability
    (page count and order), not for reuse."""
    rid: int
    variant: str                 # ladder rung: placement must match it
    table: List[int]             # prefill-side block table at staging
    n_pages: int                 # filled pages in the image
    first_token: int             # the prefill's generated token (landed)
    n_prompt: int
    swap: _SwapState             # staged page image + request state
    t_staged: float

    @classmethod
    def stage(cls, inst: PagedInstance, seq: _PagedSeq) -> "BlockHandoff":
        table = list(seq.blocks)
        swap = inst.handoff_out(seq)
        return cls(rid=swap.rid, variant=inst.ev.variant.name, table=table,
                   n_pages=swap.n_blocks, first_token=swap.next_token,
                   n_prompt=len(swap.prompt), swap=swap,
                   t_staged=time.perf_counter())


class DisaggEngine(RealEngine):
    """Role-split real engine: ``roles={"prefill": P, "decode": D}`` workers
    per ConfigGraph instance (a graph edge of weight ``w`` builds ``w``
    disaggregated cells).  Constructed directly or, transparently, by
    ``RealEngine(..., roles=...)``; ``roles=(P, D)`` is shorthand."""

    def __init__(self, family, n_slots: int = 4, max_len: int = 96, *,
                 roles=None, **kw):
        kw.setdefault("kv_layout", "paged")
        assert kw["kv_layout"] == "paged", \
            "disaggregation requires the paged KV layout (block handoff)"
        if roles is None:
            roles = {"prefill": 1, "decode": 1}
        if isinstance(roles, (tuple, list)):
            roles = {"prefill": int(roles[0]), "decode": int(roles[1])}
        assert set(roles) == {"prefill", "decode"} and \
            all(int(n) >= 1 for n in roles.values()), \
            f"roles must map prefill/decode to counts >= 1: {roles}"
        super().__init__(family, n_slots, max_len, **kw)
        self.roles = {r: int(n) for r, n in roles.items()}
        # per-role phase profilers: the same PHASES catalog, labeled by
        # role, so phase latency splits prefill pool from decode pool
        self.profilers = {r: PhaseProfiler(role=r)
                          for r in ("prefill", "decode")}
        self._handoffq: Deque[BlockHandoff] = deque()

    # --- engine hooks --------------------------------------------------------
    def _profilers(self):
        return (self.profiler,) + tuple(self.profilers.values())

    def _takes(self, inst, resuming: bool) -> bool:
        if inst.role == "prefill":
            return not resuming
        if inst.role == "decode":
            return resuming
        return True

    def _extra_pending(self) -> bool:
        return bool(self._handoffq)

    def configure(self, graph) -> float:
        """Warm-pooled by (variant, chips) like the base engine; each graph
        instance expands to ``roles["prefill"]`` prefill and
        ``roles["decode"]`` decode workers of that (variant, chips)."""
        assert self._session is None, "configure during an open serve session"
        t0 = time.perf_counter()
        for inst in self.instances:
            self._pool.setdefault((inst.ev.variant.name, inst.chips),
                                  []).append(inst)
        self.instances = []
        for (vname, chips), w in graph.edges:
            for _ in range(w):
                for role in ("prefill", "decode"):
                    for _i in range(self.roles[role]):
                        warm = self._pool.get((vname, chips), [])
                        if warm:
                            inst = warm.pop()
                            inst.reset()
                        else:
                            inst = self._new_instance(self.family[vname],
                                                      chips, role=role)
                            inst.warmup()
                        inst.role = role     # pooled workers switch roles
                        inst.profiler = self.profilers[role]
                        self.instances.append(inst)
        self.last_reconfig_s = time.perf_counter() - t0
        return self.last_reconfig_s

    def _post_tick(self, completed: List[InferenceResponse]) -> None:
        s = self._session
        if s is None:
            return
        # 1. EXTRACT: fully-prefilled sequences whose first token landed
        # (one tick after the final chunk: the readback overlapped host
        # work, so extraction never forces a blocking sync)
        for inst in self.instances:
            if inst.role != "prefill":
                continue
            for seq in [q for q in inst.rows if q is not None]:
                if (seq.prefilled and seq.remaining > 0
                        and seq.pending_first is None):
                    t0 = time.perf_counter()
                    h = BlockHandoff.stage(inst, seq)
                    dt = time.perf_counter() - t0
                    e = inst.chips * PM.P_BUSY_W * dt
                    s.charge("handoff", e)
                    s.meter(h.rid, "handoff", e)
                    s.accounted_s[id(inst)] += dt
                    s.handoffs += 1
                    s.handoff_pages += h.n_pages
                    s.progressed = True
                    self._handoffq.append(h)
                    if s.tracer is not None:
                        s.tracer.instant("handoff_out",
                                         s.rel(time.perf_counter()),
                                         rid=h.rid, pages=h.n_pages)
        # 2. PLACE: FIFO over in-transit handoffs onto decode workers of
        # the matching variant; ones that do not fit yet wait for decode
        # completions to free rows and blocks
        if not self._handoffq:
            return
        waiting: Deque[BlockHandoff] = deque()
        while self._handoffq:
            h = self._handoffq.popleft()
            if self._place(h) is None:
                waiting.append(h)
        self._handoffq = waiting

    def _place(self, h: BlockHandoff) -> Optional[PagedInstance]:
        s = self._session
        targets = [i for i in self.instances
                   if i.role == "decode" and i.ev.variant.name == h.variant]
        if not targets:
            raise RuntimeError(
                f"no decode worker serves variant {h.variant!r} "
                f"(handoff rid {h.rid})")
        for inst in targets:
            if not inst.can_resume(h.swap):
                continue
            t0 = time.perf_counter()
            seq, _ = inst.resume(h.swap)
            # register the prompt in the decode-side radix tree: later
            # handoffs sharing the prefix re-acquire these pages by
            # reference (match_full at resume) instead of copying
            if inst.prefix is not None:
                inst.prefix.insert(h.swap.prompt, seq.blocks)
            dt = time.perf_counter() - t0
            e = inst.chips * PM.P_BUSY_W * dt
            s.charge("handoff", e)
            s.meter(h.rid, "handoff", e)
            s.accounted_s[id(inst)] += dt
            s.progressed = True
            if s.tracer is not None:
                s.tracer.instant("handoff_in", s.rel(time.perf_counter()),
                                 rid=h.rid, pages=h.n_pages)
            return inst
        if all(not i.busy for i in targets):
            raise RuntimeError(
                f"handoff rid {h.rid} needs {h.n_pages} pages but fits no "
                f"idle decode worker — decode arena too small for the "
                f"handed-off sequence")
        return None
