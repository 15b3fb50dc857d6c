"""Real-execution serving engine: continuous batching over slotted or PAGED
KV caches — the port's counterpart of the reference package's
``serving/engine.py``.

Two KV layouts share the serving loop (``RealEngine(kv_layout=...)``):

  * ``"slotted"`` (the default, as in the reference) — every
    :class:`Instance` owns a fixed-capacity batched cache
    (``models.registry.make_slot_cache``): ``n_slots`` sequences, each
    reserving ``max_len`` positions whatever its prompt, with a per-slot
    valid prefix ``lengths``.  A prompt is prefilled in one pass at
    admission (``prefill_kv``, contiguous flash attention), and one batched
    decode step (``decode_slots``, contiguous flash-decode) advances every
    slot per tick.  The loop is synchronous by design: each admission and
    each decode step reads its tokens back at once;
  * ``"paged"`` — every :class:`PagedInstance` owns one block arena
    (``models.registry.make_block_arena``) mapped by the ``serving.kvpool``
    allocator: sequences hold exactly the fixed-size blocks their tokens
    need, admission is by block availability, a radix prefix cache lets
    requests share prompt-prefix blocks by refcount, prefill is chunked
    (long prompts advance one chunk per tick, interleaved with decode), and
    attention reads K/V through block tables.

The attention runs on the Hopper kernels of ``kernels/`` on the GPU, their
plain versions on the CPU.

The serving surface is the ``ServingBackend`` protocol (``serving.api``):
``submit`` typed :class:`InferenceRequest`s, ``step`` one scheduler tick,
``drain`` to completion, ``stats`` for the session aggregates, with
pluggable admission policies, per-request energy attribution (per-request
joules sum to the session total), open-loop arrivals, and — paged — the
device-resident decode loop: loop state stays on the device, greedy tokens
feed back on the device, a fused dispatch runs ``fused_steps`` steps, and
token readbacks land a tick later through pinned host buffers.  On top:

  * **paged preemption** (``preemption=True``): admission reserves only the
    prompt's blocks and decode grows block tables on demand; when the arena
    runs dry mid-decode the lowest-priority / youngest sequence is swapped
    out to host memory, re-queued, and restored bit-exactly on
    re-admission — **partially** when the radix tree still holds its
    prompt blocks (only the evicted tail is copied back);
  * **telemetry** (``telemetry=``, ``obs.Telemetry``): a per-session
    metrics registry with phase timings, lifecycle spans and per-tick
    counter tracks in a persistent ``TraceRecorder``, and one exact
    (wall, joules, grams) segment per session into a ``CarbonFeed``;
  * **mixed quality** (``quality_selector=``, ``serving.quality``): each
    request's ladder rung is decided at submit, and admission places it
    only on instances of that rung.

How the JAX-specific parts of the reference translate:

  * the donated arena and the jitted slot writer become in-place writes
    into the cache and arena tensors;
  * ``copy_to_host_async`` becomes a ``non_blocking`` copy into a pinned
    host buffer with a CUDA event recorded after it (:class:`_Readback`);
    landing waits on that event only;
  * ``jnp.asarray`` uploads become pinned ``non_blocking`` host→device
    copies (:func:`_h2d`), counted as ``h2d_transfers`` exactly as the
    reference counts them;
  * ``warmup`` and the shape-key bookkeeping stay, so ``compile_retraces``
    keeps its meaning; eager PyTorch compiles nothing, so it stays 0;
  * the jitted swap staging pair (page gather, donated page scatter)
    becomes ``index_select`` over the arena's block axis into a fresh
    tensor, copied to pinned host memory like a readback, and
    ``index_copy_`` back into the arena.

Not ported yet, and refused with ``NotImplementedError``: ``mesh=`` and
``roles=`` (sharding and disaggregation).
"""
from __future__ import annotations

import dataclasses
import heapq
import time
from collections import deque
from typing import Deque, Dict, List, Optional, Sequence, Tuple, Union

import numpy as np
import torch

from repro_torch import resolve_device
from repro_torch.core import perf_model as PM
from repro_torch.core.catalog import Variant
from repro_torch.models import registry as R
from repro_torch.models.config import ModelConfig
from repro_torch.obs import MetricsRegistry, PhaseProfiler, Telemetry, \
    TraceRecorder
from repro_torch.serving.api import DONE, InferenceRequest, \
    InferenceResponse, serve_prompts
from repro_torch.serving.kvpool import BlockAllocator, RadixPrefixCache
from repro_torch.serving.policies import SchedulerPolicy, make_policy
from repro_torch.serving.quality import make_selector
from repro_torch.serving.scheduler import SchedulerCore, latency_percentile

__all__ = ["latency_percentile", "EngineVariant", "build_engine_family",
           "Instance", "PagedInstance", "RealEngine", "serve_buckets"]


@dataclasses.dataclass
class EngineVariant:
    variant: Variant
    cfg: ModelConfig
    params: R.LM


def build_engine_family(base_cfg: ModelConfig, fracs=(1.0, 0.5, 0.25),
                        seed: int = 0,
                        device: Optional[Union[str, torch.device]] = None
                        ) -> List[EngineVariant]:
    """Instantiate a real quality ladder by depth reduction, with random
    weights from ``seed`` on ``device`` (the GPU by default)."""
    dev = resolve_device(device)
    out = []
    for i, frac in enumerate(sorted(fracs)):
        n_layers = max(int(base_cfg.n_layers * frac), 1)
        cfg = base_cfg.with_(n_layers=n_layers,
                             name=f"{base_cfg.name}-x{frac:g}")
        params = R.init_params(cfg, seed=seed, device=dev)
        n_params = sum(p.numel() for p in params.parameters())
        v = Variant(family=base_cfg.name, name=f"x{frac:g}", quality=i + 1,
                    accuracy=0.80 + 0.05 * i, flops_g=n_params * 2 / 1e9,
                    params_m=n_params / 1e6, mem_gb=n_params * 4 / 2**30 + 0.1)
        out.append(EngineVariant(v, cfg, params))
    return out


def _bucket(n: int) -> int:
    """Prompt padding bucket of the slotted prefill (next power of two,
    floor 8), so the set of prefill shapes stays bounded as prompt lengths
    vary."""
    b = 8
    while b < n:
        b *= 2
    return b


def _pow2_bucket(n: int, cap: int) -> int:
    """Smallest power of two ≥ n, clamped to ``cap`` — ALWAYS a member of
    ``_bucket_ladder(cap)``, so a shape chosen at serve time is guaranteed
    to be one that warmup ran."""
    b = 1
    while b < n:
        b *= 2
    return min(b, cap)


def _bucket_ladder(cap: int) -> List[int]:
    """All values ``_pow2_bucket`` can produce for a given cap: powers of
    two below it, plus the cap itself.  Warmup walks exactly this ladder."""
    out: List[int] = []
    b = 1
    while b < cap:
        out.append(b)
        b *= 2
    out.append(cap)
    return out


def serve_buckets(max_len: int) -> List[int]:
    """Every prompt bucket the slotted serve loop can reach on a cache of
    ``max_len``: admitted prompts have ``true_len <= max_len - 1``, so the
    reachable set is exactly ``{_bucket(n) for n in 1..max_len-1}``.
    ``Instance.warmup`` runs precisely this set."""
    out: List[int] = []
    b = 8
    while True:
        out.append(b)
        if b >= max_len - 1:
            break
        b *= 2
    return out


def _h2d(arr: np.ndarray, device: torch.device) -> torch.Tensor:
    """One host→device upload of a loop-state buffer.  On CUDA the array is
    staged in pinned memory and copied ``non_blocking`` (a copy from
    pageable memory would block the host until the stream drains); on the
    CPU it is copied, so later host edits never alias it."""
    t = torch.from_numpy(np.ascontiguousarray(arr))
    if device.type == "cuda":
        return t.pin_memory().to(device, non_blocking=True)
    return t.clone()


class _Readback:
    """An asynchronous device→host copy of a small tensor: on CUDA a
    ``non_blocking`` copy into a pinned buffer with an event recorded after
    it, so the host only waits on that event when it lands the value; on
    the CPU the tensor itself."""

    __slots__ = ("host", "event")

    def __init__(self, t: torch.Tensor):
        if t.is_cuda:
            self.host = torch.empty(t.shape, dtype=t.dtype, pin_memory=True)
            self.host.copy_(t, non_blocking=True)
            self.event = torch.cuda.Event()
            self.event.record()
        else:
            self.host, self.event = t, None

    def wait(self) -> torch.Tensor:
        """The host tensor, once the copy into it has landed."""
        if self.event is not None:
            self.event.synchronize()
        return self.host

    def numpy(self) -> np.ndarray:
        return self.wait().numpy()


@dataclasses.dataclass
class _PendingDecode:
    """One dispatched-but-not-landed decode call of the pipelined loop: the
    (k, B) greedy-token readback in flight, the dispatch-time (seq, row)
    snapshot that maps token columns back to sequences, and enough
    accounting to charge the work when it lands.  Landing in a LATER tick
    than ``tick_id`` means the readback overlapped a full tick of host work
    (free); landing in the same tick is a forced flush and counts as a
    ``host_syncs`` blocking round-trip."""
    toks: _Readback                       # (k, B) i32
    rows: List[Tuple["_PagedSeq", int]]   # (seq, dispatch-time row)
    k: int
    occupied: int
    dispatch_s: float
    tick_id: int


@dataclasses.dataclass
class _PendingFirst:
    """A prefill's first generated token, still on the device: the final
    chunk's last-position argmax with its readback in flight.  The device
    scalar is written into the uploaded ``next`` buffer whenever loop state
    is pushed (so decode never waits on its value); the host only reads it
    to record ``seq.tokens[0]`` — one tick later, or immediately (a counted
    sync) when the request is n_new == 1."""
    seq: "_PagedSeq"
    tok: torch.Tensor                     # () i32 on the device
    host: _Readback
    tick_id: int


@dataclasses.dataclass
class _SwapState:
    """Host-side image of a preempted paged sequence: everything needed to
    restore it bit-exactly — request identity, generated tokens, the next
    decode token, and the K/V contents of the blocks it held (``n_ctx``
    valid positions).  Restoring writes the pages back into freshly
    allocated arena blocks, so greedy decode continues on identical state.

    ``tree_blocks`` records how many of the sequence's leading pages were
    radix-tree-resident at swap-out (full prompt blocks the prefix cache
    still holds).  On re-admission those pages are re-acquired from the
    tree instead of copied from the image — a PARTIAL swap-in that restores
    only the evicted tail.  The image still covers every page, so a tree
    eviction between swap-out and resume just degrades to a full restore.

    The device→host copy is STAGED: ``img_k``/``img_v`` are readbacks of a
    page gather whose copy into pinned host memory is in flight, so
    swap-out never blocks the decode loop; ``host_k``/``host_v`` wait on
    the copy's event (normally long landed at resume)."""
    rid: int
    t_arrival: float
    prompt: np.ndarray
    n_new: int
    priority: int
    tokens: List[int]
    remaining: int
    n_ctx: int                     # K/V positions already in the arena
    next_token: int
    t_first: Optional[float]
    cached_tokens: int
    preempts: int
    img_k: _Readback               # (L, >= n_blocks, bs, K, dh) pages
    img_v: _Readback
    n_blocks: int                  # pages used (the image may be padded)
    tree_blocks: int = 0           # leading pages tree-backed at swap-out
    slo: str = "interactive"
    deadline_s: Optional[float] = None

    @property
    def host_k(self) -> torch.Tensor:
        """(L, n_blocks, bs, K, dh) host image (waits for the copy)."""
        return self.img_k.wait()[:, :self.n_blocks]

    @property
    def host_v(self) -> torch.Tensor:
        return self.img_v.wait()[:, :self.n_blocks]


def _tick_info(prefill_s: float = 0.0, decode_s: float = 0.0,
               decode_steps: int = 0, occupied: int = 0,
               blocks_in_use: int = 0, prefill_rids=None, decode_rids=None,
               emitted=None, preempted=None) -> Dict[str, object]:
    return {"prefill_s": prefill_s, "decode_s": decode_s,
            "decode_steps": decode_steps, "occupied": occupied,
            "blocks_in_use": blocks_in_use,
            "prefill_rids": prefill_rids or [],   # [(rid, seconds), ...]
            "decode_rids": decode_rids or [],     # rows sharing the decode
            "emitted": emitted or [],             # [(rid, token), ...]
            "preempted": preempted or []}         # [_SwapState, ...]


def _note_shape(inst, key: Tuple) -> None:
    """Retrace accounting: every entry the serve loop hits registers its
    shape key here; a key not pre-seeded by ``warmup`` (``inst._shapes``)
    is a post-warmup shape miss — the event the bucket ladders exist to
    prevent — and increments the instance's lifetime ``retraces`` counter
    (sessions report the delta)."""
    if key not in inst._shapes:
        inst._shapes.add(key)
        inst.retraces += 1


# disabled-by-default phase profiler: instances constructed outside a
# RealEngine observe into this shared no-op (registry=None) shim; the
# engine overrides ``inst.profiler`` with its own at configure()
_NULL_PROFILER = PhaseProfiler()


# =============================================================================
# slotted instance
# =============================================================================
@dataclasses.dataclass
class _SlotState:
    """Host-side request state of one occupied slot."""
    rid: int
    t_arrival: float
    remaining: int                 # decode steps still to run
    tokens: List[int]              # generated token ids (prefill token first)
    t_first: Optional[float] = None   # wall time of the first generated token
    priority: int = 0
    preempts: int = 0              # slotted sequences never preempt (uniform
                                   # field so the engine reads one shape)


def _write_slot(cache: Dict[str, torch.Tensor], k_all: torch.Tensor,
                v_all: torch.Tensor, slot: int, true_len: int) -> None:
    """Write one prefill's K/V (L, 1, w, K, dh) into positions 0..w-1 of
    ``slot`` and set its length — in place, where the reference's jitted
    writer returns new buffers."""
    w = k_all.shape[2]
    cache["k"][:, slot, :w].copy_(k_all[:, 0])
    cache["v"][:, slot, :w].copy_(v_all[:, 0])
    cache["lengths"][slot] = true_len


class Instance:
    """One serving instance over a slotted batched KV cache: a one-pass
    prefill at admission and one batched decode step over all slots per
    tick.

    The cache is f32, as the reference's; like the reference (whose slot
    writer cannot mix types), it serves f32 models only and raises
    ``ValueError`` on another type."""

    profiler: PhaseProfiler = _NULL_PROFILER

    def __init__(self, ev: EngineVariant, chips: int, n_slots: int = 4,
                 max_len: int = 96):
        if ev.cfg.dtype != torch.float32:
            raise ValueError(
                f"variant {ev.variant.name} is {ev.cfg.dtype}: the slotted "
                f"layout serves f32 models only (its cache is f32, and the "
                f"reference's slot writer refuses a prefill of another "
                f"type); use dtype=torch.float32 or kv_layout='paged'")
        self.ev = ev
        self.chips = chips
        self.params = ev.params
        self.device = next(ev.params.parameters()).device
        self.n_slots = n_slots
        self.max_len = max_len
        self.cache = R.make_slot_cache(ev.cfg, n_slots, max_len,
                                       dtype=torch.float32,
                                       device=self.device)
        self.slots: List[Optional[_SlotState]] = [None] * n_slots
        self._next = np.zeros((n_slots, 1), np.int32)   # next decode token
        self._shapes: set = set()        # shape keys seen (see _note_shape)
        self.retraces = 0                # lifetime post-warmup shape misses
        # host↔device traffic (lifetime; sessions report deltas): the
        # slotted loop is synchronous by design — 1 upload + 1 blocking
        # readback per admission, 2 uploads + 1 blocking readback per
        # decode step — the baseline the paged pipelined loop is held to
        self.host_syncs = 0
        self.h2d_transfers = 0
        self.decode_dispatches = 0

    # --- lifecycle -----------------------------------------------------------
    def reset(self) -> None:
        """Recycle from the warm pool: clear per-slot state.  Cache contents
        are stale but masked out (lengths = 0) until the next prefill."""
        self.cache["lengths"].zero_()
        self.slots = [None] * self.n_slots
        self._next[:] = 0

    def _put(self, arr: np.ndarray) -> torch.Tensor:
        return _h2d(arr, self.device)

    def warmup(self) -> None:
        """Run EXACTLY the shapes the serve loop can reach — every prompt
        bucket of ``serve_buckets`` plus one decode step — and seed the
        shape keys ``_note_shape`` checks.  The prefills write into slot 0
        at length 0 and the decode step has no active slot, so logical
        state is untouched."""
        for b in serve_buckets(self.max_len):
            self._shapes.add(("prefill", b))
            dummy = torch.zeros((1, b), dtype=torch.int32,
                                device=self.device)
            _, k_all, v_all = R.prefill_kv(self.params, {"tokens": dummy})
            w = min(b, self.max_len)
            _write_slot(self.cache, k_all[:, :, :w], v_all[:, :, :w], 0, 0)
        self._shapes.add(("decode",))
        R.decode_slots(self.params, self.cache,
                       {"tokens": self._put(self._next)},
                       torch.zeros((self.n_slots,), dtype=torch.bool,
                                   device=self.device))
        if self.device.type == "cuda":
            torch.cuda.synchronize(self.device)

    # --- slot management -----------------------------------------------------
    def free_slots(self) -> List[int]:
        return [i for i, s in enumerate(self.slots) if s is None]

    @property
    def occupied(self) -> int:
        return sum(1 for s in self.slots if s is not None)

    @property
    def capacity(self) -> int:
        return self.n_slots

    @property
    def busy(self) -> bool:
        return self.occupied > 0

    def admission_signature(self) -> Tuple:
        """Free-capacity fingerprint for admission gating: a failed admission
        is only re-attempted once this changes (a slot was freed)."""
        return (len(self.free_slots()),)

    # --- serving -------------------------------------------------------------
    def can_admit(self, prompt_len: int, n_new: int) -> bool:
        assert prompt_len + n_new <= self.max_len, \
            f"prompt {prompt_len} + n_new {n_new} > max_len {self.max_len}"
        return any(s is None for s in self.slots)

    def admit_next(self, rid: int, t_arrival: float, prompt: np.ndarray,
                   n_new: int, priority: int = 0, slo: str = "interactive",
                   deadline_s: Optional[float] = None
                   ) -> Tuple[_SlotState, float]:
        """Admit into the first free slot; returns (state, prefill seconds)
        — the engine charges prefill at full busy power.  ``slo`` /
        ``deadline_s`` are accepted for the uniform instance surface; the
        slotted layout prefills at admission, so there is no prefill queue
        for a policy to order."""
        slot = self.free_slots()[0]
        t1 = time.perf_counter()
        state = self.admit(slot, rid, t_arrival, prompt, n_new,
                           priority=priority)
        state.t_first = time.perf_counter()
        return state, state.t_first - t1

    def admit(self, slot: int, rid: int, t_arrival: float,
              prompt: np.ndarray, n_new: int, priority: int = 0
              ) -> _SlotState:
        """One-pass prefill of ``prompt`` into ``slot``.  The prompt's
        last-position logits yield the first generated token at once (a
        blocking readback) — the prefill forward is never discarded."""
        prompt = np.asarray(prompt, np.int32).reshape(-1)
        true_len = int(prompt.shape[0])
        assert true_len + n_new <= self.max_len, \
            f"prompt {true_len} + n_new {n_new} > max_len {self.max_len}"
        pad = _bucket(true_len)
        _note_shape(self, ("prefill", pad))
        padded = np.zeros((1, pad), np.int32)
        padded[0, :true_len] = prompt
        self.h2d_transfers += 1
        logits, k_all, v_all = R.prefill_kv(self.params,
                                            {"tokens": self._put(padded)})
        write = min(pad, self.max_len)   # padded tail beyond capacity is junk
        _write_slot(self.cache, k_all[:, :, :write], v_all[:, :, :write],
                    slot, true_len)
        self.host_syncs += 1             # blocking first-token readback
        first = int(logits[0, true_len - 1].argmax())
        state = _SlotState(rid, t_arrival, remaining=n_new - 1,
                           tokens=[first], priority=priority)
        self._next[slot, 0] = first
        if state.remaining > 0:
            self.slots[slot] = state
        return state

    def step(self) -> Tuple[List[_SlotState], List[Tuple[int, int]]]:
        """One batched decode step over ALL slots; returns (completed
        requests — their slots are freed for mid-flight admission — and the
        (rid, token) emissions of every active row for streaming)."""
        active = np.array([s is not None for s in self.slots])
        _note_shape(self, ("decode",))
        self.h2d_transfers += 2          # next-token + active-mask uploads
        t_d0 = time.perf_counter()
        logits, self.cache = R.decode_slots(
            self.params, self.cache, {"tokens": self._put(self._next)},
            self._put(active))
        self.host_syncs += 1             # blocking per-step token readback
        self.decode_dispatches += 1
        t_l0 = time.perf_counter()
        toks = logits.argmax(dim=-1).cpu().numpy()
        self.profiler.observe("decode_dispatch", t_l0 - t_d0)
        self.profiler.observe("decode_land", time.perf_counter() - t_l0)
        finished: List[_SlotState] = []
        emitted: List[Tuple[int, int]] = []
        for i, s in enumerate(self.slots):
            if s is None:
                continue
            s.tokens.append(int(toks[i]))
            emitted.append((s.rid, int(toks[i])))
            s.remaining -= 1
            self._next[i, 0] = int(toks[i])
            if s.remaining <= 0:
                finished.append(s)
                self.slots[i] = None
        return finished, emitted

    def tick(self, now: Optional[float] = None, allow_fused: bool = True
             ) -> Tuple[List[_SlotState], Dict[str, object]]:
        """One scheduler tick = one batched decode step (slotted prefill
        runs at admission; ``now`` / ``allow_fused`` are unused here —
        uniform tick surface with :class:`PagedInstance`)."""
        occ = self.occupied
        if occ == 0:
            return [], _tick_info()
        rids = [s.rid for s in self.slots if s is not None]
        t1 = time.perf_counter()
        finished, emitted = self.step()
        dt = time.perf_counter() - t1
        return finished, _tick_info(decode_s=dt, decode_steps=1, occupied=occ,
                                    decode_rids=rids, emitted=emitted)

    @torch.no_grad()
    def generate(self, prompt: np.ndarray, n_new: int = 8
                 ) -> Tuple[np.ndarray, float]:
        """Greedy generation for a (possibly batched) prompt, outside the
        slots: prompt (b, s) int32 -> (tokens (b, n_new), wall seconds).
        One-pass prefill into a cache of its own, then batched decode; each
        row takes its own argmax."""
        t0 = time.perf_counter()
        prompt = np.asarray(prompt, np.int32)
        b, s = prompt.shape
        logits, k_all, v_all = R.prefill_kv(self.params,
                                            {"tokens": self._put(prompt)})
        cache = R.make_slot_cache(self.ev.cfg, b, s + n_new,
                                  dtype=torch.float32, device=self.device)
        cache["k"][:, :, :s] = k_all
        cache["v"][:, :, :s] = v_all
        cache["lengths"].fill_(s)
        active = torch.ones((b,), dtype=torch.bool, device=self.device)
        tok = logits[:, s - 1].argmax(dim=-1)             # (b,) per-row
        out = [tok]
        for _ in range(n_new - 1):
            lg, cache = R.decode_slots(
                self.params, cache,
                {"tokens": tok[:, None].to(torch.int32)}, active)
            tok = lg.argmax(dim=-1)
            out.append(tok)
        toks = torch.stack(out, dim=1).cpu().numpy()
        return toks, time.perf_counter() - t0


# =============================================================================
# paged instance (kvpool)
# =============================================================================
@dataclasses.dataclass
class _PagedSeq:
    """Host-side state of one sequence in a paged instance.

    Carries the request's scheduling metadata (``priority``/``slo``/
    ``deadline_s``) plus a stable admission counter ``seq``, matching the
    attribute contract of ``scheduler._Entry`` — so the engine's active
    :class:`~repro_torch.serving.policies.SchedulerPolicy` can order the
    instance-level chunked-prefill queue with the same ``select`` it uses
    for admission."""
    rid: int
    t_arrival: float
    prompt: np.ndarray
    n_new: int
    row: int                        # batch row (static decode shape)
    blocks: List[int]               # owned block refs (shared prefix + fresh)
    n_done: int                     # prompt tokens whose K/V are in the arena
    cached_tokens: int              # prefix-cache hit size at admission
    remaining: int = 0
    tokens: List[int] = dataclasses.field(default_factory=list)
    t_first: Optional[float] = None
    priority: int = 0
    preempts: int = 0               # times this sequence was swapped out
    pending_steps: int = 0          # decode steps dispatched but not landed
                                    # (``remaining`` is decremented at
                                    # DISPATCH; completion waits for landing)
    pending_first: Optional[_PendingFirst] = None
    slo: str = "interactive"
    deadline_s: Optional[float] = None
    seq: int = 0                    # admission order (policy tie-break)

    @property
    def prefilled(self) -> bool:
        return self.n_done >= len(self.prompt)


class PagedInstance:
    """One serving instance over a paged KV arena.

    Memory is ``n_blocks`` fixed-size blocks (``kvpool.BlockAllocator`` owns
    the map); a sequence holds exactly ``ceil((prompt+n_new)/block_size)``
    blocks, minus whatever the radix prefix cache already has.  The decode
    batch is ``max_seqs`` static rows; admission is bounded by *blocks*, not
    rows.

    With ``preemption=True`` the whole-sequence reservation is dropped:
    admission reserves only the PROMPT's blocks and decode grows each
    sequence's table on demand; when the arena runs dry mid-decode the
    lowest-priority / youngest sequence is swapped out to host memory
    (``_SwapState``) for the engine to re-queue and later restore
    bit-exactly."""

    profiler: PhaseProfiler = _NULL_PROFILER

    def __init__(self, ev: EngineVariant, chips: int, n_blocks: int,
                 block_size: int = 16, max_seqs: int = 8, max_len: int = 96,
                 chunk_blocks: int = 2, prefix_caching: bool = True,
                 cache_watermark: float = 0.25, chunk_burst: int = 4,
                 preemption: bool = False,
                 policy: Optional[SchedulerPolicy] = None,
                 pipeline: bool = True, fused_steps: int = 8):
        self.ev = ev
        self.chips = chips
        self.params = ev.params
        self.device = next(ev.params.parameters()).device
        self.block_size = block_size
        self.max_len = max_len
        self.max_seqs = max_seqs
        self.n_pages = -(-max_len // block_size)
        self.chunk_tokens = chunk_blocks * block_size
        self.chunk_burst = chunk_burst   # max prefill chunks per tick when
                                         # the batch is decode-starved
        # keep this fraction of the arena free of *cache-only* blocks: a
        # tree that grows to fill the arena makes every admission evict —
        # and LRU eviction under full-arena pressure throws away exactly
        # the chains the next FIFO request was about to hit (cache thrash)
        self.cache_watermark = cache_watermark
        self.preemption = preemption
        # the engine's admission policy also orders THIS instance's chunked-
        # prefill queue (None / is_fifo → admission-order)
        self.policy = policy
        self.arena = R.make_block_arena(ev.cfg, n_blocks, block_size,
                                        dtype=torch.float32,
                                        device=self.device)
        self.alloc = BlockAllocator(n_blocks, block_size)
        self.prefix: Optional[RadixPrefixCache] = (
            RadixPrefixCache(self.alloc) if prefix_caching else None)
        self.rows: List[Optional[_PagedSeq]] = [None] * max_seqs
        self.tables = np.zeros((max_seqs, self.n_pages), np.int32)
        self.lengths = np.zeros((max_seqs,), np.int32)
        self._next = np.zeros((max_seqs, 1), np.int32)
        self._prefillq: Deque[_PagedSeq] = deque()
        self._adm_seq = 0                # admission counter (policy tie-break)
        self.prefill_chunks = 0
        self.prefix_hit_tokens = 0
        self.preemptions = 0
        # swap-in page accounting: ``total`` counts the pages a FULL restore
        # would have written back, ``copied`` the pages actually written —
        # the gap is what the radix tree's surviving blocks saved
        self.swapin_pages_total = 0
        self.swapin_pages_copied = 0
        self._shapes: set = set()        # shape keys seen (see _note_shape)
        self.retraces = 0                # lifetime post-warmup shape misses
        # --- device-resident decode hot path ---------------------------------
        # ``pipeline=False`` is the synchronous reference loop: loop state is
        # re-uploaded every tick and every dispatch lands in its own tick —
        # kept as the greedy-parity oracle.
        self.pipeline = pipeline
        self.fused_steps = max(int(fused_steps), 1)
        # device mirrors of (next, tables, lengths, active): uploaded only
        # when an EVENT (admission, prefill completion, release, preemption,
        # table growth, compaction) dirties the host copies — steady-state
        # decode runs on the device
        self._dev: Optional[Dict[str, torch.Tensor]] = None
        self._dev_B = 0
        self._dev_active: Optional[np.ndarray] = None
        self._dirty = True
        self._inflight: Deque[_PendingDecode] = deque()
        self._pending_first: List[_PendingFirst] = []
        self._tick_id = 0
        # per-tick landing accumulators (reset at each tick() entry; the
        # flush helpers append here so _swap_out can force-land mid-tick)
        self._ev_emitted: List[Tuple[int, int]] = []
        self._ev_finished: List[_PagedSeq] = []
        self._ld_s = 0.0                 # landed decode seconds this tick
        self._ld_steps = 0
        self._ld_occ = 0
        self._ld_rids: List[int] = []
        # host↔device traffic + dispatch counters (lifetime; session deltas)
        self.host_syncs = 0
        self.h2d_transfers = 0
        self.decode_dispatches = 0

    # --- lifecycle -----------------------------------------------------------
    def reset(self) -> None:
        """Recycle from the warm pool: fresh allocator/prefix state; arena
        contents are stale but unreachable (no tables point at them)."""
        self.alloc = BlockAllocator(self.alloc.n_blocks, self.block_size)
        if self.prefix is not None:
            self.prefix = RadixPrefixCache(self.alloc)
        self.rows = [None] * self.max_seqs
        self.tables[:] = 0
        self.lengths[:] = 0
        self._next[:] = 0
        self._prefillq.clear()
        self._inflight.clear()
        self._pending_first.clear()
        self._dev = None
        self._dev_B = 0
        self._dev_active = None
        self._dirty = True

    def _put(self, arr: np.ndarray) -> torch.Tensor:
        return _h2d(arr, self.device)

    def warmup(self) -> None:
        """Run every shape the serve loop can reach — the (single) prefill
        chunk size at every KV-span page bucket, and per power-of-two row
        bucket (``_row_buckets``) the fused decode at both step counts the
        loop dispatches (k = 1 and k = ``fused_steps``) — and seed the
        shape keys ``_note_shape`` checks.  ``true_c = 0`` / an all-False
        mask route every warmup write to the junk block, so logical state
        is untouched."""
        dummy = torch.zeros((1, self.chunk_tokens), dtype=torch.int32,
                            device=self.device)
        for span in self._page_buckets():
            self._shapes.add(("prefill_paged", span))
            R.prefill_paged(self.params, {"tokens": dummy}, self.arena,
                            torch.zeros((span,), dtype=torch.int32,
                                        device=self.device), 0, 0)
        ks = sorted({1, self.fused_steps})
        for B in self._row_buckets():
            for k in ks:
                self._shapes.add(("decode_multi", B, k))
                R.decode_paged_multi(
                    self.params, self.arena,
                    {"tokens": self._put(self._next[:B])},
                    self._put(self.tables[:B]), self._put(self.lengths[:B]),
                    self._put(np.zeros((B,), bool)), k)
        if self.device.type == "cuda":
            torch.cuda.synchronize(self.device)

    # --- capacity ------------------------------------------------------------
    @property
    def occupied(self) -> int:
        return sum(1 for s in self.rows if s is not None)

    @property
    def capacity(self) -> int:
        return self.max_seqs

    @property
    def busy(self) -> bool:
        return self.occupied > 0

    def _avail_blocks(self) -> int:
        return self.alloc.num_free + (self.prefix.evictable_blocks()
                                      if self.prefix else 0)

    def admission_signature(self) -> Tuple:
        """Free-capacity fingerprint for admission gating: a failed
        block-aware admission is only re-attempted once the allocator state
        (free list OR any refcount) or a batch row changed."""
        return (sum(1 for s in self.rows if s is None), self.alloc.version)

    def can_admit(self, prompt_len: int, n_new: int) -> bool:
        """Admission control by BLOCK availability: a free batch row plus
        enough free-or-evictable blocks.  Without preemption the worst case
        (no prefix hit) of the WHOLE sequence is reserved; with preemption
        only the prompt needs to fit now — decode grows on demand and block
        pressure is resolved by swapping victims out."""
        assert prompt_len + n_new <= self.max_len, \
            f"prompt {prompt_len} + n_new {n_new} > max_len {self.max_len}"
        need = self.alloc.blocks_for_tokens(
            prompt_len if self.preemption else prompt_len + n_new)
        assert need <= self.alloc.num_allocatable, \
            f"request needs {need} blocks > arena {self.alloc.num_allocatable}"
        if all(s is not None for s in self.rows):
            return False
        return self._avail_blocks() >= need

    # --- admission -----------------------------------------------------------
    def admit_next(self, rid: int, t_arrival: float, prompt: np.ndarray,
                   n_new: int, priority: int = 0, slo: str = "interactive",
                   deadline_s: Optional[float] = None
                   ) -> Tuple[_PagedSeq, float]:
        """Reserve blocks + a batch row; NO forward pass happens here —
        prefill is chunked across subsequent ticks.  Shared prompt-prefix
        blocks come from the radix cache already prefilled."""
        prompt = np.asarray(prompt, np.int32).reshape(-1)
        true_len = int(prompt.shape[0])
        row = self.rows.index(None)
        matched: List[int] = []
        n_cached = 0
        if self.prefix is not None:
            matched, n_cached = self.prefix.match(prompt)
        need = self.alloc.blocks_for_tokens(
            true_len if self.preemption else true_len + n_new) - len(matched)
        if need > self.alloc.num_free and self.prefix is not None:
            self.prefix.evict(need - self.alloc.num_free)
        blocks = matched + self.alloc.alloc(need)
        seq = _PagedSeq(rid, t_arrival, prompt, n_new, row, blocks,
                        n_done=n_cached, cached_tokens=n_cached,
                        remaining=n_new, priority=priority, slo=slo,
                        deadline_s=deadline_s, seq=self._adm_seq)
        self._adm_seq += 1
        self.tables[row, :len(blocks)] = blocks
        self.tables[row, len(blocks):] = 0
        self.lengths[row] = 0            # row inactive until prefill completes
        self._next[row, 0] = 0
        self.rows[row] = seq
        self._prefillq.append(seq)
        self.prefix_hit_tokens += n_cached
        self._dirty = True               # admission event: mirrors changed
        return seq, 0.0

    # --- preemption / swap ---------------------------------------------------
    def can_resume(self, swap: _SwapState) -> bool:
        """Re-admission check for a swapped-out sequence: a free row plus
        its saved block count (decode re-grows past that on demand)."""
        if all(s is not None for s in self.rows):
            return False
        return self._avail_blocks() >= swap.n_blocks

    def resume(self, swap: _SwapState) -> Tuple[_PagedSeq, float]:
        """Restore a preempted sequence — PARTIALLY when the radix tree
        still holds its prompt blocks.

        The leading pages recorded tree-backed at swap-out are re-acquired
        from the prefix cache (``match_full``: a reference per block, no
        device copy — their K/V never left the arena); only the evicted
        tail pages are written back from the host image.  If the tree
        dropped the nodes in the meantime the match comes back short and
        the difference is restored from the host — bit-exact either way."""
        row = self.rows.index(None)
        nb = swap.n_blocks
        reused: List[int] = []
        if self.prefix is not None and swap.tree_blocks > 0:
            reused = self.prefix.match_full(
                swap.prompt, max_blocks=min(swap.tree_blocks, nb))
        n_tail = nb - len(reused)
        if n_tail > self.alloc.num_free and self.prefix is not None:
            self.prefix.evict(n_tail - self.alloc.num_free)
        tail = self.alloc.alloc(n_tail)
        if n_tail:
            # the tail count is padded to its bucket, as the reference's
            # restore is: the extra slots write zero pages into junk block 0
            pb = _pow2_bucket(n_tail, self.n_pages)
            idx = np.zeros((pb,), np.int64)
            idx[:n_tail] = tail
            self.h2d_transfers += 3      # index vector + K + V page uploads
            t_h2d = time.perf_counter()
            self._restore_pages(idx, swap.host_k[:, len(reused):],
                                swap.host_v[:, len(reused):])
            self.profiler.observe("swap_h2d", time.perf_counter() - t_h2d)
        blocks = reused + tail
        self.swapin_pages_total += nb
        self.swapin_pages_copied += n_tail
        seq = _PagedSeq(swap.rid, swap.t_arrival, swap.prompt, swap.n_new,
                        row, blocks, n_done=len(swap.prompt),
                        cached_tokens=swap.cached_tokens,
                        remaining=swap.remaining, tokens=list(swap.tokens),
                        t_first=swap.t_first, priority=swap.priority,
                        preempts=swap.preempts, slo=swap.slo,
                        deadline_s=swap.deadline_s, seq=self._adm_seq)
        self._adm_seq += 1
        self.tables[row, :nb] = blocks
        self.tables[row, nb:] = 0
        self.lengths[row] = swap.n_ctx
        self._next[row, 0] = swap.next_token
        self.rows[row] = seq
        self._dirty = True               # swap-in event: mirrors changed
        return seq, 0.0

    def _gather_pages(self, idx: np.ndarray) -> Tuple[_Readback, _Readback]:
        """Swap-out half of the staging pair: gather arena pages ``idx``
        (``index_select`` over the block axis) into fresh device tensors and
        start their copies to the host (:class:`_Readback`), so the loop
        never waits here.  The copies run on the current stream behind the
        gather, so the blocks may be handed out again at once: a later write
        into them is queued behind the copy, and so is any reuse of the
        gathered tensors' memory once they are freed."""
        dev_idx = self._put(idx)
        return (_Readback(self.arena["k"].index_select(1, dev_idx)),
                _Readback(self.arena["v"].index_select(1, dev_idx)))

    def _restore_pages(self, idx: np.ndarray, hk: torch.Tensor,
                       hv: torch.Tensor) -> None:
        """Swap-in half of the staging pair: write host pages ``hk``/``hv``
        (L, n, bs, K, dh) into arena blocks ``idx[:n]`` with ``index_copy_``;
        the slots of ``idx`` past n (block 0, the junk sink) get zero
        pages."""
        dev_idx = self._put(idx)
        pinned = self.device.type == "cuda"
        for name, h in (("k", hk), ("v", hv)):
            pad = torch.zeros((h.shape[0], len(idx)) + tuple(h.shape[2:]),
                              dtype=h.dtype, pin_memory=pinned)
            pad[:, :h.shape[1]].copy_(h)
            self.arena[name].index_copy_(
                1, dev_idx, pad.to(self.device, non_blocking=True))

    def _select_victim(self, exclude: _PagedSeq) -> Optional[_PagedSeq]:
        """Preemption victim: lowest priority first, youngest (latest
        arrival) within a level; only fully-prefilled decoding sequences
        qualify (mid-prefill rows sit in the prefill queue)."""
        cands = [s for s in self.rows
                 if s is not None and s.prefilled and s.remaining > 0
                 and s is not exclude]
        if not cands:
            return None
        return min(cands, key=lambda s: (s.priority, -s.t_arrival))

    def _swap_out(self, seq: _PagedSeq) -> _SwapState:
        """Swap a sequence's K/V pages to host memory and release its arena
        blocks + batch row; the engine re-queues the returned image.

        In-flight work lands first (``_flush_all``): the image must carry
        the sequence's true tokens, length and next token.  ``tree_blocks``
        snapshots how many leading pages the radix tree backs at this
        instant — the pages ``resume`` will try to re-acquire by reference;
        a ceiling, not a promise, since LRU eviction may drop them before
        re-admission.  The page copy is staged (``_gather_pages``),
        bucket-padded with junk pages that the image slices off."""
        self._flush_all()
        n_ctx = int(self.lengths[seq.row])
        nb = self.alloc.blocks_for_tokens(max(n_ctx, 1))
        idx = np.zeros((_pow2_bucket(nb, self.n_pages),), np.int64)
        idx[:nb] = seq.blocks[:nb]
        tree_blocks = 0
        if self.prefix is not None:
            tree_blocks = self.prefix.live_prefix_blocks(seq.prompt, limit=nb)
        t_d2h = time.perf_counter()
        img_k, img_v = self._gather_pages(idx)
        self.profiler.observe("swap_d2h", time.perf_counter() - t_d2h)
        swap = _SwapState(
            rid=seq.rid, t_arrival=seq.t_arrival, prompt=seq.prompt,
            n_new=seq.n_new, priority=seq.priority, tokens=list(seq.tokens),
            remaining=seq.remaining, n_ctx=n_ctx,
            next_token=int(self._next[seq.row, 0]), t_first=seq.t_first,
            cached_tokens=seq.cached_tokens, preempts=seq.preempts + 1,
            img_k=img_k, img_v=img_v, n_blocks=nb, tree_blocks=tree_blocks,
            slo=seq.slo, deadline_s=seq.deadline_s)
        self.alloc.free(seq.blocks)      # decref: prefix-tree refs survive
        self._clear_row(seq)
        self.preemptions += 1
        return swap

    def _ensure_decode_capacity(self) -> List[_SwapState]:
        """Pre-decode pass under ``preemption=True``: grow every decoding
        row's block table to cover its next token write, swapping out
        victims when the arena (free list + evictable prefix blocks) runs
        dry.  Restarts after every mutation — ``_compact`` reshuffles rows,
        so cached indices would go stale."""
        swapped: List[_SwapState] = []
        while True:
            needy = None
            for i, s in enumerate(self.rows):
                if (s is not None and s.prefilled and s.remaining > 0
                        and self.alloc.blocks_for_tokens(
                            int(self.lengths[i]) + 1) > len(s.blocks)):
                    needy = s
                    break
            if needy is None:
                return swapped
            if self.alloc.num_free < 1 and self.prefix is not None:
                self.prefix.evict(1)
            if self.alloc.num_free >= 1:
                bid = self.alloc.alloc(1)[0]
                needy.blocks.append(bid)
                self.tables[needy.row, len(needy.blocks) - 1] = bid
                self._dirty = True       # table growth: mirrors changed
                continue
            if self._inflight or self._pending_first:
                # land in-flight work before choosing a victim: a pending
                # completion may release its blocks and spare the swap
                self._flush_all()
                continue
            victim = self._select_victim(exclude=needy) or needy
            swapped.append(self._swap_out(victim))

    def _release(self, seq: _PagedSeq) -> None:
        self.alloc.free(seq.blocks)      # decref: prefix-tree refs survive
        self._clear_row(seq)
        self._enforce_watermark()

    def _clear_row(self, seq: _PagedSeq) -> None:
        self.rows[seq.row] = None
        self.tables[seq.row, :] = 0
        self.lengths[seq.row] = 0
        self._next[seq.row, 0] = 0
        self._compact(seq.row)
        self._dirty = True               # release event: mirrors changed

    def _compact(self, hole: int) -> None:
        """Keep occupied rows a contiguous prefix: move the highest occupied
        row into the freed hole (host bookkeeping only — arena blocks never
        move), so ``tick`` decodes over a power-of-two row bucket instead of
        all ``max_seqs`` static rows."""
        last = max((i for i, s in enumerate(self.rows) if s is not None),
                   default=-1)
        if last <= hole:
            return
        seq = self.rows[last]
        self.rows[hole], self.rows[last] = seq, None
        seq.row = hole
        self.tables[hole] = self.tables[last]
        self.tables[last, :] = 0
        self.lengths[hole] = self.lengths[last]
        self.lengths[last] = 0
        self._next[hole, 0] = self._next[last, 0]
        self._next[last, 0] = 0

    def _row_buckets(self) -> List[int]:
        """Decode-batch buckets: the ``_bucket_ladder`` over ``max_seqs``."""
        return _bucket_ladder(self.max_seqs)

    def _page_buckets(self) -> List[int]:
        """Prefill KV-span buckets: the ``_bucket_ladder`` over ``n_pages``.
        A chunk's queries can only see the first ``n_past + true_c``
        positions, so the table is sliced to the smallest covering
        bucket."""
        return _bucket_ladder(self.n_pages)

    def _enforce_watermark(self) -> None:
        """Trim cache-only blocks until the free watermark holds, so the
        next admission draws from the free list instead of fighting the
        tree for whatever LRU eviction happens to surrender."""
        if self.prefix is None:
            return
        target = int(self.cache_watermark * self.alloc.num_allocatable)
        if self.alloc.num_free < target:
            self.prefix.evict(target - self.alloc.num_free)

    # --- serving -------------------------------------------------------------
    def _prefill_chunk(self, seq: _PagedSeq) -> None:
        """Advance one chunk of ``seq``'s prompt through the arena.  The
        final chunk's last-position logits yield the first generated token
        (never discarded), and the prompt's full blocks register in the
        prefix tree for future sharing.  The first token STAYS ON THE
        DEVICE: its argmax is dispatched with an async readback and the
        host records its value through the pipelined landing path."""
        start = seq.n_done
        true_c = min(self.chunk_tokens, len(seq.prompt) - start)
        padded = np.zeros((1, self.chunk_tokens), np.int32)
        padded[0, :true_c] = seq.prompt[start:start + true_c]
        # slice the visible KV span to its page bucket: this chunk's queries
        # end at start + true_c, so later pages are causally invisible
        span = _pow2_bucket(-(-(start + true_c) // self.block_size),
                            self.n_pages)
        _note_shape(self, ("prefill_paged", span))
        self.h2d_transfers += 2          # padded chunk + table-slice uploads
        logits = R.prefill_paged(self.params, {"tokens": self._put(padded)},
                                 self.arena,
                                 self._put(self.tables[seq.row][:span]),
                                 start, true_c)
        seq.n_done += true_c
        self.prefill_chunks += 1
        if seq.prefilled:
            tok = logits[0, true_c - 1].argmax().to(torch.int32)
            pf = _PendingFirst(seq, tok, _Readback(tok), self._tick_id)
            self._pending_first.append(pf)
            seq.pending_first = pf
            seq.remaining -= 1
            seq.t_first = time.perf_counter()
            self.lengths[seq.row] = len(seq.prompt)
            self._dirty = True           # row activation: mirrors changed
            if self.prefix is not None:
                self.prefix.insert(seq.prompt, seq.blocks)

    # --- pipelined landing ----------------------------------------------------
    def _land_first(self, pf: _PendingFirst) -> None:
        """Record a pending first token on the host.  Landing in the tick
        that created it is a forced (blocking) round-trip and counts as a
        ``host_syncs``; landing later overlapped host work for free."""
        seq = pf.seq
        if pf.tick_id == self._tick_id:
            self.host_syncs += 1
        first = int(pf.host.numpy())
        seq.tokens.append(first)         # tokens[0]: decode landings wait
        self._ev_emitted.append((seq.rid, first))
        seq.pending_first = None
        if pf in self._pending_first:
            self._pending_first.remove(pf)
        if self.rows[seq.row] is seq:
            self._next[seq.row, 0] = first

    def _land_item(self, item: _PendingDecode) -> None:
        """Land one dispatched decode call: wait for its (k, B) token
        readback, append tokens in dispatch order, advance the landing
        accumulators, and complete sequences whose final tokens arrived.
        A sequence's pending first token (if any) lands first — per-request
        token order is part of the greedy-parity contract."""
        if item.tick_id == self._tick_id:
            self.host_syncs += 1         # same-tick landing: no overlap
        t0 = time.perf_counter()
        toks = item.toks.numpy()         # waits for the readback's event
        t_land = time.perf_counter() - t0
        self._ld_s += item.dispatch_s + t_land
        self.profiler.observe("decode_dispatch", item.dispatch_s)
        self.profiler.observe("decode_land", t_land)
        self._ld_steps += item.k
        self._ld_occ = max(self._ld_occ, item.occupied)
        done: List[_PagedSeq] = []
        for s, col in item.rows:
            if s.pending_first is not None:
                self._land_first(s.pending_first)
            self._ld_rids.append(s.rid)
            for i in range(item.k):
                t = int(toks[i, col])
                s.tokens.append(t)
                self._ev_emitted.append((s.rid, t))
            s.pending_steps -= item.k
            self._next[s.row, 0] = int(toks[item.k - 1, col])
            if s.remaining <= 0 and s.pending_steps <= 0:
                done.append(s)
        for s in done:                   # release AFTER the sweep: _compact
            self._ev_finished.append(s)  # moves rows and would skew columns
            self._release(s)

    def _land_ready(self) -> None:
        """Collect readbacks dispatched BEFORE this tick — they overlapped
        at least one full tick of host work, so these landings are free (no
        ``host_syncs``)."""
        for pf in list(self._pending_first):
            if pf.tick_id < self._tick_id:
                self._land_first(pf)
        while self._inflight and self._inflight[0].tick_id < self._tick_id:
            self._land_item(self._inflight.popleft())

    def _flush_decodes(self) -> None:
        """Force-land every in-flight decode call (upload precondition:
        host mirrors must equal device state).  Pending FIRST tokens stay
        pending — the upload writes their device scalars into ``next``
        instead of waiting on them."""
        while self._inflight:
            self._land_item(self._inflight.popleft())

    def _flush_all(self) -> None:
        """Force-land everything, first tokens included — the synchronous
        reference loop, and the swap-out / victim-selection path, where the
        host image must carry the true tokens, lengths, and next token of
        every sequence."""
        self._flush_decodes()
        for pf in list(self._pending_first):
            self._land_first(pf)

    def _upload(self, B: int, active: np.ndarray) -> None:
        """Push fresh loop state (next, tables, lengths, active) for row
        bucket ``B`` — the EVENT path.  Unlanded first tokens are written
        into the uploaded ``next`` buffer as device scalars, so a prefill
        completion never blocks the loop on its own argmax."""
        assert not self._inflight, "upload with stale in-flight decodes"
        nxt = self._put(self._next[:B])
        for pf in self._pending_first:
            nxt[pf.seq.row, 0] = pf.tok
        self._dev = {"next": nxt,
                     "tables": self._put(self.tables[:B]),
                     "lengths": self._put(self.lengths[:B]),
                     "active": self._put(active[:B])}
        self.h2d_transfers += 4
        self._dev_B = B
        self._dev_active = active[:B].copy()
        self._dirty = False

    def _choose_k(self, act_rows: List[_PagedSeq]) -> int:
        """Fused-dispatch step count: ``fused_steps`` when every active row
        can absorb k on-device steps with zero host intervention — no
        prefill work queued, ``remaining >= k``, and block-table headroom
        for k more tokens — else 1.  Fusion equals k single steps, so
        eligibility only shapes dispatch granularity, never tokens."""
        k = self.fused_steps
        if k <= 1 or not self.pipeline or self._prefillq:
            return 1
        bs = self.block_size
        for s in act_rows:
            if (s.remaining < k
                    or len(s.blocks) * bs < int(self.lengths[s.row]) + k):
                return 1
        return k

    def _decodable(self) -> int:
        return sum(1 for s in self.rows
                   if s is not None and s.prefilled and s.remaining > 0)

    def _next_prefill(self, now: Optional[float]) -> int:
        """Index into ``_prefillq`` of the next chunk to advance, delegated
        to the engine's admission policy (FIFO or no policy: the head)."""
        if (self.policy is None or getattr(self.policy, "is_fifo", False)
                or len(self._prefillq) == 1):
            return 0
        return self.policy.select_prefill(list(self._prefillq), now)

    def tick(self, now: Optional[float] = None, allow_fused: bool = True
             ) -> Tuple[List[_PagedSeq], Dict[str, object]]:
        """One scheduler tick of the PIPELINED decode loop: an adaptive
        prefill budget, then one batched decode DISPATCH over all decoding
        rows (fused to ``fused_steps`` device-fed steps when eligible),
        then the LANDING of whatever readbacks finished overlapping earlier
        ticks.  ``now`` is the engine's session-relative clock, passed
        through to the policy ordering the prefill queue.

        Steady state touches the host ZERO times per tick: loop state lives
        on the device (``_dev``), the greedy token feeds back on the device,
        and tick N's (k, B) token block lands while tick N+1's dispatch is
        already queued.  Only EVENTS (admission, prefill completion,
        release, growth, preemption) dirty the mirrors and trigger a flush +
        one re-upload.

        Prefill policy: while the batch is decode-starved (fewer decodable
        rows than half the row capacity), burst up to ``chunk_burst``
        policy-ordered chunks, and back off to a SINGLE chunk per tick once
        decode concurrency is healthy."""
        self._tick_id += 1
        self._ev_emitted = []
        self._ev_finished = []
        self._ld_s = 0.0
        self._ld_steps = 0
        self._ld_occ = 0
        self._ld_rids = []
        prefill_rids: List[Tuple[int, float]] = []
        prefill_s = 0.0
        burst = 0
        while self._prefillq and burst < self.chunk_burst:
            if burst > 0 and self._decodable() >= max(
                    1, min(self.occupied, self.max_seqs // 2)):
                break                            # decode is busy: yield
            qi = self._next_prefill(now)
            seq = self._prefillq[qi]
            tc = time.perf_counter()
            self._prefill_chunk(seq)
            dtc = time.perf_counter() - tc
            prefill_rids.append((seq.rid, dtc))
            prefill_s += dtc
            burst += 1
            if seq.prefilled:
                del self._prefillq[qi]
                if seq.remaining <= 0:           # n_new == 1: the request IS
                    self._land_first(seq.pending_first)  # its first token
                    self._ev_finished.append(seq)
                    self._release(seq)
        # decode-time block pressure: grow tables on demand, swap victims
        # out when the arena is dry (PREEMPTED lifecycle state)
        preempted = self._ensure_decode_capacity() if self.preemption else []
        active = np.array([s is not None and s.prefilled and s.remaining > 0
                           for s in self.rows])
        occ = int(active.sum())
        B = self._dev_B
        if occ:
            # occupied rows are a compact prefix (see _compact): decode over
            # the smallest power-of-two row bucket covering them
            B = _pow2_bucket(self.occupied, self.max_seqs)
            if (self._dirty or self._dev is None or B != self._dev_B
                    or not self.pipeline
                    or not np.array_equal(active[:B], self._dev_active)):
                # EVENT path: land in-flight work (mirrors must equal the
                # device state), then push fresh loop state once
                self._flush_decodes()    # may release rows -> recompute
                active = np.array([s is not None and s.prefilled
                                   and s.remaining > 0 for s in self.rows])
                occ = int(active.sum())
                if occ:
                    B = _pow2_bucket(self.occupied, self.max_seqs)
                    self._upload(B, active)
        if occ:
            act_rows = [s for s in self.rows[:B]
                        if s is not None and s.prefilled and s.remaining > 0]
            k = self._choose_k(act_rows) if allow_fused else 1
            _note_shape(self, ("decode_multi", B, k))
            t1 = time.perf_counter()
            toks, nxt, ln = R.decode_paged_multi(
                self.params, self.arena, {"tokens": self._dev["next"]},
                self._dev["tables"], self._dev["lengths"],
                self._dev["active"], k)
            self._dev["next"], self._dev["lengths"] = nxt, ln
            readback = _Readback(toks)
            dispatch_s = time.perf_counter() - t1
            self.decode_dispatches += 1
            for s in act_rows:           # predictive mirrors: decremented at
                s.remaining -= k         # dispatch; truth lands later
                s.pending_steps += k
                self.lengths[s.row] += k
            self._inflight.append(_PendingDecode(
                readback, [(s, s.row) for s in act_rows], k, occ, dispatch_s,
                self._tick_id))
        # LANDING: readbacks dispatched before this tick overlapped a full
        # tick of host work — collect them for free; the synchronous
        # reference mode (pipeline=False) lands everything immediately
        if self.pipeline:
            self._land_ready()
        else:
            self._flush_all()
        return self._ev_finished, _tick_info(
            prefill_s=prefill_s, decode_s=self._ld_s,
            decode_steps=self._ld_steps, occupied=self._ld_occ,
            blocks_in_use=self.alloc.blocks_in_use(),
            prefill_rids=prefill_rids, decode_rids=self._ld_rids,
            emitted=self._ev_emitted, preempted=preempted)


# =============================================================================
# engine
# =============================================================================
class _Session:
    """One serve session's bookkeeping: the policy queue, the open-loop
    release schedule, per-request energy meters, swapped-out images, the
    admission gate, and the aggregate counters ``stats`` reports."""

    def __init__(self, core: SchedulerCore, instances,
                 registry: MetricsRegistry,
                 tracer: Optional[TraceRecorder] = None) -> None:
        self.core = core
        self.registry = registry
        self.tracer = tracer
        self.span_ids: Dict[int, int] = {}       # rid → "request" span sid
        self.preempt_sids: Dict[int, int] = {}   # rid → open "preempted" sid
        self.t0 = time.perf_counter()
        self.future: List[Tuple[float, int, int]] = []   # (t_abs, seq, rid)
        self._fseq = 0
        self.requests: Dict[int, InferenceRequest] = {}
        self.meters: Dict[int, float] = {}
        self.swapped: Dict[int, _SwapState] = {}
        self.variant_of: Dict[int, str] = {}     # rid → decided ladder rung
        self.admit_gate: Dict[int, Tuple] = {}           # id(inst) → (rid, sig)
        self.admit_t: Dict[int, float] = {}
        self.responses: List[InferenceResponse] = []
        self.energy = 0.0
        self.decode_steps = 0
        self.occ_frac_sum = 0.0
        self.inflight_sum = 0
        self.admitted_sum = 0
        self.tick_samples = 0
        self.blocks_peak = 0
        self.preempt_total = 0
        self.progressed = False
        # wall seconds already charged per instance (prefill + decode); the
        # remainder of the serve wall is charged at idle power at drain, so
        # an allocated-but-idle instance is never free
        self.accounted_s = {id(i): 0.0 for i in instances}
        # instance counters are lifetime (they survive reset/warm reuse);
        # stats report THIS session's delta
        self.counters0 = {name: sum(getattr(i, name, 0) for i in instances)
                          for name in _INSTANCE_COUNTERS}

    def schedule(self, req: InferenceRequest) -> None:
        if req.arrival_s is None:
            self.core.submit(req.rid, self.t0, priority=req.priority,
                             deadline_s=req.deadline_s, slo=req.slo)
        else:
            heapq.heappush(self.future,
                           (self.t0 + float(req.arrival_s), self._fseq,
                            req.rid))
            self._fseq += 1

    def rel(self, now: float) -> float:
        """Session-relative seconds — the clock policies see."""
        return now - self.t0


# lifetime instance counters a session reports as deltas, by stats name (a
# slotted instance has no prefill chunks, prefix hits or swap-ins: it
# counts 0); ``swapin_pages_total`` is folded into
# ``partial_swapin_pages_saved`` at finalize
_INSTANCE_COUNTERS = {"prefill_chunks": "prefill_chunks",
                      "prefix_hit_tokens": "prefix_hit_tokens",
                      "swapin_pages_total": "swapin_pages_total",
                      "swapin_pages_copied": "swapin_pages_copied",
                      "retraces": "compile_retraces",
                      "host_syncs": "host_syncs",
                      "h2d_transfers": "h2d_transfers",
                      "decode_dispatches": "decode_dispatches"}


class RealEngine:
    """Maps a ConfigGraph onto slotted or paged instances and serves
    :class:`InferenceRequest`s with continuous batching through the
    ``ServingBackend`` protocol, measuring wall latencies and attributing
    occupancy-scaled energy (the reference's power model,
    ``core.perf_model``) and carbon (``ci_g_per_kwh``) per request.

    ``device`` is where the family's weights live (the GPU by default; the
    CPU on request).  The reference's ``mesh`` and ``roles`` are not ported
    yet and raise ``NotImplementedError``."""

    def __init__(self, family: Sequence[EngineVariant], n_slots: int = 4,
                 max_len: int = 96, *, kv_layout: str = "slotted",
                 block_size: int = 16, n_blocks: Optional[int] = None,
                 max_seqs: Optional[int] = None, chunk_blocks: int = 2,
                 prefix_caching: bool = True,
                 policy: Union[str, SchedulerPolicy, None] = "fifo",
                 preemption: bool = False, ci_g_per_kwh: float = 0.0,
                 telemetry: Optional[Telemetry] = None,
                 decode_pipeline: bool = True, fused_steps: int = 8,
                 quality_selector=None, mesh=None, roles=None,
                 device: Optional[Union[str, torch.device]] = None):
        unported = {"mesh": mesh is not None, "roles": bool(roles)}
        missing = [k for k, v in unported.items() if v]
        if missing:
            raise NotImplementedError(
                f"not ported yet: {', '.join(missing)}")
        if kv_layout not in ("slotted", "paged"):
            raise ValueError(f"unknown kv_layout {kv_layout!r}")
        if preemption and kv_layout == "slotted":
            raise ValueError("preemption requires the paged KV layout "
                             "(slots never grow)")
        self.device = resolve_device(device)
        for ev in family:
            where = {p.device for p in ev.params.parameters()}
            if where != {self.device}:
                raise ValueError(f"variant {ev.variant.name} lives on "
                                 f"{sorted(map(str, where))}, engine on "
                                 f"{self.device}")
        self.family = {ev.variant.name: ev for ev in family}
        self.instances: List[Union[Instance, PagedInstance]] = []
        self.n_slots = n_slots
        self.max_len = max_len
        self.kv_layout = kv_layout
        self.block_size = block_size
        # equal-arena default: the paged pool holds exactly the KV tokens a
        # slotted cache of n_slots × max_len would reserve, plus the junk
        # block
        self.n_blocks = (n_blocks if n_blocks is not None
                         else -(-n_slots * max_len // block_size) + 1)
        self.max_seqs = max_seqs if max_seqs is not None else 4 * n_slots
        self.chunk_blocks = chunk_blocks
        self.prefix_caching = prefix_caching
        self.policy = make_policy(policy)
        # mixed-quality request path: the selector decides each request's
        # ladder rung at submit; admission then only places it on instances
        # of that variant (serving.quality — name, instance, or None)
        self.quality_selector = make_selector(quality_selector)
        self.preemption = preemption
        # decode hot path: ``decode_pipeline=False`` selects the synchronous
        # reference loop (re-upload + blocking readback every tick) — the
        # greedy-parity oracle; ``fused_steps`` bounds on-device step fusion
        self.decode_pipeline = decode_pipeline
        self.fused_steps = fused_steps
        self.ci_g_per_kwh = ci_g_per_kwh
        # optional telemetry bundle: the engine repoints its ``registry`` at
        # every session open (per-session registries) and emits lifecycle
        # spans into its persistent ``tracer``; its ``feed`` receives one
        # exact (wall, joules, grams) segment per session
        self.telemetry = telemetry
        # one engine-owned phase profiler shared by every instance; its
        # registry is repointed at each session open (and set to None when
        # no telemetry bundle is attached, so the un-instrumented hot path
        # stays a single attribute check)
        self.profiler = PhaseProfiler()
        self.last_registry: Optional[MetricsRegistry] = None
        self._feed_clock = 0.0           # feed-time seconds across sessions
        self._pool: Dict[Tuple[str, int],
                         List[Union[Instance, PagedInstance]]] = {}
        self._session: Optional[_Session] = None
        self._last_stats: Dict[str, float] = {}
        self.last_reconfig_s = 0.0
        self.last_admit_order: List[int] = []
        self.last_outputs: Dict[int, np.ndarray] = {}
        self.last_latencies: List[float] = []
        self.last_responses: List[InferenceResponse] = []

    def _new_instance(self, ev: EngineVariant, chips: int
                      ) -> Union[Instance, PagedInstance]:
        if self.kv_layout == "paged":
            return PagedInstance(ev, chips, n_blocks=self.n_blocks,
                                 block_size=self.block_size,
                                 max_seqs=self.max_seqs,
                                 max_len=self.max_len,
                                 chunk_blocks=self.chunk_blocks,
                                 prefix_caching=self.prefix_caching,
                                 preemption=self.preemption,
                                 policy=self.policy,
                                 pipeline=self.decode_pipeline,
                                 fused_steps=self.fused_steps)
        return Instance(ev, chips, self.n_slots, self.max_len)

    def configure(self, graph) -> float:
        """Apply a configuration graph; returns reconfig seconds (measured).

        Warm path: instances are returned to a (variant, chips) pool and
        reused — weights and KV caches survive controller re-invocations;
        only genuinely new (variant, chips) pairs pay allocation and
        warmup.  The seconds are also kept as ``last_reconfig_s``."""
        assert self._session is None, "configure during an open serve session"
        t0 = time.perf_counter()
        for inst in self.instances:
            self._pool.setdefault((inst.ev.variant.name, inst.chips),
                                  []).append(inst)
        self.instances = []
        for (vname, chips), w in graph.edges:
            for _ in range(w):
                warm = self._pool.get((vname, chips), [])
                if warm:
                    inst = warm.pop()
                    inst.reset()
                else:
                    inst = self._new_instance(self.family[vname], chips)
                    inst.warmup()
                inst.profiler = self.profiler
                self.instances.append(inst)
        self.last_reconfig_s = time.perf_counter() - t0
        return self.last_reconfig_s

    # --- ServingBackend protocol ---------------------------------------------
    def submit(self, req: InferenceRequest) -> None:
        """Enqueue a typed request.  The first submit after idle opens a
        session (t0 = now); ``arrival_s`` schedules an open-loop release
        relative to it."""
        assert self.instances, "configure() first"
        if self._session is None:
            reg = MetricsRegistry.standard(f"real-{self.kv_layout}",
                                           labels={"kv_layout":
                                                   self.kv_layout})
            tel = self.telemetry
            if tel is not None:
                tel.registry = reg       # per-session registry (see obs)
            # phase profiling rides the telemetry opt-in: without a bundle
            # the profiler stays disabled and the hot path pays nothing
            self.profiler.registry = reg if tel is not None else None
            self.policy.reset_holds()    # rids repeat across sessions
            self._session = _Session(
                SchedulerCore(self.policy), self.instances, reg,
                tracer=tel.tracer if tel is not None else None)
            self.last_registry = reg
            self.last_admit_order = []
            self.last_outputs = {}
            if self.quality_selector is not None:
                # bind the selector to the rungs this configuration can
                # actually serve (deduped by name, any instance count)
                ladder = {inst.ev.variant.name: inst.ev.variant
                          for inst in self.instances}
                self.quality_selector.reset(list(ladder.values()))
        s = self._session
        assert req.rid not in s.requests, f"duplicate rid {req.rid}"
        s.requests[req.rid] = req
        s.meters[req.rid] = 0.0
        if self.quality_selector is not None:
            s.variant_of[req.rid] = self.quality_selector.select(req).variant
        s.registry.counter("requests_submitted").inc()
        s.schedule(req)

    def step(self) -> List[InferenceResponse]:
        """One scheduler pass: release due arrivals, run policy admission
        over every instance (gated re-attempts), then one tick (≤ one
        prefill chunk burst + one batched decode dispatch) per busy
        instance.  Returns the requests that completed on this pass."""
        s = self._session
        if s is None:
            return []
        now = time.perf_counter()
        now_rel = s.rel(now)
        s.progressed = False
        completed: List[InferenceResponse] = []
        while s.future and s.future[0][0] <= now:
            t_arr, _, rid = heapq.heappop(s.future)
            req = s.requests[rid]
            s.core.submit(rid, t_arr, priority=req.priority,
                          deadline_s=req.deadline_s, slo=req.slo)
        # 1. admission: peek the policy's next choice and place it on the
        #    first instance with capacity (rows and blocks) — mid-flight, so
        #    rows/blocks freed by the previous tick's completions refill.
        #    A failed fit is GATED per instance: no re-attempt until the
        #    queue head or the instance's free capacity actually changes.
        for inst in self.instances:
            while True:
                nxt = s.core.peek_next(now_rel)
                if nxt is None:
                    break
                rid, t_arr = nxt
                # mixed-quality routing: the queue head only admits onto
                # instances of its decided rung (head-of-line blocking on a
                # variant-busy head is deliberate, as in the reference).
                # Also keeps preempted swap images on their own variant.
                want = s.variant_of.get(rid)
                if want is not None and inst.ev.variant.name != want:
                    break
                sig = inst.admission_signature()
                if s.admit_gate.get(id(inst)) == (rid, sig):
                    break                # nothing changed since last failure
                req = s.requests[rid]
                swap = s.swapped.get(rid)
                fits = (inst.can_resume(swap) if swap is not None
                        else inst.can_admit(req.prompt_len,
                                            req.max_new_tokens))
                if not fits:
                    s.admit_gate[id(inst)] = (rid, sig)
                    break
                s.admit_gate.pop(id(inst), None)
                s.core.pop_next(now_rel)
                t1 = time.perf_counter()
                if swap is not None:
                    state, dt = inst.resume(swap)
                    del s.swapped[rid]
                    if s.tracer is not None:
                        t_res = s.rel(time.perf_counter())
                        sid = s.preempt_sids.pop(rid, None)
                        if sid is not None:
                            s.tracer.close_span(sid, t_res,
                                                pages=swap.n_blocks)
                        s.tracer.instant("swap_in", t_res, rid=rid)
                else:
                    state, dt = inst.admit_next(rid, t_arr, req.prompt,
                                                req.max_new_tokens,
                                                priority=req.priority,
                                                slo=req.slo,
                                                deadline_s=req.deadline_s)
                    s.admit_t[rid] = t1
                    self.last_admit_order.append(rid)
                    if state.tokens and req.on_token is not None:
                        req.on_token(rid, state.tokens[0])   # slotted first
                    if s.tracer is not None:
                        s.tracer.instant("admit", s.rel(t1), rid=rid)
                if dt > 0:               # the slotted layout prefills here
                    self.profiler.observe("prefill_chunk", dt)
                e_pf = inst.chips * PM.P_BUSY_W * dt   # prefill: busy power
                s.energy += e_pf
                s.meters[rid] += e_pf
                s.accounted_s[id(inst)] += dt
                s.progressed = True
                if state.remaining <= 0 and state.tokens:    # n_new == 1
                    completed.append(self._finish(state, inst))
        # 2. one tick per busy instance (≤ 1 prefill burst + 1 decode)
        for inst in self.instances:
            if not inst.busy:
                continue
            s.progressed = True
            s.admitted_sum += inst.occupied   # holding cache memory now
            s.tick_samples += 1
            t_tick = time.perf_counter()
            # fused multi-step dispatch stays off while timed arrivals are
            # outstanding: an open-loop session measures admission latency,
            # and a k-step device window would delay a mid-window arrival's
            # prefill behind k queued decode steps
            done, info = inst.tick(s.rel(t_tick), allow_fused=not s.future)
            s.energy += inst.chips * PM.P_BUSY_W * info["prefill_s"]
            for rid, dtc in info["prefill_rids"]:
                s.meters[rid] += inst.chips * PM.P_BUSY_W * dtc
                inst.profiler.observe("prefill_chunk", dtc)
            if info["decode_steps"]:
                # info describes LANDED decode work: ``decode_steps`` model
                # steps sharing ``decode_s`` wall seconds — aggregates stay
                # step-weighted so occupancy/inflight means are comparable
                # across fused and single-step sessions
                ksteps = info["decode_steps"]
                occ = info["occupied"]
                e_dec = PM.instance_power_w(
                    inst.chips, occ / inst.capacity) * info["decode_s"]
                s.energy += e_dec
                share = e_dec / max(len(info["decode_rids"]), 1)
                for rid in info["decode_rids"]:
                    s.meters[rid] += share
                s.decode_steps += ksteps
                s.occ_frac_sum += (occ / inst.capacity) * ksteps
                s.inflight_sum += occ * ksteps
            s.accounted_s[id(inst)] += info["prefill_s"] + info["decode_s"]
            s.blocks_peak = max(s.blocks_peak, int(info["blocks_in_use"]))
            s.registry.gauge("occupied_rows").set(info["occupied"])
            s.registry.gauge("blocks_in_use").set(info["blocks_in_use"])
            if s.tracer is not None:
                self._trace_tick(s, inst, t_tick, info)
            for rid, tok in info["emitted"]:
                cb = s.requests[rid].on_token
                if cb is not None:
                    cb(rid, tok)
            for swap in info["preempted"]:
                req = s.requests[swap.rid]
                s.swapped[swap.rid] = swap
                s.preempt_total += 1
                if s.tracer is not None:
                    t_sw = s.rel(time.perf_counter())
                    s.tracer.instant("swap_out", t_sw, rid=swap.rid,
                                     pages=swap.n_blocks)
                    s.preempt_sids[swap.rid] = s.tracer.open_span(
                        "preempted", t_sw, rid=swap.rid)
                s.core.requeue_front(swap.rid, swap.t_arrival,
                                     priority=req.priority,
                                     deadline_s=req.deadline_s,
                                     slo=req.slo)
            for state in done:
                completed.append(self._finish(state, inst))
        return completed

    @staticmethod
    def _trace_tick(s: _Session, inst, t_tick: float,
                    info: Dict[str, object]) -> None:
        """One tick on the trace: its prefill chunks back-to-back from the
        tick start, then one ``decode_tick`` span per LANDED model step (a
        fused dispatch lands k steps at once, so the span count equals the
        session's ``decode_steps``) carrying the occupant set, then the
        engine track's counters — arena/slot occupancy and the tick's power
        under the model that charges the energy."""
        tr = s.tracer
        cursor = s.rel(t_tick)
        for rid, dtc in info["prefill_rids"]:
            tr.span("prefill_chunk", cursor, cursor + dtc, rid=rid)
            cursor += dtc
        if info["decode_steps"]:
            dt_step = info["decode_s"] / info["decode_steps"]
            for _ in range(info["decode_steps"]):
                tr.span("decode_tick", cursor, cursor + dt_step,
                        rids=info["decode_rids"], n=info["occupied"])
                cursor += dt_step
            p_w = PM.instance_power_w(inst.chips,
                                      info["occupied"] / inst.capacity)
        elif info["prefill_s"] > 0:
            p_w = inst.chips * PM.P_BUSY_W
        else:
            p_w = inst.chips * PM.P_IDLE_W
        tr.counter("blocks_in_use", cursor, info["blocks_in_use"])
        tr.counter("occupied_rows", cursor, info["occupied"])
        tr.counter("power_w", cursor, p_w)

    def drain(self) -> List[InferenceResponse]:
        """Run the session to completion; returns every response.  Closes
        the session: the idle-power floor is spread across the responses,
        carbon is attributed at ``ci_g_per_kwh``, and ``stats()`` reports
        the aggregates."""
        s = self._session
        if s is None:
            return []
        stalled_once = False
        while s.future or s.core.has_pending() \
                or any(i.busy for i in self.instances):
            self.step()
            if s.progressed:
                stalled_once = False
                continue
            now = time.perf_counter()
            if s.future and not s.core.has_pending():
                # open-loop idle gap: nothing in flight, next arrival in
                # the future — sleep up to it instead of busy-spinning
                time.sleep(min(max(s.future[0][0] - now, 0.0), 0.01))
            elif s.core.has_pending():
                if s.core.peek_next(s.rel(now)) is None:
                    # policy hold (carbon-aware deferral): wait for the
                    # clock/CI to move, the queue is intentionally parked
                    time.sleep(0.001)
                elif not stalled_once:
                    # a policy hold may have crossed its release boundary
                    # in the gap between step()'s select and this peek —
                    # a releasable head is only a STALL if another full
                    # step still cannot place it
                    stalled_once = True
                else:
                    raise RuntimeError(
                        "admission stalled: head request fits no instance")
        self._finalize(s)
        return s.responses

    def stats(self) -> Dict[str, float]:
        """Aggregate metrics of the last drained session."""
        return dict(self._last_stats)

    # --- internals -----------------------------------------------------------
    def _finish(self, state: Union[_SlotState, _PagedSeq],
                inst: Union[Instance, PagedInstance]) -> InferenceResponse:
        s = self._session
        req = s.requests[state.rid]
        t_fin = time.perf_counter()
        s.core.complete(state.rid, state.t_arrival, t_fin,
                        inst.ev.variant.accuracy)
        self.last_outputs[state.rid] = np.asarray(state.tokens, np.int64)
        ttft = (state.t_first - state.t_arrival
                if state.t_first is not None else 0.0)
        hold = self.policy.hold_info(state.rid)
        resp = InferenceResponse(
            rid=state.rid, tokens=np.asarray(state.tokens, np.int64),
            slo=req.slo, priority=req.priority, state=DONE,
            t_arrival=state.t_arrival - s.t0, t_finish=t_fin - s.t0,
            queue_delay_s=s.admit_t[state.rid] - state.t_arrival,
            ttft_s=ttft, latency_s=t_fin - state.t_arrival,
            energy_j=s.meters[state.rid], preemptions=state.preempts,
            accuracy=inst.ev.variant.accuracy,
            variant=inst.ev.variant.name, deadline_s=req.deadline_s,
            held_s=hold[1] - hold[0] if hold is not None else 0.0,
            release_reason=hold[2] if hold is not None else None)
        s.responses.append(resp)
        reg = s.registry
        reg.counter("requests_served").inc()
        reg.counter("tokens_generated").inc(resp.n_tokens)
        reg.histogram("latency_s").observe(resp.latency_s)
        reg.labeled("latency_s", slo_class=req.slo).observe(resp.latency_s)
        reg.histogram("queue_delay_s").observe(resp.queue_delay_s)
        if state.t_first is not None:
            reg.histogram("ttft_s").observe(ttft)
            reg.labeled("ttft_s", slo_class=req.slo).observe(ttft)
        reg.histogram("accuracy").observe(resp.accuracy)
        reg.labeled("accuracy", slo_class=req.slo).observe(resp.accuracy)
        if not resp.deadline_met:
            reg.counter("deadline_misses").inc()
        if hold is not None:
            reg.counter("holds_released").inc()
            reg.histogram("held_s").observe(resp.held_s)
        if s.tracer is not None:
            # the root lifecycle span, reconstructed now that the request's
            # bounds are known; _finalize annotates the final joules/grams
            # (the idle-floor share only exists at drain)
            s.span_ids[state.rid] = s.tracer.span(
                "request", state.t_arrival - s.t0, t_fin - s.t0,
                rid=state.rid, slo=req.slo, n_tokens=resp.n_tokens,
                queue_delay_s=resp.queue_delay_s,
                preemptions=state.preempts)
            if hold is not None:
                s.tracer.span("hold", hold[0], hold[1], rid=state.rid,
                              reason=hold[2])
        return resp

    def _finalize(self, s: _Session) -> None:
        wall = time.perf_counter() - s.t0
        for inst in self.instances:       # idle floor for unaccounted wall
            idle_s = max(wall - s.accounted_s[id(inst)], 0.0)
            s.energy += inst.chips * PM.P_IDLE_W * idle_s
        # attribute the idle floor + carbon: per-request joules sum to the
        # engine total, gCO2 = joules × the serving window's intensity
        attributed = sum(r.energy_j for r in s.responses)
        idle_share = ((s.energy - attributed) / len(s.responses)
                      if s.responses else 0.0)
        for r in s.responses:
            r.energy_j += idle_share
            r.carbon_g = r.energy_j / 3.6e6 * self.ci_g_per_kwh
            if s.tracer is not None and r.rid in s.span_ids:
                s.tracer.annotate(s.span_ids[r.rid], energy_j=r.energy_j,
                                  carbon_g=r.carbon_g)
        self.last_latencies = s.core.latencies
        self.last_responses = s.responses
        # session deltas of the instances' lifetime counters (instances
        # survive warm reconfiguration)
        delta = {stat: sum(getattr(i, name, 0) for i in self.instances)
                 - s.counters0[name]
                 for name, stat in _INSTANCE_COUNTERS.items()}
        # partial swap-in: pages a full restore would have copied vs pages
        # actually written back (the gap = tree-resident reuse)
        saved = delta.pop("swapin_pages_total") - delta["swapin_pages_copied"]
        total_g = s.energy / 3.6e6 * self.ci_g_per_kwh
        # fold the session totals into the registry; ``_last_stats`` below
        # is a *view* over it
        reg = s.registry
        reg.counter("energy_j").inc(s.energy)
        reg.counter("carbon_g").inc(total_g)
        reg.counter("decode_steps").inc(s.decode_steps)
        reg.counter("preemptions").inc(s.preempt_total)
        reg.counter("swapin_pages_saved").inc(saved)
        for stat, value in delta.items():
            reg.counter(stat).inc(value)
        reg.gauge("wall_s").set(wall)
        served = int(reg.value("requests_served"))
        total_tokens = int(reg.value("tokens_generated"))
        lat = reg.histogram("latency_s")
        self._last_stats = {
            "served": served,
            "p50_s": lat.percentile(50.0),
            "p95_s": lat.percentile(95.0),
            "p99_s": lat.percentile(99.0),
            "mean_accuracy": reg.histogram("accuracy").mean,
            "energy_j": reg.value("energy_j"),
            "carbon_g": reg.value("carbon_g"),
            "wall_s": wall,
            "tokens": total_tokens,
            "tokens_per_s": total_tokens / max(wall, 1e-9),
            "j_per_token": s.energy / max(total_tokens, 1),
            "decode_steps": s.decode_steps,
            "mean_occupancy": (s.occ_frac_sum / s.decode_steps
                               if s.decode_steps else 0.0),
            "mean_inflight": (s.inflight_sum / s.decode_steps
                              if s.decode_steps else 0.0),
            # sequences holding cache memory per tick (decoding OR mid-
            # chunked-prefill) — the sustained admitted concurrency
            "mean_admitted": (s.admitted_sum / s.tick_samples
                              if s.tick_samples else 0.0),
            "queue_delay_p95_s":
                reg.histogram("queue_delay_s").percentile(95.0),
            "ttft_p50_s": reg.histogram("ttft_s").percentile(50.0),
            "ttft_p95_s": reg.histogram("ttft_s").percentile(95.0),
            "blocks_peak": s.blocks_peak,
            "preemptions": s.preempt_total,
            "partial_swapin_pages_saved": saved,
            # decode-hot-path traffic: blocking host round-trips, explicit
            # H2D uploads (event-driven only under pipelining), and decode
            # dispatches (< decode_steps when fusion engaged)
            **delta,
        }
        if self.telemetry is not None and self.telemetry.feed is not None:
            # one exact segment per session: feed totals stay equal to the
            # engine's charged joules/grams with no re-derivation
            self.telemetry.feed.record_segment(self._feed_clock, wall,
                                               s.energy, total_g)
        self._feed_clock += wall
        self._session = None

    # --- bulk-prompt convenience ---------------------------------------------
    def _serve_prompts(self, prompts: Sequence[np.ndarray], n_new: int = 8,
                       arrival_s: Optional[Sequence[float]] = None
                       ) -> Dict[str, float]:
        """Method shorthand for :func:`serving.api.serve_prompts`."""
        return serve_prompts(self, prompts, n_new, arrival_s)

    def serve_poisson(self, rate_rps: float, n_requests: int,
                      prompt_lens: Sequence[int] = (6,), n_new: int = 8,
                      seed: int = 0) -> Dict[str, float]:
        """Open-loop serving under Poisson arrivals at ``rate_rps``: prompts
        cycle through ``prompt_lens`` (random tokens), inter-arrival gaps
        are exponential.  Returns the session stats plus the offered
        rate."""
        rng = np.random.default_rng(seed)
        vocab = next(iter(self.family.values())).cfg.vocab_size
        prompts = [rng.integers(0, vocab,
                                size=(int(prompt_lens[i % len(prompt_lens)]),)
                                ).astype(np.int32)
                   for i in range(n_requests)]
        arrivals = np.cumsum(rng.exponential(1.0 / rate_rps, n_requests))
        m = self._serve_prompts(prompts, n_new=n_new,
                                arrival_s=arrivals.tolist())
        m["offered_rps"] = rate_rps
        return m
