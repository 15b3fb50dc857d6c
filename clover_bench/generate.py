"""The one traffic generator: a mix file (``traffic/<mix>.json``) and a
seed give the requests, their due times and their token contents.

Every drawn quantity (a length, a prefix choice, a class, a gap between
arrivals) comes from stratified blocks: each block of ``BLOCK`` draws
holds the same set of quantiles of the stated distribution, in an order
shuffled by the mix file's ``layout_seed``.  So the sizes and arrivals,
and with them a run's work, are the same under every seed; the run's
seed draws the tokens (and the benchmark's weights), so the served
answers differ from seed to seed.

A mix file holds::

    loop        "closed" (``clients`` clients, each sends its next
                request when the last completes) or "open" (Poisson
                arrivals at ``rate_rps``)
    prefix      optional shared prefixes: ``count`` of them, lengths
                ``len``, chosen by ``popularity`` ("uniform" or
                {"zipf": s}) for a ``share`` of the requests
    suffix      the length of each request's own tokens (a document's
                question, a chat's user turn, a whole random prompt)
    output      the answer budget (max_new_tokens)
    classes     SLO classes with their shares and quality hints
    residual    closed loop: each client's first request keeps a budget
                drawn uniformly from 1 to its drawn length; the rest of
                that length is added to its prompt (the answer so far)

A length is {"dist": "uniform", "lo", "hi"} (whole numbers, both ends
included) or {"dist": "lognormal", "median", "sigma", "lo", "hi"}
(clipped).
"""
from __future__ import annotations

import dataclasses
import math
from typing import Dict, List, Optional, Sequence

import numpy as np

BLOCK = 64          # draws per stratified block


@dataclasses.dataclass
class Request:
    """One generated request: its prompt, budget, class and hint."""
    prompt: np.ndarray
    max_new_tokens: int
    slo: str
    hint: Optional[str]
    prefix_id: int           # -1: no shared prefix


def _quantile_len(spec: Dict, u: np.ndarray) -> np.ndarray:
    """Lengths at the uniform quantiles ``u`` of a length spec."""
    lo, hi = int(spec["lo"]), int(spec["hi"])
    if spec["dist"] == "uniform":
        return np.minimum(lo + np.floor(u * (hi - lo + 1)), hi).astype(
            np.int64)
    if spec["dist"] == "lognormal":
        from statistics import NormalDist
        z = np.array([NormalDist().inv_cdf(float(x)) for x in u])
        v = float(spec["median"]) * np.exp(float(spec["sigma"]) * z)
        return np.clip(np.rint(v), lo, hi).astype(np.int64)
    raise ValueError(f"unknown length distribution {spec['dist']!r}")


def stratified(rng: np.random.Generator, n: int, block: int = BLOCK
               ) -> np.ndarray:
    """``n`` uniforms: each block of ``block`` holds the midpoints
    (j + 0.5) / block of its strata, shuffled by ``rng``."""
    out = np.empty((n,), np.float64)
    mids = (np.arange(block) + 0.5) / block
    for b0 in range(0, n, block):
        m = min(block, n - b0)
        out[b0:b0 + m] = rng.permutation(mids)[:m]
    return out


def _categorical(weights: Sequence[float], u: np.ndarray) -> np.ndarray:
    """Indices drawn at quantiles ``u`` of the weights' distribution."""
    cdf = np.cumsum(np.asarray(weights, np.float64))
    cdf /= cdf[-1]
    return np.minimum(np.searchsorted(cdf, u, side="right"), len(cdf) - 1)


def _popularity(spec, count: int) -> np.ndarray:
    if spec == "uniform":
        return np.ones((count,))
    s = float(spec["zipf"])
    return 1.0 / np.arange(1, count + 1) ** s


class Traffic:
    """The requests of one mix under one seed, made on demand in a fixed
    order: ``request(i)`` is the same for a seed whatever the timing, and
    its sizes the same for every seed."""

    def __init__(self, mix: Dict, seed: int, vocab: int):
        self.mix = mix
        self.vocab = int(vocab)
        self.seed = int(seed)
        self.closed = mix["loop"] == "closed"
        self._rng_tokens = np.random.default_rng([self.seed, 0xC10E])
        self.layout = int(mix["layout_seed"])
        # shared prefixes: lengths by the layout seed, tokens by the run's
        pre = mix.get("prefix")
        self.prefixes: List[np.ndarray] = []
        if pre:
            lay = np.random.default_rng(self.layout)
            n = int(pre["count"])
            lens = _quantile_len(pre["len"], stratified(lay, n, n))
            self.prefixes = [self._tokens(int(x)) for x in lens]
            self._pop = _popularity(pre["popularity"], n)
        self._cache: Dict[int, Request] = {}
        self._block_cache: Dict[int, Dict[str, np.ndarray]] = {}
        self._gaps: List[float] = []

    # --- tokens ------------------------------------------------------------
    def _tokens(self, n: int) -> np.ndarray:
        return self._rng_tokens.integers(0, self.vocab, size=(n,),
                                         dtype=np.int64).astype(np.int32)

    # --- sizes, by stratified blocks --------------------------------------
    def _block(self, b: int) -> Dict[str, np.ndarray]:
        """The drawn quantities of block ``b`` (requests b*BLOCK ...)."""
        if b in self._block_cache:
            return self._block_cache[b]
        rng = np.random.default_rng([self.layout, 0xB10C, b])
        mix = self.mix
        d = {"suffix": _quantile_len(mix["suffix"], stratified(rng, BLOCK)),
             "output": _quantile_len(mix["output"], stratified(rng, BLOCK))}
        pre = mix.get("prefix")
        if pre:
            has = stratified(rng, BLOCK) < float(pre["share"])
            pick = _categorical(self._pop, stratified(rng, BLOCK))
            d["prefix"] = np.where(has, pick, -1)
        else:
            d["prefix"] = np.full((BLOCK,), -1)
        classes = mix.get("classes") or [{"slo": "interactive",
                                          "share": 1.0}]
        d["class"] = _categorical([c["share"] for c in classes],
                                  stratified(rng, BLOCK))
        d["hint_u"] = stratified(rng, BLOCK)
        if self.closed and mix.get("residual"):
            d["residual_u"] = stratified(rng, BLOCK)
        self._block_cache[b] = d
        return d

    def request(self, i: int) -> Request:
        """The ``i``-th request of the stream (tokens made once, in order
        of first use, from the seed's token stream)."""
        if i in self._cache:
            return self._cache[i]
        for j in range(len(self._cache), i + 1):
            self._cache[j] = self._make(j)
        return self._cache[i]

    def _make(self, i: int) -> Request:
        d = self._block(i // BLOCK)
        k = i % BLOCK
        classes = self.mix.get("classes") or [{"slo": "interactive",
                                               "share": 1.0}]
        cls = classes[int(d["class"][k])]
        hint = None
        if cls.get("hints"):
            names = sorted(cls["hints"])
            hint = names[int(_categorical([cls["hints"][n] for n in names],
                                          d["hint_u"][k:k + 1])[0])]
        pid = int(d["prefix"][k])
        own = self._tokens(int(d["suffix"][k]))
        prompt = own if pid < 0 else np.concatenate([self.prefixes[pid],
                                                     own])
        n_new = int(d["output"][k])
        if "residual_u" in d and i < int(self.mix["clients"]):
            # a client's first request joins mid-answer: of its budget the
            # part still to come when the window opens, the part already
            # made standing in the prompt as context, so rows start at
            # staggered progress and at their contexts' lengths
            left = max(1, int(math.ceil(d["residual_u"][k] * n_new)))
            prompt = np.concatenate([prompt, self._tokens(n_new - left)])
            n_new = left
        return Request(prompt, n_new, cls["slo"], hint, pid)

    def warm_prompts(self, n: int) -> List[np.ndarray]:
        """``n`` prompts that are shared prefixes alone, each drawn by the
        mix's popularity (stratified): what the traffic leaves in a prefix
        cache once it has run a while."""
        rng = np.random.default_rng([self.layout, 0x3A7])
        pick = _categorical(self._pop, stratified(rng, n, max(n, 1)))
        return [self.prefixes[int(j)] for j in pick]

    # --- open-loop arrivals -----------------------------------------------
    def due(self, i: int) -> float:
        """Open loop: seconds from the start of the schedule at which
        request ``i`` is due (Poisson arrivals at the mix's rate, its
        exponential gaps drawn by stratified blocks)."""
        rate = float(self.mix["rate_rps"])
        while len(self._gaps) <= i:
            b = len(self._gaps) // BLOCK
            rng = np.random.default_rng([self.layout, 0x6A95, b])
            u = stratified(rng, BLOCK)
            gaps = -np.log1p(-u) / rate
            t = self._gaps[-1] if self._gaps else 0.0
            for g in gaps:
                t += float(g)
                self._gaps.append(t)
        return self._gaps[i]
