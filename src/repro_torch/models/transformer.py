"""Decoder-only LM stack (dense / MoE / SSM / hybrid / VLM) — the port's
counterpart of the reference package's ``models/transformer.py``.

One module per layer in an ``nn.ModuleList`` (the reference stacks layers
on a leading axis for ``lax.scan``): ``DecoderLayer`` (dense and MoE: an
MLP, or a ``models/moe.py`` ``MoE`` for a config with experts), ``SSMLayer``
(a Mamba2 block; the ``ssm`` family, mamba2), and for the ``hybrid`` family
(zamba2) one ``SharedBlock`` of attention and MLP whose weights every group
of ``attn_every`` Mamba2 layers reuses.  Entry points:

  * :func:`init_lm`, :func:`init_slot_cache`, :func:`init_block_arena` —
    weights, the slotted cache and the arena;
  * :func:`forward_lm` — the full-sequence forward;
  * :func:`init_kv_cache` and :func:`decode_step_lm` — the generic decode
    state (KV caches, SSM conv histories and states) and one decode step
    at a position shared by every row;
  * :func:`prefill_kv_lm` — one-pass prefill that returns every layer's
    K/V for a slotted cache;
  * :func:`decode_slots_lm` — one batched decode step over all slots;
  * :func:`prefill_paged_lm` — one chunk of chunked prefill;
  * :func:`decode_paged_lm` — one batched decode step;
  * :func:`decode_paged_multi_lm` — ``n_steps`` fused greedy steps whose
    token feedback stays on the device (a Python loop, no host sync);
  * :func:`merge_patch_embeds` and :func:`default_mrope_positions` — the
    VLM's precomputed patch embeddings in the token stream, and text-only
    M-RoPE positions.

Every dense and MoE entry point takes each layer's sliding window and
rotary tables from :func:`layer_pattern` (gemma3: ``local_global_ratio``
local layers of window ``sliding_window`` and rotary base ``rope_theta``,
then one global layer of full attention and ``global_rope_theta``), as the
reference scans them through its layer stack.  An MoE layer routes the
tokens of one call in groups with a capacity per expert
(``moe.moe_apply``), so padded rows, free slots and chunk boundaries take
part in its routing as they do in the reference.  Caches and the arena are
written in place.  The VLM (qwen2-vl) is the dense body with M-RoPE: the
generic entry points take its (3, b, s) position streams; without them its
tables are the plain ones.  The append-buffer decode is not ported
(:func:`check_supported` raises); the SSM, hybrid and VLM families run
through the generic entry points only — the slot cache, the arena and the
engines refuse them, as the reference's do (enc-dec is
``models/encdec.py``'s).
"""
from __future__ import annotations

from typing import Dict, List, Optional, Tuple

import numpy as np
import torch
from torch import nn

from repro_torch import resolve_device
from repro_torch.models import layers as L
from repro_torch.models import moe as M
from repro_torch.models import ssm as S
from repro_torch.models.config import ModelConfig

Arena = Dict[str, torch.Tensor]
SlotCache = Dict[str, torch.Tensor]
KVCache = Dict[str, object]

# the families of the attention decoder (the slot cache, the arena and
# the engines), and of the generic entry points (forward_lm,
# init_kv_cache, decode_step_lm); the VLM runs the decoder's dense body
DECODER_FAMILIES = ("dense", "moe")
GENERIC_FAMILIES = DECODER_FAMILIES + ("ssm", "hybrid", "vlm")
_DENSE_BODY = DECODER_FAMILIES + ("vlm",)


def check_supported(cfg: ModelConfig, families=DECODER_FAMILIES) -> None:
    """Raise ``NotImplementedError`` for what ``families`` do not take: a
    family outside them, enc-dec (``models/encdec.py``), M-RoPE unless they
    include the VLM (the generic entry points), and the append-buffer
    decode, which a later slice ports."""
    reasons = []
    if cfg.family not in families or cfg.n_enc_layers:
        reasons.append(f"family {cfg.family!r}")
    if cfg.mrope_sections and "vlm" not in families:
        reasons.append("M-RoPE")
    if cfg.decode_window:
        reasons.append("append-buffer decode (not ported yet)")
    if reasons:
        raise NotImplementedError(
            f"{cfg.name}: {', '.join(reasons)} not supported here")
    if cfg.family == "hybrid" and cfg.n_layers % cfg.attn_every:
        raise ValueError(f"{cfg.name}: {cfg.n_layers} layers do not split "
                         f"into groups of attn_every={cfg.attn_every}")


def layer_pattern(cfg: ModelConfig) -> Tuple[np.ndarray, np.ndarray]:
    """(windows (L,) int32, is_global (L,) bool) on the host.  With
    ``local_global_ratio`` r > 0 (gemma3) every (r + 1)-th layer is global
    (window 0, full attention) and the others local (``sliding_window``);
    otherwise every layer is global and has the config's window (0 for
    none).  A depth-reduced rung recomputes it from its own ``n_layers``."""
    n = cfg.n_layers
    if cfg.local_global_ratio > 0:
        r = cfg.local_global_ratio
        is_global = np.array([(i % (r + 1)) == r for i in range(n)])
        windows = np.where(is_global, 0, cfg.sliding_window).astype(np.int32)
    else:
        is_global = np.ones((n,), dtype=bool)
        windows = np.full((n,), cfg.sliding_window, dtype=np.int32)
    return windows, is_global


def _rope_tables(cfg: ModelConfig, positions: torch.Tensor,
                 mrope_positions: Optional[torch.Tensor] = None):
    """((cos_l, sin_l), (cos_g, sin_g)) for ``positions`` at the config's
    rotary width: the local layers' tables at ``rope_theta`` and the global
    layers' at ``global_rope_theta`` (the same tables for a config without
    a local/global pattern).  With M-RoPE sections and ``mrope_positions``
    (3, b, s) given, both are M-RoPE's (b, s, half) tables, one per batch
    row; without positions M-RoPE's tables are the plain ones."""
    d_rot = int(cfg.d_head * cfg.partial_rotary)
    if cfg.mrope_sections and mrope_positions is not None:
        tables = L.mrope_table(mrope_positions, d_rot, cfg.rope_theta,
                               cfg.mrope_sections)
        return tables, tables
    local = L.rope_table(positions, d_rot, cfg.rope_theta)
    if cfg.local_global_ratio > 0:
        return local, L.rope_table(positions, d_rot, cfg.global_rope_theta)
    return local, local


def _layer_specs(cfg: ModelConfig, positions: torch.Tensor,
                 mrope_positions: Optional[torch.Tensor] = None
                 ) -> List[Tuple[int, Tuple[torch.Tensor, torch.Tensor]]]:
    """(window, (cos, sin)) of every layer: :func:`layer_pattern` with the
    rotary tables of the layer's kind at ``positions`` (M-RoPE's at
    ``mrope_positions`` when given)."""
    windows, is_global = layer_pattern(cfg)
    local, glob = _rope_tables(cfg, positions, mrope_positions)
    return [(int(w), glob if g else local)
            for w, g in zip(windows, is_global)]


# =============================================================================
# modules and init
# =============================================================================
class DecoderLayer(nn.Module):
    """Attention, then an MLP (``mlp``) or, for a config with experts, an
    MoE (``moe``); the other is None."""

    def __init__(self, cfg: ModelConfig, device, gen: torch.Generator):
        super().__init__()
        self.ln1 = L.RMSNorm(cfg.d_model, cfg, device)
        self.attn = L.Attention(cfg, device, gen)
        self.ln2 = L.RMSNorm(cfg.d_model, cfg, device)
        self.mlp = None if cfg.is_moe else L.MLP(cfg, device, gen)
        self.moe = M.MoE(cfg, device, gen) if cfg.is_moe else None


class SSMLayer(nn.Module):
    def __init__(self, cfg: ModelConfig, device, gen: torch.Generator):
        super().__init__()
        self.ln = L.RMSNorm(cfg.d_model, cfg, device)
        self.mamba = S.Mamba2(cfg, device, gen)


class SharedBlock(nn.Module):
    """The hybrid's one attention + MLP block, applied after every group of
    ``attn_every`` Mamba2 layers with the same weights."""

    def __init__(self, cfg: ModelConfig, device, gen: torch.Generator):
        super().__init__()
        self.ln1 = L.RMSNorm(cfg.d_model, cfg, device)
        self.attn = L.Attention(cfg, device, gen)
        self.ln2 = L.RMSNorm(cfg.d_model, cfg, device)
        self.mlp = L.MLP(cfg, device, gen)


class LM(nn.Module):
    """Embedding, the layers (decoder layers, or Mamba2 layers and, for the
    hybrid, the shared block), final norm, and the tied (or separate) LM
    head over the padded vocab."""

    def __init__(self, cfg: ModelConfig, device, gen: torch.Generator):
        super().__init__()
        self.cfg = cfg
        self.embed = nn.Parameter(L.trunc_normal(
            (cfg.padded_vocab, cfg.d_model), 1.0, cfg.dtype, device, gen))
        layer = SSMLayer if cfg.family in ("ssm", "hybrid") else DecoderLayer
        self.layers = nn.ModuleList(layer(cfg, device, gen)
                                    for _ in range(cfg.n_layers))
        self.shared = (SharedBlock(cfg, device, gen)
                       if cfg.family == "hybrid" else None)
        self.final_norm = L.RMSNorm(cfg.d_model, cfg, device)
        self.lm_head = (None if cfg.tie_embeddings else
                        L.init_dense(cfg.d_model, cfg.padded_vocab, cfg,
                                     device, gen))

    def logits(self, x: torch.Tensor) -> torch.Tensor:
        x = self.final_norm(x)
        if self.lm_head is None:
            return L.embedding_logits(self.embed, x)
        return self.lm_head(x)


def init_lm(cfg: ModelConfig, *, seed: int = 0,
            device: Optional[torch.device] = None) -> LM:
    """Random weights from ``seed`` (a ``torch.Generator`` on the device),
    with the reference's init distributions."""
    check_supported(cfg, GENERIC_FAMILIES)
    dev = resolve_device(device)
    gen = torch.Generator(device=dev)
    gen.manual_seed(seed)
    with torch.no_grad():
        model = LM(cfg, dev, gen)
    return model.requires_grad_(False).eval()


def init_block_arena(cfg: ModelConfig, n_blocks: int, block_size: int,
                     dtype: torch.dtype = torch.bfloat16,
                     device: Optional[torch.device] = None) -> Arena:
    """Paged KV arena ``{"k", "v"}`` of shape (L, n_blocks, block_size, K,
    dh): every sequence's cache is a list of fixed-size blocks carved from
    this one allocation (``serving.kvpool`` owns the map).  Block 0 is the
    junk sink for masked writes — never handed to a sequence."""
    check_supported(cfg)
    shape = (cfg.n_layers, n_blocks, block_size, cfg.n_kv_heads, cfg.d_head)
    dev = resolve_device(device)
    return {"k": torch.zeros(shape, dtype=dtype, device=dev),
            "v": torch.zeros(shape, dtype=dtype, device=dev)}


def _mlp_residual(layer: DecoderLayer, x: torch.Tensor, cfg: ModelConfig
                  ) -> Tuple[torch.Tensor, Optional[torch.Tensor]]:
    """(x + the layer's MLP or MoE of ln2(x), the MoE's aux loss or None).
    The MoE routes with ``cfg``, the model's config (not one kept in the
    layer), so a copy of the config set on the model changes its
    capacity."""
    h = layer.ln2(x)
    if layer.moe is None:
        return x + layer.mlp(h), None
    y, aux = M.moe_apply(layer.moe, h, cfg)
    return x + y, aux


# =============================================================================
# full-sequence forward and the generic decode
# =============================================================================
def forward_lm(model: LM, tokens: Optional[torch.Tensor], *,
               mrope_positions: Optional[torch.Tensor] = None,
               inputs_embeds: Optional[torch.Tensor] = None,
               return_hidden: bool = False, train: bool = False
               ) -> Tuple[torch.Tensor, torch.Tensor]:
    """tokens: (b, s) int -> (logits (b, s, V_padded), aux ()); with
    ``return_hidden`` the final-normed hidden states (b, s, d) in place of
    the logits; ``inputs_embeds`` (b, s, d) (cast to the model's type)
    replace the embedded tokens (the VLM's merged patch embeddings,
    :func:`merge_patch_embeds`).  Dense, MoE and VLM: each layer's causal
    attention with its window and rotary tables (:func:`layer_pattern`; a
    VLM's M-RoPE tables at ``mrope_positions`` (3, b, s) when given), then
    its MLP or MoE; ``aux`` is the sum of the MoE layers' load-balance
    losses (f32 0 for the other families).  SSM and hybrid: ``s`` must be
    a multiple of ``ssm_chunk``; the hybrid runs each group of
    ``attn_every`` Mamba2 layers, then the shared attention (causal) and
    MLP.  No decode state is returned, as in the reference: a generation
    replays the prompt through :func:`decode_step_lm`.

    ``train`` (the training forward) records gradients, on CUDA through
    the flash kernel's and the SSD scan's backward kernels, with per-layer
    activation checkpointing by ``cfg.remat`` / ``cfg.remat_policy``
    (:func:`~repro_torch.models.layers.remat`; "collectives" checkpoints a
    decoder layer's attention and MLP halves apart, keeping their outputs;
    the SSM families recompute a layer, the hybrid a group with its shared
    block); without it the forward runs under ``no_grad``."""
    cfg = model.cfg
    check_supported(cfg, GENERIC_FAMILIES)
    with L.grad_mode(train):
        return _forward_lm(model, tokens, mrope_positions, inputs_embeds,
                           return_hidden, train)


def _forward_lm(model: LM, tokens, mrope_positions, inputs_embeds,
                return_hidden: bool, train: bool):
    cfg = model.cfg
    if inputs_embeds is not None:
        x = inputs_embeds.to(cfg.dtype)
    else:
        x = L.embedding_apply(model.embed, tokens)
    positions = torch.arange(x.shape[1], dtype=torch.int32, device=x.device)
    aux = torch.zeros((), dtype=torch.float32, device=x.device)
    if cfg.family in _DENSE_BODY:
        def attn(x, layer, w, cos, sin):
            return L.attention_apply(layer.attn, layer.ln1(x), cos, sin,
                                     window=w)

        def mlp(x, layer):
            return _mlp_residual(layer, x, cfg)

        # "collectives" keeps each half's output: the halves checkpointed
        # apart; any other policy checkpoints the layer whole
        halves = cfg.remat_policy == "collectives"
        if halves:
            attn, mlp = L.remat(attn, cfg, train), L.remat(mlp, cfg, train)

        def block(x, layer, w, cos, sin):
            return mlp(x + attn(x, layer, w, cos, sin), layer)

        if not halves:
            block = L.remat(block, cfg, train)
        for layer, (w, (cos, sin)) in zip(
                model.layers, _layer_specs(cfg, positions, mrope_positions)):
            x, a = block(x, layer, w, cos, sin)
            if a is not None:
                aux = aux + a
    else:
        sh = model.shared
        cos = sin = None
        if sh is not None:
            cos, sin = _rope_tables(cfg, positions)[0]
        per = cfg.attn_every if sh is not None else 1

        def group(x, layers, cos, sin):
            for layer in layers:
                x = x + S.mamba2_apply(layer.mamba, layer.ln(x))
            if sh is not None:
                x = x + L.attention_apply(sh.attn, sh.ln1(x), cos, sin)
                x = x + sh.mlp(sh.ln2(x))
            return x

        group = L.remat(group, cfg, train)
        for g0 in range(0, cfg.n_layers, per):
            x = group(x, model.layers[g0:g0 + per], cos, sin)
    if return_hidden:
        return model.final_norm(x), aux
    return model.logits(x), aux


def init_kv_cache(cfg: ModelConfig, batch: int, max_len: int,
                  dtype: torch.dtype = torch.bfloat16,
                  device: Optional[torch.device] = None) -> KVCache:
    """Decode state, in the reference's layout: dense, MoE and VLM ``"k"``,
    ``"v"`` (L, b, max_len, K, dh); SSM ``{"ssm": {conv_x, conv_B,
    conv_C, state}}``, one layer's ``models/ssm.py`` ``init_ssm_cache``
    stacked on L; the
    hybrid both, its ``"k"``, ``"v"`` (G, b, max_len, K, dh) one per
    application of the shared block (G = L / attn_every); and ``"pos"``
    () int32, the next position."""
    check_supported(cfg, GENERIC_FAMILIES)
    dev = resolve_device(device)
    cache: KVCache = {}
    if cfg.family not in _DENSE_BODY:
        layer = S.init_ssm_cache(cfg, batch, dtype, dev)
        cache["ssm"] = {key: buf.new_zeros((cfg.n_layers, *buf.shape))
                        for key, buf in layer.items()}
    if cfg.family != "ssm":
        n_kv = (cfg.n_layers if cfg.family in _DENSE_BODY
                else cfg.n_layers // cfg.attn_every)
        shape = (n_kv, batch, max_len, cfg.n_kv_heads, cfg.d_head)
        cache["k"] = torch.zeros(shape, dtype=dtype, device=dev)
        cache["v"] = torch.zeros(shape, dtype=dtype, device=dev)
    cache["pos"] = torch.zeros((), dtype=torch.int32, device=dev)
    return cache


@torch.no_grad()
def decode_step_lm(model: LM, cache: KVCache, tokens: torch.Tensor, *,
                   mrope_positions: Optional[torch.Tensor] = None
                   ) -> Tuple[torch.Tensor, KVCache]:
    """One decode step at ``cache["pos"]`` for every row.  tokens: (b, 1)
    int.  A VLM's rotary comes from ``mrope_positions`` (3, b, 1) when
    given; its K/V are still written at ``cache["pos"]`` (after an image
    the two differ).  The cache's buffers are advanced IN PLACE (the
    reference returns new ones) and ``cache["pos"]`` becomes a new tensor
    ``pos + 1``.  Returns (logits (b, V_padded), cache)."""
    cfg = model.cfg
    check_supported(cfg, GENERIC_FAMILIES)
    pos = cache["pos"]
    x = L.embedding_apply(model.embed, tokens)
    if cfg.family in _DENSE_BODY:
        for li, (layer, (w, (cos, sin))) in enumerate(zip(
                model.layers, _layer_specs(cfg, pos[None],
                                           mrope_positions))):
            x = x + L.attention_decode_apply(
                layer.attn, layer.ln1(x), cos, sin, cache["k"][li],
                cache["v"][li], pos, window=w)
            x, _ = _mlp_residual(layer, x, cfg)
    else:
        sh = model.shared
        if sh is not None:
            cos, sin = _rope_tables(cfg, pos[None])[0]
        for li, layer in enumerate(model.layers):
            x = x + S.mamba2_decode_step(
                layer.mamba, layer.ln(x),
                {key: buf[li] for key, buf in cache["ssm"].items()})
            if sh is not None and (li + 1) % cfg.attn_every == 0:
                g = li // cfg.attn_every
                x = x + L.attention_decode_apply(
                    sh.attn, sh.ln1(x), cos, sin, cache["k"][g],
                    cache["v"][g], pos)
                x = x + sh.mlp(sh.ln2(x))
    cache["pos"] = pos + 1
    return model.logits(x)[:, 0, :], cache


# =============================================================================
# slotted continuous-batching cache (serving engine, kv_layout="slotted")
# =============================================================================
def supports_slots(cfg: ModelConfig) -> bool:
    """Families the slotted batched KV cache covers, as in the reference:
    pure-attention decoders (dense / MoE) — no encoder, no SSM state, no
    per-stream M-RoPE positions."""
    return (cfg.family in DECODER_FAMILIES and cfg.n_enc_layers == 0
            and not cfg.mrope_sections)


def init_slot_cache(cfg: ModelConfig, n_slots: int, max_len: int,
                    dtype: torch.dtype = torch.bfloat16,
                    device: Optional[torch.device] = None) -> SlotCache:
    """Fixed-capacity batched KV cache: ``n_slots`` independent sequences
    of up to ``max_len`` positions, each with its own valid prefix
    ``lengths[i]``.  ``{"k", "v"}`` are (L, n_slots, max_len, K, dh)."""
    assert supports_slots(cfg), f"slotted cache unsupported for {cfg.family}"
    check_supported(cfg)
    shape = (cfg.n_layers, n_slots, max_len, cfg.n_kv_heads, cfg.d_head)
    dev = resolve_device(device)
    return {"k": torch.zeros(shape, dtype=dtype, device=dev),
            "v": torch.zeros(shape, dtype=dtype, device=dev),
            "lengths": torch.zeros((n_slots,), dtype=torch.int32,
                                   device=dev)}


@torch.no_grad()
def prefill_kv_lm(model: LM, tokens: torch.Tensor
                  ) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """Full-sequence forward that also returns every layer's rotated K/V, so
    a serving engine fills a slot's cache in ONE pass.

    tokens: (b, s) int -> (logits (b, s, V_padded), k (L, b, s, K, dh),
    v (L, b, s, K, dh))."""
    cfg = model.cfg
    assert supports_slots(cfg), f"prefill-kv unsupported for {cfg.family}"
    positions = torch.arange(tokens.shape[1], dtype=torch.int32,
                             device=tokens.device)
    x = L.embedding_apply(model.embed, tokens)
    ks, vs = [], []
    for layer, (w, (cos, sin)) in zip(model.layers,
                                      _layer_specs(cfg, positions)):
        a, k, v = L.attention_prefill_apply(layer.attn, layer.ln1(x), cos,
                                            sin, causal=True, window=w)
        x, _ = _mlp_residual(layer, x + a, cfg)
        ks.append(k)
        vs.append(v)
    return model.logits(x), torch.stack(ks), torch.stack(vs)


@torch.no_grad()
def decode_slots_lm(model: LM, cache: SlotCache, tokens: torch.Tensor,
                    active: torch.Tensor) -> Tuple[torch.Tensor, SlotCache]:
    """One batched decode step over ALL slots of a slot cache.

    tokens: (n_slots, 1) int — one column across slots; active: (n_slots,)
    bool — slots serving a request.  Free slots still compute (the batch
    shape is static) and write their K/V at their stale ``lengths[i]`` —
    positions a later admission's prefill overwrites — and their lengths
    do not advance.  The cache's K/V are written in place and
    ``cache["lengths"]`` becomes ``lengths + active``.  Returns (logits
    (n_slots, V_padded), cache)."""
    cfg = model.cfg
    lengths = cache["lengths"]
    write = L.slot_write_index(lengths, cache["k"].shape[2])
    x = L.embedding_apply(model.embed, tokens)
    for li, (layer, (w, (cos, sin))) in enumerate(zip(
            model.layers, _layer_specs(cfg, lengths[:, None]))):
        x = x + L.attention_decode_slots_apply(
            layer.attn, layer.ln1(x), cos, sin, cache["k"][li],
            cache["v"][li], lengths, write, window=w)
        x, _ = _mlp_residual(layer, x, cfg)
    cache["lengths"] = lengths + active.to(torch.int32)
    return model.logits(x)[:, 0, :], cache


# =============================================================================
# paged forward
# =============================================================================
@torch.no_grad()
def prefill_paged_lm(model: LM, tokens: torch.Tensor, arena: Arena,
                     table: torch.Tensor, n_past: int, true_c: int
                     ) -> torch.Tensor:
    """One CHUNK of chunked prefill for a single sequence.

    tokens: (1, C) int — the chunk, zero-padded past ``true_c``; table:
    (span,) i32 block table of the sequence (0-padded); n_past: tokens
    already in the arena; true_c: real chunk length.  The chunk's K/V land
    at absolute positions ``n_past .. n_past+true_c-1`` (padded tail rows go
    to the junk block); its queries attend causally over everything cached
    so far — chunking changes scheduling, not math.  Writes the arena in
    place and returns logits (1, C, V_padded)."""
    cfg = model.cfg
    C = tokens.shape[1]
    bs = arena["k"].shape[2]
    span = table.shape[0]
    positions = torch.arange(C, dtype=torch.int32,
                             device=tokens.device) + n_past
    valid = positions < n_past + true_c
    page = (positions // bs).clamp(0, span - 1).long()
    write_bid = torch.where(valid, table[page], 0).long()
    write_off = (positions % bs).long()
    x = L.embedding_apply(model.embed, tokens)
    for li, (layer, (w, (cos, sin))) in enumerate(zip(
            model.layers, _layer_specs(cfg, positions))):
        x = x + L.attention_prefill_paged_apply(
            layer.attn, layer.ln1(x), cos, sin, arena["k"][li],
            arena["v"][li], table, positions, write_bid, write_off,
            window=w)
        x, _ = _mlp_residual(layer, x, cfg)
    return model.logits(x)


@torch.no_grad()
def decode_paged_lm(model: LM, arena: Arena, tokens: torch.Tensor,
                    tables: torch.Tensor, lengths: torch.Tensor,
                    active: torch.Tensor) -> torch.Tensor:
    """One batched decode step over all rows of a paged batch.

    tokens: (b, 1) int; tables: (b, n_pages) i32; lengths: (b,) i32 valid
    token counts; active: (b,) bool.  Inactive rows ride along for static
    shapes but write into the junk block and their outputs are garbage.
    Writes the arena in place and returns logits (b, V_padded)."""
    cfg = model.cfg
    bs = arena["k"].shape[2]
    n_pages = tables.shape[1]
    page = (lengths // bs).clamp(0, n_pages - 1).long()
    write_bid = torch.where(active, tables.gather(1, page[:, None])[:, 0],
                            0).long()
    write_off = torch.where(active, lengths % bs, 0).long()
    x = L.embedding_apply(model.embed, tokens)
    for li, (layer, (w, (cos, sin))) in enumerate(zip(
            model.layers, _layer_specs(cfg, lengths[:, None]))):
        x = x + L.attention_decode_paged_apply(
            layer.attn, layer.ln1(x), cos, sin, arena["k"][li],
            arena["v"][li], tables, lengths, write_bid, write_off,
            window=w)
        x, _ = _mlp_residual(layer, x, cfg)
    return model.logits(x)[:, 0, :]


@torch.no_grad()
def decode_paged_multi_lm(model: LM, arena: Arena, tokens: torch.Tensor,
                          tables: torch.Tensor, lengths: torch.Tensor,
                          active: torch.Tensor, n_steps: int
                          ) -> Tuple[torch.Tensor, torch.Tensor,
                                     torch.Tensor]:
    """``n_steps`` fused greedy decode steps over a paged batch — the
    device-resident decode loop.

    Each iteration is exactly one :func:`decode_paged_lm` step followed by
    the greedy feedback: the argmax token becomes the next input for active
    rows and their lengths advance by one, all on the device, so the host
    never waits on intermediate state.  Inactive rows keep their token and
    length and write into the junk block.  The caller guarantees every
    active row's block table covers ``lengths + n_steps`` positions and no
    row finishes mid-loop.

    tokens: (b, 1) i32.  Returns ``(toks (n_steps, b) i32, next (b, 1) i32,
    lengths (b,) i32)``; the arena is written in place."""
    act_col = active[:, None]
    act_i = active.to(torch.int32)
    nxt, ln = tokens, lengths
    toks = []
    for _ in range(n_steps):
        logits = decode_paged_lm(model, arena, nxt, tables, ln, active)
        tok = logits.argmax(dim=-1).to(torch.int32)
        nxt = torch.where(act_col, tok[:, None], nxt)
        ln = ln + act_i
        toks.append(tok)
    return torch.stack(toks), nxt, ln


# =============================================================================
# VLM helpers — precomputed patch embeddings, text-only M-RoPE positions
# =============================================================================
def merge_patch_embeds(token_embeds: torch.Tensor, patch_embeds: torch.Tensor,
                       image_mask: torch.Tensor) -> torch.Tensor:
    """Scatter patch embeddings over the positions where ``image_mask`` is
    set, in order.  token_embeds: (b, s, d); patch_embeds: (b, n_patch, d);
    image_mask: (b, s) bool with exactly n_patch True a row (the vision
    tower's output arrives precomputed, as in the reference)."""
    d = token_embeds.shape[-1]
    idx = (image_mask.to(torch.int32).cumsum(1) - 1).clamp(
        0, patch_embeds.shape[1] - 1)
    gathered = patch_embeds.gather(
        1, idx.long()[..., None].expand(-1, -1, d))
    return torch.where(image_mask[..., None], gathered, token_embeds)


def default_mrope_positions(batch: int, seq: int,
                            device: Optional[torch.device] = None
                            ) -> torch.Tensor:
    """Text-only M-RoPE positions (3, batch, seq) int32 on ``device`` (the
    GPU by default): all three streams ``0 .. seq - 1``."""
    pos = torch.arange(seq, dtype=torch.int32, device=resolve_device(device))
    return pos.expand(3, batch, seq)
