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
tables are the plain ones.  With ``cfg.decode_window`` > 0 the generic
decode of the dense body is the append-buffer decode: its cache gains a
suffix ring ``"sk"`` / ``"sv"`` of ``decode_window`` positions and a
``"prefix_len"``, and each step writes the ring and reads the prefix
(``layers.attention_decode_split_apply``); the slot cache, the arena and
the engines ignore the field, as the reference's do.  The SSM, hybrid and
VLM families run through the generic entry points only — the slot cache,
the arena and the engines refuse them, as the reference's do (enc-dec is
``models/encdec.py``'s).

On a rank mesh (``models/registry.py`` ``shard_params``) the model is the
rank's shard (``LM.mesh`` set; ``models/layers.py`` and ``models/moe.py``
say how each module is cut) and the logits are the rank's slice of the
vocab.  The paged entry points then also cut the decode rows over
"data" when the data size divides the batch: each data replica embeds,
projects and attends for its own rows, the new K/V rows are all-gathered
over "data" so that every replica writes every row into its arena (the
arena is replicated over "data", bit for bit), an MoE layer routes the
whole batch, as the unsharded layer does, and a fused dispatch's tokens
are all-gathered once at its end.  A prefill chunk (one row) runs
replicated over "data".  The forward trains on a rank's shard: its
collectives carry gradients (``sharding/collectives.py``), and with
``cfg.seq_parallel`` the dense body keeps the residual stream cut over
"model" along the sequence between blocks (the reference's
``_sp_constraint``): each block's input all-gathered at its entry, its
row-parallel outputs reduce-scattered.  The generic decode takes a
rank's cache from ``registry.make_cache`` (its ``"layout"``: the rows it
holds and how its KV caches are cut, ``layers.KVCut``); a cache cut
over the sequence decodes by segments merged across the ranks.
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
from repro_torch.sharding import collectives as C
from repro_torch.sharding.rules import MODEL_AXIS, axes_size, block_index

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
    family outside them, enc-dec (``models/encdec.py``), and M-RoPE unless
    they include the VLM (the generic entry points)."""
    reasons = []
    if cfg.family not in families or cfg.n_enc_layers:
        reasons.append(f"family {cfg.family!r}")
    if cfg.mrope_sections and "vlm" not in families:
        reasons.append("M-RoPE")
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
    head over the padded vocab.  ``mesh`` is the rank mesh of a rank's
    shard (None unsharded): the embedding and the head then hold the
    rank's slice of the vocab."""

    def __init__(self, cfg: ModelConfig, device, gen: torch.Generator):
        super().__init__()
        self.cfg = cfg
        self.mesh = None
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
        """Logits over the padded vocab (on a rank mesh the rank's slice,
        its padding rows at -inf)."""
        x = self.final_norm(x)
        head = self.embed if self.lm_head is None else self.lm_head.weight
        return L.embedding_logits(head, x, self.mesh, self.cfg.padded_vocab)

    def embed_tokens(self, tokens: torch.Tensor) -> torch.Tensor:
        return L.embedding_apply(self.embed, tokens, self.mesh)


def init_lm(cfg: ModelConfig, *, seed: int = 0,
            device: Optional[torch.device] = None) -> LM:
    """Random weights from ``seed`` (a ``torch.Generator`` on the device),
    with the reference's init distributions."""
    check_supported(cfg, GENERIC_FAMILIES)
    dev = resolve_device(device)
    gen = L.seeded_generator(dev, seed)
    with torch.no_grad():
        model = LM(cfg, dev, gen)
    return model.requires_grad_(False).eval()


def init_block_arena(cfg: ModelConfig, n_blocks: int, block_size: int,
                     dtype: torch.dtype = torch.bfloat16,
                     device: Optional[torch.device] = None,
                     mesh=None) -> Arena:
    """Paged KV arena ``{"k", "v"}`` of shape (L, n_blocks, block_size, K,
    dh): every sequence's cache is a list of fixed-size blocks carved from
    this one allocation (``serving.kvpool`` owns the map).  Block 0 is the
    junk sink for masked writes — never handed to a sequence.  With
    ``mesh`` the arena is placed under ``sharding.rules.arena_spec`` (its
    error for a head count the model axis does not divide comes first,
    before anything is allocated), on the mesh's device in this process:
    a (1, 1) mesh holds it whole, a rank of a rank mesh its K/m KV heads
    (replicated over "data")."""
    check_supported(cfg)
    shape = (cfg.n_layers, n_blocks, block_size, cfg.n_kv_heads, cfg.d_head)
    if mesh is not None:
        from repro_torch.sharding import rules
        spec = rules.arena_spec(mesh, cfg)
        device = mesh.local_device("init_block_arena")
        shape = rules.shard_shape(shape, spec, mesh)
    dev = resolve_device(device)
    return {"k": torch.zeros(shape, dtype=dtype, device=dev),
            "v": torch.zeros(shape, dtype=dtype, device=dev)}


def _mlp_residual(layer: DecoderLayer, x: torch.Tensor, cfg: ModelConfig,
                  rows: Optional["_Rows"] = None, sp: bool = False,
                  train: bool = False
                  ) -> Tuple[torch.Tensor, Optional[torch.Tensor]]:
    """(x + the layer's MLP or MoE of ln2(x), the MoE's aux loss or None).
    The MoE routes with ``cfg``, the model's config (not one kept in the
    layer), so a copy of the config set on the model changes its
    capacity.  With ``rows`` cutting the batch over "data" the MoE routes
    the whole batch (its groups and capacity span every row, as the
    unsharded layer's do) and keeps this rank's rows.  With ``sp`` x is
    the rank's block of the sequence: ln2(x) is all-gathered along it
    and the output reduce-scattered back.  ``train``: x holds a data
    replica's rows of a training step (``moe.moe_apply``)."""
    h = layer.ln2(x)
    if sp:
        mod = layer.mlp if layer.moe is None else layer.moe
        h = C.gather_dim(h, mod.mesh, MODEL_AXIS, 1)
        if layer.moe is None:
            return x + layer.mlp(h, sp=True), None
        y, aux = M.moe_apply(layer.moe, h, cfg, sp=True, train=train)
        return x + y, aux
    if layer.moe is None:
        return x + layer.mlp(h), None
    if rows is not None and rows.cut:
        y, aux = M.moe_apply(layer.moe, rows.gather(h), cfg)
        return x + y[rows.lo:rows.hi], aux
    y, aux = M.moe_apply(layer.moe, h, cfg, train=train)
    return x + y, aux


def _seq_parallel(model: LM, s: int) -> bool:
    """True when the forward keeps the residual stream cut over "model"
    along the sequence (``cfg.seq_parallel`` on a rank mesh whose model
    axis has more than one rank); it needs the sequence to split over the
    axis and the attention to be cut."""
    cfg, mesh = model.cfg, model.mesh
    if not cfg.seq_parallel or mesh is None or mesh.shape[MODEL_AXIS] == 1:
        return False
    m = mesh.shape[MODEL_AXIS]
    if s % m or cfg.n_heads % m:
        raise ValueError(f"{cfg.name}: seq_parallel needs the sequence "
                         f"({s}) and the query heads ({cfg.n_heads}) to "
                         f"split over the model axis ({m})")
    return True


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
    block); without it the forward runs under ``no_grad``.  On a rank
    mesh the model is the rank's shard and the logits its vocab slice;
    its collectives carry gradients, the training forward's batch is a
    data replica's rows (an MoE routes with the global batch's groups and
    load-balance statistics), and with ``cfg.seq_parallel`` the dense
    body's residual stream is cut along the sequence between blocks
    (:func:`_seq_parallel`)."""
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
        x = model.embed_tokens(tokens)
    positions = torch.arange(x.shape[1], dtype=torch.int32, device=x.device)
    aux = torch.zeros((), dtype=torch.float32, device=x.device)
    if cfg.family in _DENSE_BODY:
        sp = _seq_parallel(model, x.shape[1])
        if sp:
            x = C.split_dim(x, model.mesh, MODEL_AXIS, 1)

        def attn(x, layer, w, cos, sin):
            h = layer.ln1(x)
            if sp:
                h = C.gather_dim(h, model.mesh, MODEL_AXIS, 1)
            return L.attention_apply(layer.attn, h, cos, sin, window=w,
                                     sp=sp)

        def mlp(x, layer):
            return _mlp_residual(layer, x, cfg, sp=sp, train=train)

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
        if sp:
            x = C.gather_dim(x, model.mesh, MODEL_AXIS, 1)
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
    () int32, the next position.  With ``cfg.decode_window`` = W > 0 the
    dense body's cache also holds the append-buffer decode's suffix ring
    ``"sk"``, ``"sv"`` (L, b, W, K, dh) and ``"prefix_len"`` () int32, the
    valid length of the read-only prefix ``"k"`` / ``"v"`` (0, as the
    reference leaves it: the whole context then sits in the ring)."""
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
    if cfg.decode_window > 0 and cfg.family in _DENSE_BODY:
        ring = (cfg.n_layers, batch, cfg.decode_window, cfg.n_kv_heads,
                cfg.d_head)
        cache["sk"] = torch.zeros(ring, dtype=dtype, device=dev)
        cache["sv"] = torch.zeros(ring, dtype=dtype, device=dev)
        cache["prefix_len"] = torch.zeros((), dtype=torch.int32, device=dev)
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
    ``pos + 1``.  With ``cfg.decode_window`` the new K/V go to the suffix
    ring and the prefix is never written
    (``layers.attention_decode_split_apply``).  Returns (logits (b,
    V_padded), cache)."""
    cfg = model.cfg
    check_supported(cfg, GENERIC_FAMILIES)
    pos = cache["pos"]
    layout = cache.get("layout")
    rows, cut = None, None
    if layout is not None:          # a rank's cache (registry.make_cache)
        rows, cut = layout["rows"], layout["kv"]
        tokens = rows.take(tokens)
        if mrope_positions is not None:
            mrope_positions = rows.take(mrope_positions.transpose(0, 1)
                                        ).transpose(0, 1)
    x = model.embed_tokens(tokens)

    def self_attn(attn, h, cos, sin, ck, cv, w):
        if cut is not None and cut.whole_heads:
            return L.attention_decode_seq_apply(attn, h, cos, sin, ck, cv,
                                                pos, cut, window=w)
        return L.attention_decode_apply(attn, h, cos, sin, ck, cv, pos,
                                        window=w)

    if cfg.family in _DENSE_BODY:
        split = cfg.decode_window > 0
        for li, (layer, (w, (cos, sin))) in enumerate(zip(
                model.layers, _layer_specs(cfg, pos[None],
                                           mrope_positions))):
            if split:
                a = L.attention_decode_split_apply(
                    layer.attn, layer.ln1(x), cos, sin, cache["k"][li],
                    cache["v"][li], cache["sk"][li], cache["sv"][li], pos,
                    cache["prefix_len"], window=w, cut=cut)
            else:
                a = self_attn(layer.attn, layer.ln1(x), cos, sin,
                              cache["k"][li], cache["v"][li], w)
            x, _ = _mlp_residual(layer, x + a, cfg, rows)
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
                x = x + self_attn(sh.attn, sh.ln1(x), cos, sin,
                                  cache["k"][g], cache["v"][g], 0)
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
    x = model.embed_tokens(tokens)
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
    x = model.embed_tokens(tokens)
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
    x = model.embed_tokens(tokens)
    for li, (layer, (w, (cos, sin))) in enumerate(zip(
            model.layers, _layer_specs(cfg, positions))):
        x = x + L.attention_prefill_paged_apply(
            layer.attn, layer.ln1(x), cos, sin, arena["k"][li],
            arena["v"][li], table, positions, write_bid, write_off,
            window=w)
        x, _ = _mlp_residual(layer, x, cfg)
    return model.logits(x)


class _Rows:
    """The decode rows a rank computes: ``lo .. hi`` of a batch of ``b``,
    the rank's equal block when ``mesh``'s ``axes`` (of more than one
    rank together; "data" by default) divide ``b`` (``cut``), else all of
    them."""

    def __init__(self, b: int, mesh, axes=("data",)):
        axes = tuple(a for a in axes if mesh is not None
                     and mesh.shape.get(a, 1) > 1)
        n = axes_size(mesh, axes) if axes else 1
        self.mesh, self.axes, self.cut = mesh, axes, n > 1 and b % n == 0
        per = b // n if self.cut else b
        self.lo = block_index(mesh, axes) * per if self.cut else 0
        self.hi = self.lo + per

    def take(self, x: torch.Tensor) -> torch.Tensor:
        """This rank's rows of ``x`` (its leading dim covers the batch)."""
        return x[self.lo:self.hi] if self.cut else x

    def gather(self, x: torch.Tensor) -> torch.Tensor:
        """Every rank's rows of ``x`` (its leading dim), in row order."""
        if self.cut:
            for a in reversed(self.axes):
                x = C.gather_rows(x, self.mesh, a)
        return x


def _decode_paged_rows(model: LM, arena: Arena, tokens: torch.Tensor,
                       tables: torch.Tensor, lengths: torch.Tensor,
                       active: torch.Tensor, rows: _Rows) -> torch.Tensor:
    """One paged decode step of the rows ``rows`` of the batch: ``tokens``
    (rows, 1) are theirs, ``tables``, ``lengths`` and ``active`` the whole
    batch's (every row's new K/V is written).  Returns their logits."""
    cfg = model.cfg
    bs = arena["k"].shape[2]
    n_pages = tables.shape[1]
    page = (lengths // bs).clamp(0, n_pages - 1).long()
    write_bid = torch.where(active, tables.gather(1, page[:, None])[:, 0],
                            0).long()
    write_off = torch.where(active, lengths % bs, 0).long()
    my_tables, my_lengths = rows.take(tables), rows.take(lengths)
    x = model.embed_tokens(tokens)
    for li, (layer, (w, (cos, sin))) in enumerate(zip(
            model.layers, _layer_specs(cfg, my_lengths[:, None]))):
        x = x + L.attention_decode_paged_apply(
            layer.attn, layer.ln1(x), cos, sin, arena["k"][li],
            arena["v"][li], my_tables, my_lengths, write_bid,
            write_off, window=w, kv_rows=rows.gather if rows.cut else None)
        x, _ = _mlp_residual(layer, x, cfg, rows)
    return model.logits(x)[:, 0, :]


@torch.no_grad()
def decode_paged_lm(model: LM, arena: Arena, tokens: torch.Tensor,
                    tables: torch.Tensor, lengths: torch.Tensor,
                    active: torch.Tensor) -> torch.Tensor:
    """One batched decode step over all rows of a paged batch.

    tokens: (b, 1) int; tables: (b, n_pages) i32; lengths: (b,) i32 valid
    token counts; active: (b,) bool.  Inactive rows ride along for static
    shapes but write into the junk block and their outputs are garbage.
    Writes the arena in place and returns logits (b, V_padded); on a rank
    mesh those of the rank's rows (its block when "data" cuts them) and
    its vocab slice."""
    rows = _Rows(tokens.shape[0], model.mesh)
    return _decode_paged_rows(model, arena, rows.take(tokens), tables,
                              lengths, active, rows)


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
    lengths (b,) i32)``; the arena is written in place.  On a rank mesh
    every step's token is :func:`~repro_torch.models.layers.greedy_token`
    over the vocab slices, the same on every rank of "model"; with the
    rows cut over "data" each rank feeds back its own rows' tokens, and
    the dispatch's tokens are all-gathered over "data" at its end."""
    rows = _Rows(tokens.shape[0], model.mesh)
    act_col = rows.take(active)[:, None]
    act_i = active.to(torch.int32)
    nxt, ln = rows.take(tokens), lengths
    toks = []
    for _ in range(n_steps):
        logits = _decode_paged_rows(model, arena, nxt, tables, ln, active,
                                    rows)
        tok = L.greedy_token(logits, model.mesh).to(torch.int32)
        nxt = torch.where(act_col, tok[:, None], nxt)
        ln = ln + act_i
        toks.append(tok)
    toks = torch.stack(toks)
    if rows.cut:
        toks = rows.gather(toks.T).T
        nxt = torch.where(active[:, None], toks[-1][:, None], tokens)
    return toks, nxt, ln


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
