"""Model interface — the port's counterpart of the reference package's
``models/registry.py``: the generic entry points (:func:`forward`,
:func:`make_cache`, :func:`decode_step`; every family) and the slotted and
paged entry points of the serving engines (dense and MoE).

``params`` is the :class:`~repro_torch.models.transformer.LM` module, or
for a config with encoder layers the :class:`~repro_torch.models.encdec.
EncDec` module (each carries its config).  Batches, as in the reference:

  * decoder-only: ``{"tokens": (b, s) int}``;
  * VLM: ``+ {"mrope_positions": (3, b, s) int}`` (optional: without it
    the rotary is the plain one);
  * enc-dec: ``{"src_embeds": (b, s_src, d), "tokens": (b, s) int}``.

A decode batch carries one token column (and a VLM's (3, b, 1)
positions).  The decode cache, the slot cache ``{"k", "v", "lengths"}``
and the arena ``{"k", "v"}`` are written in place, where the reference
returns new ones.
"""
from __future__ import annotations

import copy
from typing import Optional, Tuple, Union

import torch
from torch import nn

from repro_torch.models import encdec as ED
from repro_torch.models import layers as L
from repro_torch.models import moe as M
from repro_torch.models import ssm as S
from repro_torch.models import transformer as T
from repro_torch.models.config import ModelConfig
from repro_torch.sharding import collectives as C
from repro_torch.sharding.rules import MODEL_AXIS

LM = T.LM
Params = Union[T.LM, ED.EncDec]


def init_params(cfg: ModelConfig, *, seed: int = 0,
                device: Optional[torch.device] = None) -> Params:
    """Random weights from ``seed`` on ``device`` (the GPU by default): an
    ``EncDec`` for a config with encoder layers, else an ``LM``."""
    if cfg.n_enc_layers > 0:
        return ED.init_encdec(cfg, seed=seed, device=device)
    return T.init_lm(cfg, seed=seed, device=device)


def _check_cfg(params: Params, cfg: ModelConfig) -> None:
    if cfg != params.cfg:
        raise ValueError(f"cfg {cfg.name!r} is not the config of the "
                         f"params ({params.cfg.name!r})")


def forward(params: Params, batch: dict, cfg: ModelConfig,
            train: bool = False, return_hidden: bool = False
            ) -> Tuple[torch.Tensor, torch.Tensor]:
    """Full-sequence forward -> (logits (b, s, V), aux_loss ()); with
    ``return_hidden`` the final hidden states (b, s, d) in place of the
    logits.  ``aux_loss`` is the MoE layers' summed load-balance loss (0
    for the other families).  The SSM and hybrid families need ``s`` to
    be a multiple of ``cfg.ssm_chunk``.  ``train=True`` is the training
    forward: it records gradients, with per-layer activation
    checkpointing by ``cfg.remat`` / ``cfg.remat_policy`` (on CUDA the
    attention's and the SSD scan's gradients are their backward kernels).
    Without it the forward runs under ``no_grad``."""
    _check_cfg(params, cfg)
    if cfg.n_enc_layers > 0:
        return ED.forward_encdec(params, batch["src_embeds"],
                                 batch["tokens"], return_hidden=return_hidden,
                                 train=train)
    return T.forward_lm(params, batch["tokens"],
                        mrope_positions=batch.get("mrope_positions"),
                        return_hidden=return_hidden, train=train)


def head_weights(params: Params, cfg: ModelConfig) -> torch.Tensor:
    """The LM head as a (d, V_padded) matrix, as the reference's: the
    embedding table's transpose when tied (a view), else the head's."""
    _check_cfg(params, cfg)
    if params.lm_head is None:
        return params.embed.T
    return params.lm_head.weight.T


def make_cache(params: Params, cfg: ModelConfig, batch_size: int,
               max_len: int, src_embeds: Optional[torch.Tensor] = None,
               dtype: torch.dtype = torch.bfloat16,
               device: Optional[torch.device] = None,
               seq_shard: bool = False) -> dict:
    """Decode state for :func:`decode_step` on ``device`` (the GPU by
    default): KV caches of ``max_len`` positions, SSM conv histories (in
    ``dtype``) and f32 states, and ``pos``.  Enc-dec runs the encoder on
    ``src_embeds`` (needed) and keeps every layer's cross K/V; its batch
    is ``src_embeds``'s and ``batch_size`` is ignored, as in the
    reference.  For a rank's shard (:func:`shard_params`) it is the rank's
    part of the whole cache under ``sharding.rules.cache_specs`` on the
    rank's device (``seq_shard``: the KV sequence over ("data",
    "model")), with its ``"layout"`` (:func:`_rank_cache`); ``device`` is
    then ignored."""
    _check_cfg(params, cfg)
    mesh = getattr(params, "mesh", None)
    if mesh is not None and mesh.distributed:
        return _rank_cache(params, cfg, batch_size, max_len, src_embeds,
                           dtype, seq_shard)
    if cfg.n_enc_layers > 0:
        if src_embeds is None:
            raise ValueError("enc-dec decode needs encoder inputs "
                             "(src_embeds)")
        return ED.init_encdec_cache(params, src_embeds, max_len, dtype,
                                    device)
    return T.init_kv_cache(cfg, batch_size, max_len, dtype, device)


def _whole_cache(cfg: ModelConfig, batch: int, max_len: int,
                 s_src: int, dtype: torch.dtype) -> dict:
    """The whole decode cache's shapes and types, on the meta device."""
    if cfg.n_enc_layers == 0:
        return T.init_kv_cache(cfg, batch, max_len, dtype, "meta")
    kv = (cfg.n_layers, batch, max_len, cfg.n_kv_heads, cfg.d_head)
    x = (cfg.n_layers, batch, s_src, cfg.n_kv_heads, cfg.d_head)
    meta = dict(dtype=dtype, device="meta")
    return {"xk": torch.empty(x, **meta), "xv": torch.empty(x, **meta),
            "k": torch.empty(kv, **meta), "v": torch.empty(kv, **meta),
            "pos": torch.empty((), dtype=torch.int32, device="meta")}


def _rank_cache(params: Params, cfg: ModelConfig, batch: int, max_len: int,
                src_embeds, dtype, seq_shard: bool) -> dict:
    """A rank's decode cache: every tensor of the whole cache cut to the
    rank's part under ``rules.cache_specs`` (batch over the data axes, KV
    heads over "model" or the sequence over "model" — or over ("data",
    "model") with ``seq_shard`` —, SSM states by head and conv histories
    by channel), zero, on the rank's device; an enc-dec's cross K/V from
    the rank's encoder on its rows of ``src_embeds``.  ``"layout"`` holds
    the rank's rows (``transformer._Rows``) and the cuts of its self and
    cross KV caches (``layers.KVCut``, None when the family has none)."""
    from repro_torch.sharding import rules
    mesh = params.mesh
    dev = next(params.parameters()).device
    if cfg.n_enc_layers > 0:
        if src_embeds is None:
            raise ValueError("enc-dec decode needs encoder inputs "
                             "(src_embeds)")
        batch = src_embeds.shape[0]
    s_src = src_embeds.shape[1] if src_embeds is not None else 0
    whole = _whole_cache(cfg, batch, max_len, s_src, dtype)
    specs = rules.cache_specs(whole, mesh, cfg, seq_shard=seq_shard)
    # one set of rows a rank: the KV caches' (with seq_shard every rank
    # decodes every row of its segment), which the SSM states and the
    # append-buffer ring follow
    lead = specs["k"] if "k" in specs else specs["ssm"]["state"]
    axes = lead[1]

    def rows_of(tree):
        return {k: (rows_of(v) if isinstance(v, dict) else
                    v[:1] + (axes,) + v[2:] if len(v) > 2 else v)
                for k, v in tree.items()}

    specs = rows_of(specs)

    def local(tree, spec):
        return {k: (local(v, spec[k]) if isinstance(v, dict) else
                    torch.zeros(rules.shard_shape(v.shape, spec[k], mesh),
                                dtype=v.dtype, device=dev))
                for k, v in tree.items()}

    cache = local(whole, specs)
    rows = T._Rows(batch, mesh, rules.axes_of(axes))
    kv = (L.KVCut(specs["k"][1:], max_len, mesh) if "k" in specs
          else None)
    xkv = None
    if cfg.n_enc_layers > 0:
        xkv = L.KVCut(specs["xk"][1:], s_src, mesh)
        memory = ED.encode(params, rows.take(src_embeds).to(dev))
        for li, layer in enumerate(params.dec_layers):
            for buf, t in zip((cache["xk"], cache["xv"]),
                              _cross_part(layer.xattn, memory, xkv, mesh)):
                buf[li].copy_(t)
    cache["layout"] = {"rows": rows, "kv": kv, "xkv": xkv}
    return cache


@torch.no_grad()
def _cross_part(attn: L.Attention, memory: torch.Tensor, cut, mesh):
    """The rank's part of one layer's cross K/V under ``cut``: its heads,
    or every head on its segment of the source positions (zero past the
    source's end)."""
    if not cut.whole_heads:
        return L.cross_kv(attn, memory)
    k, v = attn.project_kv(memory, None, None, all_heads=True)
    if attn.mesh is not None and attn.kv_heads is None:
        k, v = (C.all_gather(t, mesh, MODEL_AXIS).permute(1, 2, 0, 3, 4)
                .flatten(2, 3) for t in (k, v))
    out = []
    for t in (k, v):
        seg = t[:, cut.offset:cut.offset + cut.S_l]
        pad = cut.S_l - seg.shape[1]
        if pad:
            seg = torch.cat([seg, seg.new_zeros((seg.shape[0], pad)
                                                + seg.shape[2:])], 1)
        out.append(seg)
    return out


def decode_step(params: Params, cache: dict, batch: dict,
                cfg: ModelConfig) -> Tuple[torch.Tensor, dict]:
    """One-token decode at ``cache["pos"]`` -> (logits (b, V), cache),
    the cache advanced in place.  With a rank's cache (:func:`make_cache`
    of a rank's shard) ``batch`` is the whole batch: the logits are the
    rank's rows and its slice of the vocab."""
    _check_cfg(params, cfg)
    if cfg.n_enc_layers > 0:
        return ED.decode_step_encdec(params, cache, batch["tokens"])
    return T.decode_step_lm(params, cache, batch["tokens"],
                            mrope_positions=batch.get("mrope_positions"))


def supports_slots(cfg: ModelConfig) -> bool:
    """True when the family can serve through the slotted batched KV
    cache."""
    return cfg.n_enc_layers == 0 and T.supports_slots(cfg)


def make_slot_cache(cfg: ModelConfig, n_slots: int, max_len: int,
                    dtype: torch.dtype = torch.bfloat16,
                    device: Optional[torch.device] = None) -> T.SlotCache:
    """Fixed-capacity batched KV cache with a per-slot ``lengths`` vector."""
    return T.init_slot_cache(cfg, n_slots, max_len, dtype, device)


def prefill_kv(params: LM, batch: dict
               ) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """One-pass prefill -> (logits (b, s, V), k (L, b, s, K, dh), v) so the
    engine fills slot caches without replaying the prompt token by
    token."""
    return T.prefill_kv_lm(params, batch["tokens"])


def decode_slots(params: LM, cache: T.SlotCache, batch: dict,
                 active: torch.Tensor) -> Tuple[torch.Tensor, T.SlotCache]:
    """Batched decode over all slots -> (logits (n_slots, V), cache)."""
    return T.decode_slots_lm(params, cache, batch["tokens"], active)


def make_block_arena(cfg: ModelConfig, n_blocks: int, block_size: int,
                     dtype: torch.dtype = torch.bfloat16,
                     device: Optional[torch.device] = None,
                     mesh=None) -> T.Arena:
    """Paged KV arena (block 0 = junk sink); ``serving.kvpool`` owns the
    free-list / refcount / block-table map of it.  ``mesh`` places it
    under the arena rule (``sharding.rules.arena_spec``: KV heads over
    "model"; a rank holds its heads)."""
    return T.init_block_arena(cfg, n_blocks, block_size, dtype, device,
                              mesh=mesh)


def shard_params(params: Params, cfg: ModelConfig, mesh) -> Params:
    """Place a model under the sharding rules
    (``sharding.rules.param_specs``: Megatron column / row pairs, the head
    guards, expert parallelism) on the mesh's device in this process.  On
    a mesh of one device a shard is the whole tensor, so the model comes
    back on ``mesh.device`` — the same module when it lives there already.
    On a rank mesh it returns the rank's local model: each of the whole
    model's tensors cut to the rank's slice (``rules.local_shard``) and
    copied to the rank's device, sharing no memory with the whole, in a new
    module of the family's own kind (``T.LM`` or ``ED.EncDec``) whose
    attention, MLPs, MoE layers, Mamba2 blocks and vocab know their cut
    (``models/layers.py``, ``models/moe.py``, ``models/ssm.py``) and whose
    ``mesh`` is set; every family is cut.  A whole model on the meta
    device gives a local model on the meta device (the dry run's
    representative rank)."""
    from repro_torch.sharding import rules
    _check_cfg(params, cfg)
    specs = rules.param_specs(params, cfg, mesh)
    dev = mesh.local_device("shard_params")
    if not mesh.distributed:
        if all(p.device == dev for p in params.parameters()):
            return params
        return copy.deepcopy(params).to(dev)
    if next(params.parameters()).is_meta:
        dev = torch.device("meta")
    kind = ED.EncDec if cfg.n_enc_layers > 0 else T.LM
    local = kind(cfg, torch.device("meta"), None).requires_grad_(False)
    whole = dict(params.named_parameters())
    for name, spec in specs.items():
        full = whole[name]
        if len(spec) == full.dim() + 1:          # a stack's layer entry
            spec = spec[1:]
        shard = rules.local_shard(full, spec, mesh).to(
            dev, memory_format=torch.contiguous_format, copy=True)
        owner, _, leaf = name.rpartition(".")
        mod = local.get_submodule(owner) if owner else local
        mod._parameters[leaf] = nn.Parameter(shard, requires_grad=False)
    assert set(specs) == {n for n, _ in local.named_parameters()}, \
        f"{cfg.name}: a parameter has no sharding spec"
    _mark_cut(local, cfg, mesh)
    return local.eval()


def _mark_cut(model: Params, cfg: ModelConfig, mesh) -> None:
    """Tell the rank's modules how they are cut (the head guards and the
    expert rule of ``sharding/rules.py``; a Mamba2 block's heads and the
    groups they read)."""
    m = mesh.shape[MODEL_AXIS]
    r = mesh.coord(MODEL_AXIS)
    H, K, E = cfg.n_heads, cfg.n_kv_heads, cfg.padded_experts
    model.mesh = mesh
    for mod in model.modules():
        if isinstance(mod, S.Mamba2) and m > 1:
            mod.mesh = mesh
            mod.heads, mod.groups = _ssm_cut(cfg, m, r)
            continue
        if isinstance(mod, L.Attention) and H % m == 0:
            mod.mesh, mod.n_heads = mesh, H // m
            if K % m == 0:
                mod.n_kv_heads = K // m
                continue
            # whole KV projections: keep the heads this rank's queries read
            g, hl = H // K, H // m
            lo, hi = r * hl // g, ((r + 1) * hl - 1) // g + 1
            if hl % g and g % hl:
                raise ValueError(
                    f"{cfg.name}: {hl} query heads a rank do not split "
                    f"into whole groups of {g} over {K} KV heads")
            mod.kv_heads, mod.n_kv_heads = (lo, hi), hi - lo
        elif isinstance(mod, L.MLP):
            mod.mesh = mesh
        elif isinstance(mod, M.MoE):
            mod.mesh = mesh
            if E % m == 0:
                mod.experts = (r * (E // m), E // m)


def _ssm_cut(cfg: ModelConfig, m: int, r: int):
    """((first, count) of rank ``r``'s heads of a Mamba2 block on a model
    axis of ``m``, (first, count) of the groups they read)."""
    H, G = cfg.n_ssm_heads, cfg.ssm_groups
    hpg = H // G
    if H % m:
        raise ValueError(f"{cfg.name}: {H} SSM heads do not split over a "
                         f"model axis of {m}")
    hl = H // m
    if hl % hpg and hpg % hl:
        raise ValueError(f"{cfg.name}: {hl} SSM heads a rank do not split "
                         f"into whole groups of {hpg} heads")
    return (r * hl, hl), (r * hl // hpg, max(hl // hpg, 1))


def partial_grads(model: Params) -> Tuple[str, ...]:
    """The names of a rank's replicated parameters that it applies to
    activations cut over "model", so that its gradient of each is a part
    of the whole, summed over "model" before the update: the qk-norm
    scales of a cut attention; its whole K/V projections when the rank
    keeps some of their heads (``kv_heads``); a cut Mamba2 block's
    ``wB`` / ``wC`` and their convs (the rank's heads read them) and its
    gate norm's scale (the rank applies its slice); with
    ``cfg.seq_parallel`` the decoder layers' norm scales, which act on the
    rank's block of the sequence.  Empty on a model axis of one rank.
    Everything else replicated acts on replicated activations — the
    embedding's and the final norm's, the MoE router (its gates enter
    the cut work through ``collectives.copy_to``) — and its gradient is
    whole on every rank."""
    mesh = getattr(model, "mesh", None)
    if mesh is None or mesh.shape[MODEL_AXIS] == 1:
        return ()
    names = []
    for prefix, mod in model.named_modules():
        pre = f"{prefix}." if prefix else ""
        if isinstance(mod, L.Attention) and mod.mesh is not None:
            names += [f"{pre}{n}.scale" for n in ("q_norm", "k_norm")
                      if getattr(mod, n) is not None]
            if mod.kv_heads is not None:
                names += [f"{pre}{n}" for n, _ in mod.named_parameters()
                          if n.startswith(("wk.", "wv."))]
        elif isinstance(mod, S.Mamba2) and mod.mesh is not None:
            names += [f"{pre}{n}" for n in ("wB.weight", "wC.weight",
                                              "conv_B", "conv_C", "conv_bB",
                                              "conv_bC", "gate_norm.scale")]
        elif isinstance(mod, T.DecoderLayer) and model.cfg.seq_parallel \
                and model.cfg.n_heads % mesh.shape[MODEL_AXIS] == 0:
            names += [f"{pre}ln1.scale", f"{pre}ln2.scale"]
    have = dict(model.named_parameters())
    return tuple(n for n in names if n in have)


def greedy_token(params: Params, logits: torch.Tensor) -> torch.Tensor:
    """The greedy token of ``params``' logits (..., V): their argmax, or on
    a rank mesh the pick across the ranks' vocab slices
    (``layers.greedy_token``), the same on every rank."""
    return L.greedy_token(logits, getattr(params, "mesh", None))


def prefill_paged(params: LM, batch: dict, arena: T.Arena,
                  table: torch.Tensor, n_past: int, true_c: int
                  ) -> torch.Tensor:
    """One chunk of chunked prefill for one sequence -> logits (1, C, V).
    Positions n_past..n_past+true_c-1; the padded chunk tail writes into
    the junk block."""
    return T.prefill_paged_lm(params, batch["tokens"], arena, table, n_past,
                              true_c)


def decode_paged(params: LM, arena: T.Arena, batch: dict,
                 tables: torch.Tensor, lengths: torch.Tensor,
                 active: torch.Tensor) -> torch.Tensor:
    """Batched paged decode step -> logits (b, V).  Inactive rows write into
    the junk block."""
    return T.decode_paged_lm(params, arena, batch["tokens"], tables, lengths,
                             active)


def decode_paged_multi(params: LM, arena: T.Arena, batch: dict,
                       tables: torch.Tensor, lengths: torch.Tensor,
                       active: torch.Tensor, n_steps: int
                       ) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """``n_steps`` fused greedy paged decode steps with on-device token
    feedback -> (toks (n_steps, b), next (b, 1), lengths (b,)).  Equal to
    ``n_steps`` host-fed :func:`decode_paged` calls; the caller guarantees
    block-table headroom and ``remaining >= n_steps``."""
    return T.decode_paged_multi_lm(params, arena, batch["tokens"], tables,
                                   lengths, active, n_steps)
