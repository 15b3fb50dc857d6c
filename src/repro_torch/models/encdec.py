"""Encoder-decoder backbone (seamless-m4t-large-v2) — the port's
counterpart of the reference package's ``models/encdec.py``.

The modality frontend is a stub, as in the reference: ``src_embeds`` are
precomputed audio frame embeddings (b, s_src, d).  The encoder is a
bidirectional transformer (``EncoderLayer``: full self-attention at
rotary positions ``0 .. s_src - 1``, then the MLP); the decoder
(``CrossDecoderLayer``) adds to causal self-attention a cross-attention
whose K/V come from the encoder memory (:func:`~repro_torch.models.layers.
cross_kv`, no rotary) and whose queries are not rotated.  Entry points:

  * :func:`init_encdec` — weights from a seed;
  * :func:`encode` and :func:`forward_encdec` — the full-sequence forward;
  * :func:`init_encdec_cache` — the encoder runs once and every decoder
    layer's cross K/V are kept, beside empty self-attention caches;
  * :func:`decode_step_encdec` — one decoder step at a position shared by
    every row, its cross-attention over all ``s_src`` cached positions.

Every attention goes through ``kernels/ops.py``: the encoder's and the
cross-attention's through the contiguous flash kernel with ``causal=False``
(the cross-attention with ``sq = s_tgt`` against ``skv = s_src``), and both
decodes through the contiguous decode kernel, the cross one at one shared
length ``s_src`` made on the device.  The slot cache, the arena and the
engines refuse enc-dec (``registry.supports_slots``), as the reference's
do.

On a rank mesh (``registry.shard_params``) every attention and MLP is
cut as the decoder's (``models/layers.py``; the cross-attention's K/V
projections read the encoder memory, replicated over "model"), the
embedding and the head hold the rank's slice of the vocab, and a rank's
decode cache (``registry.make_cache``) carries its ``"layout"`` as the
decoder-only one does.
"""
from __future__ import annotations

from typing import Optional, Tuple

import torch
from torch import nn

from repro_torch import resolve_device
from repro_torch.models import layers as L
from repro_torch.models.config import ModelConfig

EncDecCache = dict


class EncoderLayer(nn.Module):
    def __init__(self, cfg: ModelConfig, device, gen: torch.Generator):
        super().__init__()
        self.ln1 = L.RMSNorm(cfg.d_model, cfg, device)
        self.attn = L.Attention(cfg, device, gen)
        self.ln2 = L.RMSNorm(cfg.d_model, cfg, device)
        self.mlp = L.MLP(cfg, device, gen)


class CrossDecoderLayer(nn.Module):
    """Causal self-attention, cross-attention over the encoder memory
    (``lnx``, ``xattn``), then the MLP."""

    def __init__(self, cfg: ModelConfig, device, gen: torch.Generator):
        super().__init__()
        self.ln1 = L.RMSNorm(cfg.d_model, cfg, device)
        self.attn = L.Attention(cfg, device, gen)
        self.lnx = L.RMSNorm(cfg.d_model, cfg, device)
        self.xattn = L.Attention(cfg, device, gen)
        self.ln2 = L.RMSNorm(cfg.d_model, cfg, device)
        self.mlp = L.MLP(cfg, device, gen)


class EncDec(nn.Module):
    """Embedding, ``n_enc_layers`` encoder layers and their final norm,
    ``n_layers`` decoder layers, final norm, and the tied (or separate) LM
    head over the padded vocab.  ``mesh`` is the rank mesh of a rank's
    shard (None unsharded)."""

    def __init__(self, cfg: ModelConfig, device, gen: torch.Generator):
        super().__init__()
        self.cfg = cfg
        self.mesh = None
        self.embed = nn.Parameter(L.trunc_normal(
            (cfg.padded_vocab, cfg.d_model), 1.0, cfg.dtype, device, gen))
        self.enc_layers = nn.ModuleList(EncoderLayer(cfg, device, gen)
                                        for _ in range(cfg.n_enc_layers))
        self.dec_layers = nn.ModuleList(CrossDecoderLayer(cfg, device, gen)
                                        for _ in range(cfg.n_layers))
        self.enc_norm = L.RMSNorm(cfg.d_model, cfg, device)
        self.final_norm = L.RMSNorm(cfg.d_model, cfg, device)
        self.lm_head = (None if cfg.tie_embeddings else
                        L.init_dense(cfg.d_model, cfg.padded_vocab, cfg,
                                     device, gen))

    def logits(self, x: torch.Tensor) -> torch.Tensor:
        x = self.final_norm(x)
        if self.mesh is not None:
            head = self.embed if self.lm_head is None else \
                self.lm_head.weight
            return L.embedding_logits(head, x, self.mesh,
                                      self.cfg.padded_vocab)
        if self.lm_head is None:
            return L.embedding_logits(self.embed, x)
        return self.lm_head(x)

    def embed_tokens(self, tokens: torch.Tensor) -> torch.Tensor:
        return L.embedding_apply(self.embed, tokens, self.mesh)


def init_encdec(cfg: ModelConfig, *, seed: int = 0,
                device: Optional[torch.device] = None) -> EncDec:
    """Random weights from ``seed`` (a ``torch.Generator`` on the device),
    with the reference's init distributions."""
    if cfg.n_enc_layers <= 0:
        raise ValueError(f"{cfg.name}: no encoder layers")
    dev = resolve_device(device)
    gen = L.seeded_generator(dev, seed)
    with torch.no_grad():
        model = EncDec(cfg, dev, gen)
    return model.requires_grad_(False).eval()


def _positions(n: int, device) -> torch.Tensor:
    return torch.arange(n, dtype=torch.int32, device=device)


def _rope(cfg: ModelConfig, positions: torch.Tensor):
    return L.rope_table(positions, int(cfg.d_head * cfg.partial_rotary),
                        cfg.rope_theta)


def _enc_layer(x, layer, cos, sin):
    x = x + L.attention_apply(layer.attn, layer.ln1(x), cos, sin,
                              causal=False)
    return x + layer.mlp(layer.ln2(x))


def _dec_layer(x, layer, cos, sin, memory):
    x = x + L.attention_apply(layer.attn, layer.ln1(x), cos, sin)
    x = x + L.attention_apply(layer.xattn, layer.lnx(x), None, None,
                              kv=L.cross_kv(layer.xattn, memory))
    return x + layer.mlp(layer.ln2(x))


def encode(model: EncDec, src_embeds: torch.Tensor, *,
           train: bool = False) -> torch.Tensor:
    """src_embeds (b, s_src, d), cast to the model's type -> the encoder
    memory (b, s_src, d): every layer's full self-attention at rotary
    positions ``0 .. s_src - 1``, then the encoder's final norm.  ``train``
    records gradients, each layer under ``layers.remat``; without it the
    encoder runs under ``no_grad``."""
    cfg = model.cfg
    with L.grad_mode(train):
        x = src_embeds.to(cfg.dtype)
        cos, sin = _rope(cfg, _positions(x.shape[1], x.device))
        layer_fn = L.remat(_enc_layer, cfg, train)
        for layer in model.enc_layers:
            x = layer_fn(x, layer, cos, sin)
        return model.enc_norm(x)


def forward_encdec(model: EncDec, src_embeds: torch.Tensor,
                   tokens: torch.Tensor, *, return_hidden: bool = False,
                   train: bool = False
                   ) -> Tuple[torch.Tensor, torch.Tensor]:
    """Teacher-forced seq2seq forward: src_embeds (b, s_src, d), tokens
    (b, s_tgt) int -> (logits (b, s_tgt, V_padded), aux 0); with
    ``return_hidden`` the final-normed hidden states (b, s_tgt, d) in
    place of the logits.  Each decoder layer: causal self-attention, then
    cross-attention over its own K/V of the encoder memory, then the
    MLP.  ``train`` records gradients with per-layer checkpointing
    (``layers.remat``: "full", "dots" or "none"; "collectives" recomputes
    a layer whole, as the reference's enc-dec); without it the forward
    runs under ``no_grad``."""
    cfg = model.cfg
    with L.grad_mode(train):
        memory = encode(model, src_embeds, train=train)
        x = model.embed_tokens(tokens)
        cos, sin = _rope(cfg, _positions(tokens.shape[1], x.device))
        layer_fn = L.remat(_dec_layer, cfg, train)
        for layer in model.dec_layers:
            x = layer_fn(x, layer, cos, sin, memory)
        aux = torch.zeros((), dtype=torch.float32, device=x.device)
        if return_hidden:
            return model.final_norm(x), aux
        return model.logits(x), aux


@torch.no_grad()
def init_encdec_cache(model: EncDec, src_embeds: torch.Tensor,
                      max_len: int, dtype: torch.dtype = torch.bfloat16,
                      device: Optional[torch.device] = None) -> EncDecCache:
    """Run the encoder once and keep every decoder layer's cross K/V, in
    the reference's layout and the cache's ``dtype``: ``"xk"``, ``"xv"``
    (L, b, s_src, K, dh), ``"k"``, ``"v"`` (L, b, max_len, K, dh) zeros,
    and ``"pos"`` () int32, on ``device`` (the GPU by default)."""
    cfg = model.cfg
    dev = resolve_device(device)
    memory = encode(model, src_embeds)
    xk, xv = zip(*(L.cross_kv(layer.xattn, memory)
                   for layer in model.dec_layers))
    b = memory.shape[0]
    shape = (cfg.n_layers, b, max_len, cfg.n_kv_heads, cfg.d_head)
    return {"xk": torch.stack(xk).to(dtype=dtype, device=dev),
            "xv": torch.stack(xv).to(dtype=dtype, device=dev),
            "k": torch.zeros(shape, dtype=dtype, device=dev),
            "v": torch.zeros(shape, dtype=dtype, device=dev),
            "pos": torch.zeros((), dtype=torch.int32, device=dev)}


@torch.no_grad()
def decode_step_encdec(model: EncDec, cache: EncDecCache,
                       tokens: torch.Tensor
                       ) -> Tuple[torch.Tensor, EncDecCache]:
    """One decoder step at ``cache["pos"]`` for every row.  tokens: (b, 1)
    int.  Self-attention writes its K/V at ``pos`` and attends over the
    first ``pos + 1`` positions; cross-attention's unrotated query attends
    over all ``s_src`` positions of the layer's ``xk`` / ``xv``, at one
    shared () length made on the device (no host copy).  The self caches
    are written IN PLACE and ``cache["pos"]`` becomes ``pos + 1``.
    Returns (logits (b, V_padded), cache)."""
    pos = cache["pos"]
    layout = cache.get("layout")
    cut = xcut = None
    if layout is not None:          # a rank's cache (registry.make_cache)
        tokens = layout["rows"].take(tokens)
        cut, xcut = layout["kv"], layout["xkv"]
    x = model.embed_tokens(tokens)
    cos, sin = _rope(model.cfg, pos[None])
    s_src = xcut.S if xcut is not None else cache["xk"].shape[2]
    x_len = torch.full((), s_src, dtype=torch.int32, device=pos.device)
    b = x.shape[0]
    for li, layer in enumerate(model.dec_layers):
        h = layer.ln1(x)
        if cut is not None and cut.whole_heads:
            x = x + L.attention_decode_seq_apply(
                layer.attn, h, cos, sin, cache["k"][li], cache["v"][li],
                pos, cut)
        else:
            x = x + L.attention_decode_apply(layer.attn, h, cos, sin,
                                             cache["k"][li], cache["v"][li],
                                             pos)
        if xcut is not None and xcut.whole_heads:
            x = x + L.cross_decode_seq_apply(
                layer.xattn, layer.lnx(x), cache["xk"][li], cache["xv"][li],
                x_len, xcut)
        else:
            q = layer.xattn.project_q(layer.lnx(x), None, None)
            o = L.decode_attention(q, cache["xk"][li], cache["xv"][li],
                                   x_len)
            x = x + layer.xattn.out(o.reshape(b, 1, -1))
        x = x + layer.mlp(layer.ln2(x))
    cache["pos"] = pos + 1
    return model.logits(x)[:, 0, :], cache
