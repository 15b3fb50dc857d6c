"""Architecture configuration — the port's copy of the reference package's
``models/config.py``.

The dataclass keeps every field of the reference, so a config reads the same
in both packages; ``dtype`` is a torch dtype here.  The port's model path
covers every family (``models/transformer.py``, ``models/encdec.py``) and
the append-buffer decode (``decode_window``), on one device or a rank
mesh (``seq_parallel`` there).
"""
from __future__ import annotations

import dataclasses
from typing import Tuple

import torch


@dataclasses.dataclass(frozen=True)
class ModelConfig:
    name: str
    family: str                      # dense | moe | ssm | hybrid | encdec | vlm | audio
    n_layers: int
    d_model: int
    n_heads: int
    n_kv_heads: int
    d_head: int
    d_ff: int
    vocab_size: int

    # --- attention options -------------------------------------------------
    qk_norm: bool = False            # qwen3 / gemma3: RMSNorm on q,k per head
    qkv_bias: bool = False           # qwen2 family
    rope_theta: float = 1.0e4
    partial_rotary: float = 1.0      # glm4: 0.5 (rope on half the head dims)
    sliding_window: int = 0          # 0 = full attention (local layers only)
    local_global_ratio: int = 0      # gemma3: 5 -> pattern [5 local, 1 global]
    global_rope_theta: float = 1.0e6
    mrope_sections: Tuple[int, ...] = ()   # qwen2-vl M-RoPE half-dim sections

    # --- MoE ----------------------------------------------------------------
    n_experts: int = 0
    n_shared_experts: int = 0
    top_k: int = 0
    d_expert_ff: int = 0
    moe_group_size: int = 512        # GShard dispatch group (tokens)
    capacity_factor: float = 1.25
    decode_capacity_factor: float = 4.0   # decode headroom (bounded by group)
    router_aux_weight: float = 0.001  # load-balance auxiliary loss

    # --- SSM (Mamba2 / SSD) --------------------------------------------------
    ssm_state: int = 0
    ssm_conv: int = 4
    ssm_expand: int = 2
    ssm_head_dim: int = 64
    ssm_chunk: int = 256
    ssm_groups: int = 1

    # --- hybrid (zamba2) ------------------------------------------------------
    attn_every: int = 0              # one *shared* attention block per k SSM layers

    # --- enc-dec (seamless backbone) -------------------------------------------
    n_enc_layers: int = 0            # >0 => encoder-decoder; n_layers = decoder

    # --- misc -------------------------------------------------------------------
    tie_embeddings: bool = False
    norm_eps: float = 1.0e-6
    act: str = "silu"                # silu (SwiGLU) | gelu (non-gated)
    dtype: torch.dtype = torch.bfloat16
    max_seq_len: int = 32768         # rope table length (dry-run overrides)
    remat: bool = True               # activation checkpointing for train_step
    remat_policy: str = "full"       # full | dots | collectives | none
    seq_parallel: bool = False       # Megatron-SP residual stream
    decode_window: int = 0           # >0: append-buffer decode cache

    # ---------------------------------------------------------------------------
    @property
    def is_moe(self) -> bool:
        return self.n_experts > 0

    @property
    def is_attention_free(self) -> bool:
        return self.family == "ssm"

    @property
    def d_inner(self) -> int:
        """SSM inner width."""
        return self.ssm_expand * self.d_model

    @property
    def n_ssm_heads(self) -> int:
        return self.d_inner // self.ssm_head_dim

    @property
    def q_per_kv(self) -> int:
        return self.n_heads // max(self.n_kv_heads, 1)

    @property
    def padded_experts(self) -> int:
        """Expert count padded for even expert-parallel sharding (qwen2-moe's
        60 routed experts → 64 on a 16-way model axis; padding experts are
        router-masked and never receive tokens)."""
        if self.n_experts >= 16 and self.n_experts % 16:
            return ((self.n_experts + 15) // 16) * 16
        return self.n_experts

    @property
    def padded_vocab(self) -> int:
        """Embedding-table vocab padded for even sharding over the model axis
        (standard framework practice; cfg.vocab_size stays the logical size).
        Full-size configs pad to a multiple of 512 (covers model-parallel
        degrees up to 512); tiny smoke configs to a multiple of 16."""
        mult = 512 if self.vocab_size >= 4096 else 16
        return ((self.vocab_size + mult - 1) // mult) * mult

    def with_(self, **kw) -> "ModelConfig":
        return dataclasses.replace(self, **kw)

    # --- analytic parameter / FLOP accounting (used by the perf model & tests) --
    def param_count(self) -> int:
        d, dh, H, K = self.d_model, self.d_head, self.n_heads, self.n_kv_heads
        attn = d * dh * H + 2 * d * dh * K + dh * H * d       # q,k,v,o
        if self.act == "silu":
            mlp = 3 * d * self.d_ff
        else:
            mlp = 2 * d * self.d_ff
        norms = 2 * d
        per_layer = 0
        n_attn_layers = self.n_layers
        if self.family == "ssm":
            n_attn_layers = 0
        if self.family == "hybrid" and self.attn_every:
            n_attn_layers = self.n_layers // self.attn_every  # shared block applications
        if self.family in ("ssm", "hybrid"):
            di, N, Hs = self.d_inner, self.ssm_state, self.n_ssm_heads
            ssm = (d * (2 * di + 2 * self.ssm_groups * N + Hs)   # in_proj
                   + self.ssm_conv * (di + 2 * self.ssm_groups * N)  # conv
                   + Hs * 2 + di                                    # A, D, dt_bias… + norm
                   + di * d)                                        # out_proj
            n_ssm = self.n_layers
            total_layers = n_ssm * (ssm + norms)
            if self.family == "hybrid":
                # ONE shared attention+mlp block (weights reused)
                total_layers += attn + mlp + norms
        elif self.is_moe:
            dff = self.d_expert_ff
            moe = self.n_experts * 3 * d * dff + d * self.n_experts
            if self.n_shared_experts:
                moe += self.n_shared_experts * 3 * d * dff
            per_layer = attn + moe + norms
            total_layers = self.n_layers * per_layer
        else:
            per_layer = attn + mlp + norms
            total_layers = self.n_layers * per_layer
        emb = self.vocab_size * d
        head = 0 if self.tie_embeddings else self.vocab_size * d
        enc = 0
        if self.n_enc_layers:
            enc = self.n_enc_layers * (attn + mlp + norms)
            # decoder cross-attention adds another attn block per layer
            total_layers += self.n_layers * attn
        return total_layers + enc + emb + head + d

    def active_param_count(self) -> int:
        """Params touched per token (MoE: only routed top-k + shared experts)."""
        if not self.is_moe:
            return self.param_count()
        d, dh, H, K = self.d_model, self.d_head, self.n_heads, self.n_kv_heads
        attn = d * dh * H + 2 * d * dh * K + dh * H * d
        dff = self.d_expert_ff
        active_moe = (self.top_k + self.n_shared_experts) * 3 * d * dff + d * self.n_experts
        per_layer = attn + active_moe + 2 * d
        emb = self.vocab_size * d
        head = 0 if self.tie_embeddings else self.vocab_size * d
        return self.n_layers * per_layer + emb + head + d

    def flops_per_token(self, seq_len: int = 0, decode: bool = False) -> float:
        """Approximate forward FLOPs/token: 2*N_active + attention term."""
        base = 2.0 * self.active_param_count()
        if self.family == "ssm":
            return base + 2.0 * self.n_layers * self.n_ssm_heads * self.ssm_head_dim * self.ssm_state * 4
        attn_layers = self.n_layers if self.family != "hybrid" else self.n_layers // max(self.attn_every, 1)
        ctx = seq_len if decode else seq_len / 2.0  # causal average
        if self.local_global_ratio and self.sliding_window:
            r = self.local_global_ratio
            local = attn_layers * r // (r + 1)
            glob = attn_layers - local
            ctx_local = min(ctx, self.sliding_window)
            attn_f = 4.0 * (local * ctx_local + glob * ctx) * self.n_heads * self.d_head
        else:
            attn_f = 4.0 * attn_layers * ctx * self.n_heads * self.d_head
        return base + attn_f
