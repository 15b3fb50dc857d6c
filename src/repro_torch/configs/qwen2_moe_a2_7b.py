"""qwen2-moe-a2.7b — 24L d_model=2048 16H (GQA kv=16) expert_ff=1408
vocab=151936, MoE 60 routed top-4 + 4 shared.  [hf:Qwen/Qwen1.5-MoE-A2.7B]"""
import torch

from repro_torch.models.config import ModelConfig

FULL = ModelConfig(
    name="qwen2-moe-a2.7b", family="moe",
    n_layers=24, d_model=2048, n_heads=16, n_kv_heads=16, d_head=128,
    d_ff=0, vocab_size=151936,
    n_experts=60, top_k=4, d_expert_ff=1408, n_shared_experts=4,
    qkv_bias=True, rope_theta=1e6,
)

SMOKE = FULL.with_(
    name="qwen2-moe-a2.7b-smoke",
    n_layers=2, d_model=64, n_heads=4, n_kv_heads=4, d_head=16,
    vocab_size=256, n_experts=6, top_k=2, d_expert_ff=32, n_shared_experts=2,
    moe_group_size=64, dtype=torch.float32, max_seq_len=64,
)
