"""qwen3-moe-30b-a3b — 48L d_model=2048 32H (GQA kv=4) expert_ff=768
vocab=151936, MoE 128 experts top-8.  [hf:Qwen/Qwen3-30B-A3B]"""
import torch

from repro_torch.models.config import ModelConfig

FULL = ModelConfig(
    name="qwen3-moe-30b-a3b", family="moe",
    n_layers=48, d_model=2048, n_heads=32, n_kv_heads=4, d_head=128,
    d_ff=0, vocab_size=151936,
    n_experts=128, top_k=8, d_expert_ff=768,
    qk_norm=True, rope_theta=1e6,
)

SMOKE = FULL.with_(
    name="qwen3-moe-30b-a3b-smoke",
    n_layers=2, d_model=64, n_heads=4, n_kv_heads=2, d_head=16,
    vocab_size=256, n_experts=8, top_k=2, d_expert_ff=32,
    moe_group_size=64, dtype=torch.float32, max_seq_len=64,
)
