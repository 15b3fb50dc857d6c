"""qwen2-vl-7b — 28L d_model=3584 28H (GQA kv=4) d_ff=18944 vocab=152064,
M-RoPE (sections 16/24/24 over half-dims), QKV bias.  Vision frontend stubbed:
patch embeddings arrive precomputed.  [arXiv:2409.12191]"""
import torch

from repro_torch.models.config import ModelConfig

FULL = ModelConfig(
    name="qwen2-vl-7b", family="vlm",
    n_layers=28, d_model=3584, n_heads=28, n_kv_heads=4, d_head=128,
    d_ff=18944, vocab_size=152064,
    qkv_bias=True, mrope_sections=(16, 24, 24), rope_theta=1e6,
)

SMOKE = FULL.with_(
    name="qwen2-vl-7b-smoke",
    n_layers=2, d_model=64, n_heads=4, n_kv_heads=2, d_head=16,
    d_ff=128, vocab_size=256, mrope_sections=(4, 2, 2),
    dtype=torch.float32, max_seq_len=64,
)
