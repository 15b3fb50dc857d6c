"""qwen3-1.7b — 28L d_model=2048 16H (GQA kv=8) d_ff=6144 vocab=151936,
qk_norm.  [hf:Qwen/Qwen3-1.7B family; arXiv:2505.09388]"""
import torch

from repro_torch.models.config import ModelConfig

FULL = ModelConfig(
    name="qwen3-1.7b", family="dense",
    n_layers=28, d_model=2048, n_heads=16, n_kv_heads=8, d_head=128,
    d_ff=6144, vocab_size=151936,
    qk_norm=True, rope_theta=1e6, tie_embeddings=True,
)

SMOKE = FULL.with_(
    name="qwen3-1.7b-smoke",
    n_layers=2, d_model=64, n_heads=4, n_kv_heads=2, d_head=16,
    d_ff=128, vocab_size=256, dtype=torch.float32, max_seq_len=64,
)
