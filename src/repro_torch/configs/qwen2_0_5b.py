"""qwen2-0.5b — 24L d_model=896 14H (GQA kv=2) d_ff=4864 vocab=151936,
QKV bias, tied embeddings.  [arXiv:2407.10671]"""
import torch

from repro_torch.models.config import ModelConfig

FULL = ModelConfig(
    name="qwen2-0.5b", family="dense",
    n_layers=24, d_model=896, n_heads=14, n_kv_heads=2, d_head=64,
    d_ff=4864, vocab_size=151936,
    qkv_bias=True, tie_embeddings=True, rope_theta=1e6,
)

SMOKE = FULL.with_(
    name="qwen2-0.5b-smoke",
    n_layers=2, d_model=56, n_heads=7, n_kv_heads=1, d_head=8,
    d_ff=128, vocab_size=256, dtype=torch.float32, max_seq_len=64,
)
