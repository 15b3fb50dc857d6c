"""seamless-m4t-large-v2 — enc-dec backbone: 24 enc + 24 dec layers,
d_model=1024 16H (kv=16) d_ff=8192 vocab=256206.  Audio frontend stubbed:
inputs are precomputed frame embeddings.  [arXiv:2308.11596]"""
import torch

from repro_torch.models.config import ModelConfig

FULL = ModelConfig(
    name="seamless-m4t-large-v2", family="audio",
    n_layers=24, n_enc_layers=24,
    d_model=1024, n_heads=16, n_kv_heads=16, d_head=64,
    d_ff=8192, vocab_size=256206, act="gelu",
)

SMOKE = FULL.with_(
    name="seamless-m4t-large-v2-smoke",
    n_layers=2, n_enc_layers=2, d_model=64, n_heads=4, n_kv_heads=4,
    d_head=16, d_ff=128, vocab_size=256, dtype=torch.float32, max_seq_len=64,
)
