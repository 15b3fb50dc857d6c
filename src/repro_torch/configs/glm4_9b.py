"""glm4-9b — 40L d_model=4096 32H (GQA kv=2) d_ff=13696 vocab=151552,
partial rotary (0.5), QKV bias.  [hf:THUDM/glm-4-9b]"""
import torch

from repro_torch.models.config import ModelConfig

FULL = ModelConfig(
    name="glm4-9b", family="dense",
    n_layers=40, d_model=4096, n_heads=32, n_kv_heads=2, d_head=128,
    d_ff=13696, vocab_size=151552,
    partial_rotary=0.5, qkv_bias=True, rope_theta=1e4,
)

SMOKE = FULL.with_(
    name="glm4-9b-smoke",
    n_layers=2, d_model=64, n_heads=4, n_kv_heads=2, d_head=16,
    d_ff=128, vocab_size=256, dtype=torch.float32, max_seq_len=64,
)
