"""gemma3-27b — 62L d_model=5376 32H (GQA kv=16) d_ff=21504 vocab=262144,
5:1 local(window 1024):global attention, qk_norm, dual rope thetas.
[hf:google/gemma-3-27b family]"""
import torch

from repro_torch.models.config import ModelConfig

FULL = ModelConfig(
    name="gemma3-27b", family="dense",
    n_layers=62, d_model=5376, n_heads=32, n_kv_heads=16, d_head=128,
    d_ff=21504, vocab_size=262144,
    qk_norm=True, sliding_window=1024, local_global_ratio=5,
    rope_theta=1e4, global_rope_theta=1e6,
)

SMOKE = FULL.with_(
    name="gemma3-27b-smoke",
    n_layers=6, d_model=64, n_heads=4, n_kv_heads=2, d_head=16,
    d_ff=128, vocab_size=256, sliding_window=8, dtype=torch.float32,
    max_seq_len=64,
)
