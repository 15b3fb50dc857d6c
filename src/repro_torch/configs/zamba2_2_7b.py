"""zamba2-2.7b — hybrid: 54 Mamba2 layers (d_model=2560, ssm_state=64) with a
*shared* attention+MLP block (32H kv=32, d_ff=10240) applied every 6 layers.
[arXiv:2411.15242]"""
import torch

from repro_torch.models.config import ModelConfig

FULL = ModelConfig(
    name="zamba2-2.7b", family="hybrid",
    n_layers=54, d_model=2560, n_heads=32, n_kv_heads=32, d_head=80,
    d_ff=10240, vocab_size=32000,
    ssm_state=64, ssm_head_dim=64, ssm_expand=2, ssm_chunk=128,
    attn_every=6,
)

SMOKE = FULL.with_(
    name="zamba2-2.7b-smoke",
    n_layers=4, d_model=64, n_heads=4, n_kv_heads=4, d_head=16,
    d_ff=128, vocab_size=256, ssm_state=8, ssm_head_dim=8, ssm_chunk=8,
    attn_every=2, dtype=torch.float32, max_seq_len=64,
)
