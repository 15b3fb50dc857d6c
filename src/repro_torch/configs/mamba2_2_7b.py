"""mamba2-2.7b — attention-free SSD: 64L d_model=2560 ssm_state=128
vocab=50280 (expand=2 -> d_inner=5120, 80 heads of 64).  [arXiv:2405.21060]"""
import torch

from repro_torch.models.config import ModelConfig

FULL = ModelConfig(
    name="mamba2-2.7b", family="ssm",
    n_layers=64, d_model=2560, n_heads=0, n_kv_heads=0, d_head=0,
    d_ff=0, vocab_size=50280,
    ssm_state=128, ssm_head_dim=64, ssm_expand=2, ssm_chunk=128,
    tie_embeddings=True,
)

SMOKE = FULL.with_(
    name="mamba2-2.7b-smoke",
    n_layers=4, d_model=64, vocab_size=256, ssm_state=16, ssm_head_dim=8,
    ssm_chunk=8, dtype=torch.float32, max_seq_len=64,
)
