"""Mamba2-370M [arXiv:2405.21060] — attention-free SSD (state-space duality).
48L, d_model=1024, d_inner=2048 (32 heads x head_dim 64), ssm_state=128,
vocab=50280."""

from repro_torch.config import ModelConfig

CONFIG = ModelConfig(
    name="mamba2-370m",
    family="ssm",
    block="ssm",
    num_layers=48,
    d_model=1024,
    num_heads=0,
    num_kv_heads=0,
    head_dim=0,
    d_ff=0,
    vocab_size=50280,
    ssm_state=128,
    ssm_d_inner=2048,
    ssm_head_dim=64,
    ssm_conv=4,
    tie_embeddings=True,
    pos_embed="none",
)

SMOKE_CONFIG = ModelConfig(
    name="mamba2-smoke",
    family="ssm",
    block="ssm",
    num_layers=2,
    d_model=64,
    num_heads=0,
    num_kv_heads=0,
    head_dim=0,
    d_ff=0,
    vocab_size=256,
    ssm_state=16,
    ssm_d_inner=128,
    ssm_head_dim=32,
    ssm_conv=4,
    ssm_chunk=8,
    tie_embeddings=True,
    pos_embed="none",
)
