"""Hymba-1.5B [arXiv:2411.13676] — hybrid-head: parallel attention + Mamba(SSD)
heads in every block. 32L, d_model=1600, 25 heads (GQA kv=5), d_ff=5504,
vocab=32001, ssm_state=16. Sliding-window attention everywhere except three
global layers (first / middle / last), per the Hymba paper."""

from repro_torch.config import ModelConfig

CONFIG = ModelConfig(
    name="hymba-1.5b",
    family="hybrid",
    block="hybrid",
    num_layers=32,
    d_model=1600,
    num_heads=25,
    num_kv_heads=5,
    head_dim=64,
    d_ff=5504,
    vocab_size=32001,
    swa_window=2048,
    global_layers=(0, 15, 31),
    mlp_act="swiglu",
    ssm_state=16,
    ssm_d_inner=3200,     # 2x expansion
    ssm_head_dim=64,      # 50 SSM heads
    ssm_conv=4,
    rope_theta=10_000.0,
)

SMOKE_CONFIG = ModelConfig(
    name="hymba-smoke",
    family="hybrid",
    block="hybrid",
    num_layers=2,
    d_model=64,
    num_heads=4,
    num_kv_heads=2,
    head_dim=16,
    d_ff=128,
    vocab_size=256,
    swa_window=16,
    global_layers=(0,),
    mlp_act="swiglu",
    ssm_state=8,
    ssm_d_inner=128,
    ssm_head_dim=32,
    ssm_conv=4,
    ssm_chunk=8,
)
