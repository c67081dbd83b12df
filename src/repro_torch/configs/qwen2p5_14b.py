"""Qwen2.5-14B [hf:Qwen/Qwen2.5-*] — dense GQA with QKV bias.
48L, d_model=5120, 40 heads (kv=8), d_ff=13824, vocab=152064."""

from repro_torch.config import ModelConfig

CONFIG = ModelConfig(
    name="qwen2.5-14b",
    family="dense",
    block="dense",
    num_layers=48,
    d_model=5120,
    num_heads=40,
    num_kv_heads=8,
    head_dim=128,
    d_ff=13824,
    vocab_size=152064,
    qkv_bias=True,
    mlp_act="swiglu",
    rope_theta=1_000_000.0,
    norm_eps=1e-6,
)

SMOKE_CONFIG = ModelConfig(
    name="qwen2.5-smoke",
    family="dense",
    block="dense",
    num_layers=2,
    d_model=64,
    num_heads=4,
    num_kv_heads=2,
    head_dim=16,
    d_ff=128,
    vocab_size=256,
    qkv_bias=True,
    mlp_act="swiglu",
    norm_eps=1e-6,
)
