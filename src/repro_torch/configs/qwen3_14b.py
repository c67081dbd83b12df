"""Qwen3-14B [hf:Qwen/Qwen3-*] — dense GQA with QK-norm, no biases.
40L, d_model=5120, 40 heads (kv=8), d_ff=17408, vocab=151936."""

from repro_torch.config import ModelConfig

CONFIG = ModelConfig(
    name="qwen3-14b",
    family="dense",
    block="dense",
    num_layers=40,
    d_model=5120,
    num_heads=40,
    num_kv_heads=8,
    head_dim=128,
    d_ff=17408,
    vocab_size=151936,
    qk_norm=True,
    mlp_act="swiglu",
    rope_theta=1_000_000.0,
    norm_eps=1e-6,
)

SMOKE_CONFIG = ModelConfig(
    name="qwen3-smoke",
    family="dense",
    block="dense",
    num_layers=2,
    d_model=64,
    num_heads=4,
    num_kv_heads=2,
    head_dim=16,
    d_ff=128,
    vocab_size=256,
    qk_norm=True,
    mlp_act="swiglu",
    norm_eps=1e-6,
)
