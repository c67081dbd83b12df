"""OLMoE-1B-7B [arXiv:2409.02060] — 64 experts, top-8, MHA with QK-norm.
16L, d_model=2048, 16 heads (kv=16), per-expert d_ff=1024, vocab=50304."""

from repro_torch.config import ModelConfig

CONFIG = ModelConfig(
    name="olmoe-1b-7b",
    family="moe",
    block="moe",
    num_layers=16,
    d_model=2048,
    num_heads=16,
    num_kv_heads=16,
    head_dim=128,
    d_ff=1024,
    vocab_size=50304,
    qk_norm=True,
    mlp_act="swiglu",
    num_experts=64,
    top_k=8,
)

SMOKE_CONFIG = ModelConfig(
    name="olmoe-smoke",
    family="moe",
    block="moe",
    num_layers=2,
    d_model=64,
    num_heads=4,
    num_kv_heads=4,
    head_dim=16,
    d_ff=32,
    vocab_size=256,
    qk_norm=True,
    mlp_act="swiglu",
    num_experts=8,
    top_k=2,
    moe_group_size=32,
)
