"""DBRX-132B [hf:databricks/dbrx-base] — fine-grained MoE: 16 experts, top-4.
40L, d_model=6144, 48 heads (GQA kv=8), per-expert d_ff=10752, vocab=100352."""

from repro_torch.config import ModelConfig

CONFIG = ModelConfig(
    name="dbrx-132b",
    family="moe",
    block="moe",
    num_layers=40,
    d_model=6144,
    num_heads=48,
    num_kv_heads=8,
    head_dim=128,
    d_ff=10752,
    vocab_size=100352,
    mlp_act="swiglu",
    num_experts=16,
    top_k=4,
    rope_theta=500_000.0,
)

SMOKE_CONFIG = ModelConfig(
    name="dbrx-smoke",
    family="moe",
    block="moe",
    num_layers=2,
    d_model=64,
    num_heads=4,
    num_kv_heads=2,
    head_dim=16,
    d_ff=96,
    vocab_size=256,
    mlp_act="swiglu",
    num_experts=4,
    top_k=2,
    moe_group_size=32,
)
