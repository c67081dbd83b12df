"""InternVL2-Llama3-76B [arXiv:2404.16821] — VLM: InternViT-6B frontend (STUB:
``input_specs`` provides precomputed patch embeddings) + Llama-3-70B-class LM
backbone: 80L, d_model=8192, 64 heads (GQA kv=8), d_ff=28672, vocab=128256."""

from repro_torch.config import ModelConfig

CONFIG = ModelConfig(
    name="internvl2-76b",
    family="vlm",
    block="dense",
    num_layers=80,
    d_model=8192,
    num_heads=64,
    num_kv_heads=8,
    head_dim=128,
    d_ff=28672,
    vocab_size=128256,
    mlp_act="swiglu",
    rope_theta=500_000.0,
    frontend="patch_stub",
    num_frontend_tokens=256,   # one image tile worth of projected patch tokens
)

SMOKE_CONFIG = ModelConfig(
    name="internvl2-smoke",
    family="vlm",
    block="dense",
    num_layers=2,
    d_model=64,
    num_heads=4,
    num_kv_heads=2,
    head_dim=16,
    d_ff=128,
    vocab_size=256,
    mlp_act="swiglu",
    frontend="patch_stub",
    num_frontend_tokens=8,
)
