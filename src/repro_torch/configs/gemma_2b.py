"""Gemma-2B [arXiv:2403.08295] — dense, MQA (kv=1), head_dim=256, GeGLU,
18L, d_model=2048, d_ff=16384, vocab=256000. Gemma details: sqrt(d_model)
embedding scale, (1+w) RMSNorm, tied embeddings."""

from repro_torch.config import ModelConfig

CONFIG = ModelConfig(
    name="gemma-2b",
    family="dense",
    block="dense",
    num_layers=18,
    d_model=2048,
    num_heads=8,
    num_kv_heads=1,
    head_dim=256,
    d_ff=16384,
    vocab_size=256000,
    mlp_act="geglu",
    tie_embeddings=True,
    embed_scale=True,
    rmsnorm_unit_offset=True,
    norm_eps=1e-6,
)

SMOKE_CONFIG = ModelConfig(
    name="gemma-smoke",
    family="dense",
    block="dense",
    num_layers=2,
    d_model=64,
    num_heads=4,
    num_kv_heads=1,
    head_dim=32,
    d_ff=128,
    vocab_size=256,
    mlp_act="geglu",
    tie_embeddings=True,
    embed_scale=True,
    rmsnorm_unit_offset=True,
    norm_eps=1e-6,
)
