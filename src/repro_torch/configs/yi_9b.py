"""Yi-9B [arXiv:2403.04652] — llama-arch dense GQA.
48L, d_model=4096, 32 heads (kv=4), d_ff=11008, vocab=64000."""

from repro_torch.config import ModelConfig

CONFIG = ModelConfig(
    name="yi-9b",
    family="dense",
    block="dense",
    num_layers=48,
    d_model=4096,
    num_heads=32,
    num_kv_heads=4,
    head_dim=128,
    d_ff=11008,
    vocab_size=64000,
    mlp_act="swiglu",
    rope_theta=5_000_000.0,
)

SMOKE_CONFIG = ModelConfig(
    name="yi-smoke",
    family="dense",
    block="dense",
    num_layers=2,
    d_model=64,
    num_heads=4,
    num_kv_heads=2,
    head_dim=16,
    d_ff=128,
    vocab_size=256,
    mlp_act="swiglu",
)
