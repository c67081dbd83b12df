"""Whisper-tiny [arXiv:2212.04356] — encoder-decoder audio transformer.
4L enc + 4L dec, d_model=384, 6 heads (kv=6), d_ff=1536, vocab=51865.
Conv mel frontend is a STUB: ``input_specs`` provides precomputed frame
embeddings (B, 1500, d_model). LayerNorm + ungated GELU MLP, learned
positional embeddings on the decoder, sinusoidal on the encoder."""

from repro_torch.config import ModelConfig

CONFIG = ModelConfig(
    name="whisper-tiny",
    family="audio",
    block="dense",
    num_layers=4,
    d_model=384,
    num_heads=6,
    num_kv_heads=6,
    head_dim=64,
    d_ff=1536,
    vocab_size=51865,
    mlp_act="gelu",
    norm_type="layernorm",
    is_encoder_decoder=True,
    num_encoder_layers=4,
    encoder_seq=1500,
    frontend="audio_stub",
    pos_embed="learned",
)

SMOKE_CONFIG = ModelConfig(
    name="whisper-smoke",
    family="audio",
    block="dense",
    num_layers=2,
    d_model=64,
    num_heads=4,
    num_kv_heads=4,
    head_dim=16,
    d_ff=128,
    vocab_size=256,
    mlp_act="gelu",
    norm_type="layernorm",
    is_encoder_decoder=True,
    num_encoder_layers=2,
    encoder_seq=32,
    frontend="audio_stub",
    pos_embed="learned",
)
