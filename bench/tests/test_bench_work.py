"""The benchmark's work counts against hand counts at the smoke widths."""

import json

import pytest

from bench import work
from conftest import PORT_FIELDS, ROOT


def _smoke(arch):
    from repro_torch.configs import get_smoke_config
    cfg = get_smoke_config(arch)
    return dict({k: getattr(cfg, k) for k in PORT_FIELDS}, kv_block=16)


def test_olmoe_step_counts_top_k_causal_and_needed_logits():
    c = _smoke("olmoe-1b-7b")      # L 2, d 64, H = Hkv = 4, hd 16, f 32,
    #                                 V 256, E 8, top-2
    per_layer = (2 * 64 * 64          # q
                 + 2 * 2 * 64 * 64    # k, v
                 + 2 * 64 * 64        # o
                 + 2 * 64 * 8         # router
                 + 2 * 2 * 3 * 64 * 32)   # two experts, three products
    assert work.token_layer_flops(c) == per_layer == 58368
    step = work.Step(0.0, 1.0, chunks=[(20, 16, 4)], decode=[21])
    pair = 4 * 4 * 16                 # q.k and p.v, 4 heads of 16
    chunk = 2 * (4 * per_layer + pair * (4 * 16 + 4 * 5 // 2))
    head = 2 * 64 * 256               # the prompt's last token only
    decode = 2 * (per_layer + pair * 21) + head
    assert work.model_flops(c, step) == chunk + head + decode == 697856
    # a chunk that does not end its prompt needs no logit
    mid = work.Step(0.0, 1.0, chunks=[(40, 16, 16)])
    assert work.model_flops(c, mid) == 2 * (16 * per_layer
                                            + pair * (16 * 16 + 136))


def test_paged_kernels_read_each_byte_once():
    c = _smoke("olmoe-1b-7b")
    step = work.Step(0.0, 1.0, chunks=[(20, 16, 4)], decode=[21])
    f, b = work.paged_decode_cost(c, step)
    assert f == 2 * 256 * 21
    # K and V of 21 tokens, 4 heads of 16, bf16; q and out; 2 table
    # entries and a length
    assert b == 2 * (2 * 21 * 4 * 16 * 2 + 2 * 4 * 16 * 2 + 4 * 2 + 4)
    f, b = work.paged_mq_cost(c, step)
    assert f == 2 * 256 * 74
    assert b == 2 * (2 * 20 * 4 * 16 * 2 + 2 * 4 * 4 * 16 * 2 + 4 * 2 + 4)


def test_mamba_step_counts_the_recurrence():
    c = _smoke("mamba2-370m")      # L 2, d 64, d_inner 128, state 16,
    #                                 4 heads of 32, conv 4, V 256 tied
    per_layer = (2 * 64 * (2 * 128 + 2 * 16 + 4)    # in_proj
                 + 2 * 4 * (128 + 32)               # conv
                 + 5 * 4 * 32 * 16                  # recurrence
                 + 2 * 128 * 64)                    # out_proj
    assert work.token_layer_flops(c) == per_layer == 65280
    step = work.Step(0.0, 1.0, chunks=[(10, 0, 10)])
    f, b = work.ssd_scan_cost(c, step)
    assert f == 2 * 5 * 4 * 32 * 16 * 10
    assert b == 2 * (4 * 10 * (2 * 4 * 32 + 4 + 2 * 16) + 4 * 2 * 4 * 32 * 16)


def test_step_tokens_are_prefilled_plus_generated():
    s = work.Step(0.0, 1.0, chunks=[(300, 256, 44), (600, 0, 256)],
                  decode=[301, 400], generated=4)
    assert s.tokens == 44 + 256 + 4


@pytest.mark.parametrize("name", ["olmoe-1b-7b", "mamba2-370m"])
def test_config_files_state_the_published_sizes_they_run(name):
    """The ``port`` object is what runs; the published keys beside it
    must agree with it."""
    cfg = json.load(open(ROOT / "bench" / "configs" / f"{name}.json"))
    p = cfg["port"]
    if name == "olmoe-1b-7b":
        pairs = [("hidden_size", "d_model"), ("intermediate_size", "d_ff"),
                 ("num_hidden_layers", "num_layers"),
                 ("num_attention_heads", "num_heads"),
                 ("num_key_value_heads", "num_kv_heads"),
                 ("num_experts", "num_experts"),
                 ("num_experts_per_tok", "top_k"),
                 ("vocab_size", "vocab_size"), ("rope_theta", "rope_theta"),
                 ("rms_norm_eps", "norm_eps")]
        assert p["head_dim"] * p["num_heads"] == cfg["hidden_size"]
    else:
        d = cfg["mamba2_layer_defaults"]
        pairs = [("d_model", "d_model"), ("n_layer", "num_layers"),
                 ("vocab_size", "vocab_size")]
        assert p["ssm_state"] == d["d_state"]
        assert p["ssm_d_inner"] == d["expand"] * cfg["d_model"]
        assert p["ssm_head_dim"] == d["headdim"]
        assert p["ssm_conv"] == d["d_conv"]
        assert p["tie_embeddings"] == cfg["tie_embeddings"]
    for pub, port in pairs:
        assert cfg[pub] == p[port], pub
    assert cfg["reduced"] == []
