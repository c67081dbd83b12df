"""Configuration for the PyTorch port: its own copy of the reference's
``ModelConfig``, ``ServeConfig``, ``ShapeConfig``, ``MeshConfig``,
``TrainConfig``, ``RunConfig``, ``pad_to_multiple``, block-family
constants, the workload shapes (``SHAPES``, ``shape_applicable``) and the
meshes (``MESHES``) of ``src/repro/config.py``, field for field, so the
port never imports the JAX package."""

from __future__ import annotations

import dataclasses
import math
from dataclasses import dataclass, field
from typing import Tuple

# Block families. A model is a stack of identical-structure blocks plus
# embeddings; the port serves the dense family so far.
BLOCK_DENSE = "dense"          # attn + gated MLP
BLOCK_MOE = "moe"              # attn + mixture-of-experts FFN
BLOCK_SSM = "ssm"              # Mamba2 SSD block (attention-free)
BLOCK_HYBRID = "hybrid"        # parallel attn + SSM heads (Hymba), + MLP


def pad_to_multiple(x: int, m: int) -> int:
    return ((x + m - 1) // m) * m


@dataclass(frozen=True)
class ModelConfig:
    name: str
    family: str                      # dense | moe | ssm | hybrid | vlm | audio
    block: str                       # one of BLOCK_*
    num_layers: int
    d_model: int
    num_heads: int                   # query heads (0 for attention-free)
    num_kv_heads: int
    head_dim: int
    d_ff: int                        # per-expert FFN hidden dim for MoE
    vocab_size: int

    # --- attention details ---
    qk_norm: bool = False
    qkv_bias: bool = False
    rope_theta: float = 10_000.0
    # sliding-window attention: window size (0 = full attention everywhere)
    swa_window: int = 0
    # layer indices that use full/global attention even when swa_window > 0
    global_layers: Tuple[int, ...] = ()
    logit_softcap: float = 0.0

    # --- MLP ---
    mlp_act: str = "swiglu"          # swiglu | geglu | gelu (ungated)

    # --- MoE ---
    num_experts: int = 0
    top_k: int = 0
    moe_group_size: int = 512
    capacity_factor: float = 1.25

    # --- SSM (Mamba2 / SSD) ---
    ssm_state: int = 0
    ssm_d_inner: int = 0
    ssm_head_dim: int = 64
    ssm_conv: int = 4
    ssm_chunk: int = 128

    # --- norms / embeddings ---
    norm_type: str = "rmsnorm"       # rmsnorm | layernorm
    norm_eps: float = 1e-5
    tie_embeddings: bool = False
    embed_scale: bool = False        # gemma-style sqrt(d_model) input scaling
    rmsnorm_unit_offset: bool = False  # gemma-style (1 + w) RMSNorm weight

    # --- encoder-decoder (whisper) ---
    is_encoder_decoder: bool = False
    num_encoder_layers: int = 0
    encoder_seq: int = 1500

    # --- modality frontend stub (vlm/audio) ---
    frontend: str = "none"           # none | patch_stub | audio_stub
    num_frontend_tokens: int = 0

    # --- positional embedding ---
    pos_embed: str = "rope"          # rope | learned | sinusoidal | none

    # ------------------------------------------------------------------
    @property
    def ssm_heads(self) -> int:
        if self.ssm_d_inner == 0:
            return 0
        return self.ssm_d_inner // self.ssm_head_dim

    @property
    def padded_vocab(self) -> int:
        """Vocab padded to a multiple of 128; logits beyond vocab_size are
        masked."""
        return pad_to_multiple(self.vocab_size, 128)

    @property
    def uses_attention(self) -> bool:
        return self.num_heads > 0

    @property
    def sub_quadratic(self) -> bool:
        if self.block == BLOCK_SSM:
            return True
        if self.block == BLOCK_HYBRID and self.swa_window > 0:
            return True
        return False

    def param_count(self) -> int:
        """Analytical parameter count (embedding + blocks)."""
        d, f, L, V = self.d_model, self.d_ff, self.num_layers, self.padded_vocab
        n = V * d
        if not self.tie_embeddings:
            n += V * d
        per_layer = 0
        if self.uses_attention:
            per_layer += d * self.num_heads * self.head_dim
            per_layer += 2 * d * self.num_kv_heads * self.head_dim
            per_layer += self.num_heads * self.head_dim * d
        if self.block in (BLOCK_DENSE, BLOCK_HYBRID):
            gates = 2 if self.mlp_act in ("swiglu", "geglu") else 1
            per_layer += (gates + 1) * d * f
        if self.block == BLOCK_MOE:
            gates = 2 if self.mlp_act in ("swiglu", "geglu") else 1
            per_layer += self.num_experts * (gates + 1) * d * f
            per_layer += d * self.num_experts
        if self.block in (BLOCK_SSM, BLOCK_HYBRID):
            di, s, h = self.ssm_d_inner, self.ssm_state, self.ssm_heads
            per_layer += d * (2 * di + 2 * s + h)
            per_layer += self.ssm_conv * di
            per_layer += 3 * h + di
            per_layer += di * d
        n += L * per_layer
        if self.is_encoder_decoder:
            enc = self.num_encoder_layers * (
                4 * d * self.num_heads * self.head_dim + 2 * d * f)
            xattn = L * 4 * d * self.num_heads * self.head_dim
            n += enc + xattn
        return n

    def active_param_count(self) -> int:
        """Parameters touched per token (MoE: only top_k experts)."""
        if self.block != BLOCK_MOE:
            return self.param_count()
        d, f, L = self.d_model, self.d_ff, self.num_layers
        gates = 2 if self.mlp_act in ("swiglu", "geglu") else 1
        inactive = L * (self.num_experts - self.top_k) * (gates + 1) * d * f
        return self.param_count() - inactive


@dataclass(frozen=True)
class ServeConfig:
    param_dtype: str = "bfloat16"
    compute_dtype: str = "bfloat16"
    # monolithic prefill on the CPU: attention switches to the chunked
    # online-softmax path above this sequence length (the reference reads
    # these three from its TrainConfig knobs; the card always runs the
    # flash kernel)
    attn_chunk_threshold: int = 2_048
    attn_chunk: int = 512
    # kv-block size of the chunked path (0 = same as attn_chunk)
    attn_chunk_kv: int = 0
    # ring-buffer KV window for long-context decode (sub-quadratic archs)
    ring_buffer: bool = False


@dataclass(frozen=True)
class ShapeConfig:
    """A workload cell's shape: sequence length, batch and kind."""
    name: str
    seq_len: int
    global_batch: int
    kind: str                        # train | prefill | decode

    @property
    def is_train(self) -> bool:
        return self.kind == "train"


TRAIN_4K = ShapeConfig("train_4k", 4_096, 256, "train")
PREFILL_32K = ShapeConfig("prefill_32k", 32_768, 32, "prefill")
DECODE_32K = ShapeConfig("decode_32k", 32_768, 128, "decode")
LONG_500K = ShapeConfig("long_500k", 524_288, 1, "decode")

SHAPES = {s.name: s for s in (TRAIN_4K, PREFILL_32K, DECODE_32K, LONG_500K)}


def shape_applicable(model: ModelConfig, shape: ShapeConfig) -> Tuple[bool, str]:
    """Whether a (model, shape) cell is runnable; returns (ok, reason)."""
    if shape.name == "long_500k" and not model.sub_quadratic:
        return False, "full-attention arch: long_500k skipped (assignment rule)"
    return True, ""


# ---------------------------------------------------------------------------
# Mesh and training knobs
# ---------------------------------------------------------------------------

@dataclass(frozen=True)
class MeshConfig:
    shape: Tuple[int, ...]
    axis_names: Tuple[str, ...]
    # which axes carry the batch dim, which carry tensor parallelism, and
    # which are the "process-level" (inter-pod) axes for ThreadComm
    batch_axes: Tuple[str, ...] = ("data",)
    model_axes: Tuple[str, ...] = ("model",)
    process_axes: Tuple[str, ...] = ()

    @property
    def num_devices(self) -> int:
        return math.prod(self.shape)

    def axis_size(self, name: str) -> int:
        return self.shape[self.axis_names.index(name)]

    @property
    def dp(self) -> int:
        return math.prod(self.axis_size(a)
                         for a in self.batch_axes + self.process_axes)

    @property
    def tp(self) -> int:
        return math.prod(self.axis_size(a) for a in self.model_axes)


SINGLE_POD = MeshConfig(shape=(16, 16), axis_names=("data", "model"))
MULTI_POD = MeshConfig(
    shape=(2, 16, 16), axis_names=("pod", "data", "model"),
    process_axes=("pod",))
# small meshes for CPU tests
TEST_MESH_8 = MeshConfig(shape=(2, 4), axis_names=("data", "model"))
TEST_FLAT_8 = MeshConfig(shape=(8,), axis_names=("ranks",), batch_axes=("ranks",),
                         model_axes=())

MESHES = {"single_pod": SINGLE_POD, "multi_pod": MULTI_POD,
          "test8": TEST_MESH_8, "flat8": TEST_FLAT_8}


@dataclass(frozen=True)
class TrainConfig:
    learning_rate: float = 3e-4
    warmup_steps: int = 100
    total_steps: int = 1_000
    weight_decay: float = 0.1
    beta1: float = 0.9
    beta2: float = 0.95
    eps: float = 1e-8
    grad_clip: float = 1.0
    # gradient synchronization: "spmd" (one step on the global batch),
    # "flat" (explicit flat allreduce = MPI-everywhere analogue),
    # "threadcomm" (explicit two-level hierarchical schedule = the paper's
    # technique)
    grad_sync: str = "spmd"
    remat: bool = True
    param_dtype: str = "bfloat16"
    compute_dtype: str = "bfloat16"
    # gradient accumulation: split the global batch into k sequential
    # microbatches inside the step (activation memory drops ~k x)
    microbatches: int = 1
    # FSDP-shard MoE expert weights over the data axis (dist/sharding.py)
    moe_fsdp: bool = True
    # wire dtype for explicit gradient collectives ("bfloat16" halves the
    # slow-domain bytes: level-1 gradient compression)
    grad_comm_dtype: str = "float32"
    # FSDP at all (False = replicate params over the data axes)
    fsdp: bool = True
    # cross-entropy computed in seq chunks of this size to bound logits
    # memory
    loss_chunk: int = 512
    # attention switches to chunked online-softmax above this seq length
    attn_chunk_threshold: int = 2_048
    attn_chunk: int = 512
    # kv-block size for the chunked path (0 = same as attn_chunk)
    attn_chunk_kv: int = 0
    seed: int = 0


@dataclass(frozen=True)
class RunConfig:
    model: ModelConfig
    shape: ShapeConfig
    mesh: MeshConfig
    train: TrainConfig = field(default_factory=TrainConfig)
    serve: ServeConfig = field(default_factory=ServeConfig)

    def replace(self, **kw) -> "RunConfig":
        return dataclasses.replace(self, **kw)
