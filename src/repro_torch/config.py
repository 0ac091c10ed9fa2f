"""Configuration dataclasses for models, meshes, training and serving.

Every assigned architecture is expressed as a ``ModelConfig``; shapes (train_4k,
prefill_32k, decode_32k, long_500k) are ``ShapeConfig``s; the launcher composes
them with a ``MeshConfig`` into a ``RunConfig``.

A copy of ``repro/config.py`` (pure Python), kept field for field equal to it.
"""
from __future__ import annotations

from dataclasses import dataclass, replace

# ---------------------------------------------------------------------------
# Model
# ---------------------------------------------------------------------------


@dataclass(frozen=True)
class ModelConfig:
    name: str = "model"
    family: str = "dense"  # dense | moe | ssm | hybrid | audio(encoder) | vlm
    num_layers: int = 2
    d_model: int = 128
    num_heads: int = 4
    num_kv_heads: int = 4
    head_dim: int = 0  # 0 => d_model // num_heads
    d_ff: int = 512
    vocab_size: int = 1024

    # activations / norms
    act: str = "silu"  # "silu" => SwiGLU, "gelu" => GeGLU
    norm_eps: float = 1e-6
    use_qk_norm: bool = False
    rope_theta: float = 10_000.0
    tie_embeddings: bool = False
    logit_softcap: float = 0.0
    embed_scale: bool = False  # gemma-style sqrt(d_model) embedding scaling

    # attention
    causal: bool = True
    attn_impl: str = "chunked"  # "naive" | "chunked" | "flash_pallas"
    attn_chunk: int = 1024  # query-chunk for the chunked (flash-style) jnp path

    # MoE
    num_experts: int = 0
    num_experts_per_tok: int = 0
    num_shared_experts: int = 0
    moe_d_ff: int = 0  # per-expert hidden; 0 => d_ff
    capacity_factor: float = 1.25
    router_aux_coef: float = 0.01

    # SSM (Mamba2 / SSD)
    ssm_state: int = 0
    ssm_head_dim: int = 64
    ssm_expand: int = 2
    ssm_conv_width: int = 4
    ssm_chunk: int = 256
    ssm_ngroups: int = 1

    # hybrid (zamba2-style): shared attention block applied every k SSM layers
    hybrid_attn_every: int = 6

    # frontend stubs ([audio]/[vlm]): inputs arrive as precomputed embeddings
    frontend: str = "none"  # none | audio_frames | vision_patches
    frontend_dim: int = 0  # embedding dim produced by the stub frontend
    num_patches: int = 0  # vlm: patches prepended to the text sequence

    # numerics
    param_dtype: str = "float32"
    compute_dtype: str = "bfloat16"

    # calibration mode: fully unroll every lax.scan so compiled.cost_analysis()
    # counts true totals (XLA counts a while-loop body ONCE regardless of trip
    # count — see launch/dryrun.py reconstruction)
    unroll_scans: bool = False

    # ---- perf-iteration knobs (§Perf; default OFF = paper-faithful baseline)
    logits_dtype: str = "float32"  # bf16 halves the logits HBM/collective cost
    lazy_kv_dequant: bool = False  # dequantize int8 KV per chunk inside the
    # attention scan instead of materializing the whole bf16 cache

    # sub-quadratic? (decides long_500k applicability)
    @property
    def subquadratic(self) -> bool:
        return self.family in ("ssm", "hybrid")

    @property
    def decoder(self) -> bool:
        return self.family not in ("audio",)

    @property
    def resolved_head_dim(self) -> int:
        return self.head_dim or (self.d_model // max(self.num_heads, 1))

    @property
    def ssm_d_inner(self) -> int:
        return self.ssm_expand * self.d_model

    @property
    def ssm_nheads(self) -> int:
        return self.ssm_d_inner // self.ssm_head_dim

    def scaled(self, **kw) -> "ModelConfig":
        return replace(self, **kw)


# ---------------------------------------------------------------------------
# Shapes (assigned input-shape set)
# ---------------------------------------------------------------------------


@dataclass(frozen=True)
class ShapeConfig:
    name: str
    seq_len: int
    global_batch: int
    mode: str  # "train" | "prefill" | "decode"


SHAPES: dict[str, ShapeConfig] = {
    "train_4k": ShapeConfig("train_4k", 4096, 256, "train"),
    "prefill_32k": ShapeConfig("prefill_32k", 32_768, 32, "prefill"),
    "decode_32k": ShapeConfig("decode_32k", 32_768, 128, "decode"),
    "long_500k": ShapeConfig("long_500k", 524_288, 1, "decode"),
}


# ---------------------------------------------------------------------------
# Mesh / parallelism
# ---------------------------------------------------------------------------


@dataclass(frozen=True)
class MeshConfig:
    multi_pod: bool = False
    # logical-axis assignment; "batch" axes are all axes used for DP
    data_axes: tuple[str, ...] = ("data",)
    model_axis: str = "model"
    pod_axis: str = "pod"
    # FSDP: additionally shard large weights / optimizer state over the data axis
    fsdp_params: bool = True
    fsdp_min_size: int = 2**20  # only shard params at least this big
    # tp=False: model axis becomes a second data axis (§Perf knob)
    tp: bool = True

    @property
    def batch_axes(self) -> tuple[str, ...]:
        return (("pod",) + self.data_axes) if self.multi_pod else self.data_axes


@dataclass(frozen=True)
class TrainConfig:
    microbatches: int = 1  # gradient-accumulation splits of the global batch
    # cast params to compute dtype ONCE at step start so FSDP weight
    # all-gathers move bf16, not fp32 (§Perf knob; off = baseline)
    cast_params_once: bool = False
    remat: str = "none"  # none | dots | full
    learning_rate: float = 3e-4
    warmup_steps: int = 100
    total_steps: int = 1000
    weight_decay: float = 0.1
    beta1: float = 0.9
    beta2: float = 0.95
    eps: float = 1e-8
    grad_clip: float = 1.0
    optimizer: str = "adamw"  # adamw | adafactor | rmsprop | sgd
    grad_compression: str = "none"  # none | int8 — DP all-reduce compression
    seed: int = 0
    # ZeRO-1: shard optimizer state over the data axis where divisible
    zero1: bool = True


@dataclass(frozen=True)
class ServeConfig:
    kv_dtype: str = "bfloat16"  # int8 enables quantized KV cache
    max_seq_len: int = 32_768
    # decode-time sharding of the KV cache sequence dim (flash-decoding style)
    shard_cache_seq: bool = False


@dataclass(frozen=True)
class RunConfig:
    model: ModelConfig
    shape: ShapeConfig
    mesh: MeshConfig = MeshConfig()
    train: TrainConfig = TrainConfig()
    serve: ServeConfig = ServeConfig()

    def replace(self, **kw) -> "RunConfig":
        return replace(self, **kw)
