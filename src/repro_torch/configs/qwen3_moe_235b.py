"""qwen3-moe-235b-a22b [moe] — 94L d_model=4096 64H (GQA kv=4) per-expert
d_ff=1536 vocab=151936, MoE 128 experts top-8, qk-norm.
[hf:Qwen/Qwen3-30B-A3B (family); hf]

EP: 128 experts / 16-way model axis = 8 experts per chip; expert weights are
additionally FSDP-sharded over the data axis (227B expert params).
"""
from repro_torch.config import ModelConfig

CONFIG = ModelConfig(
    name="qwen3-moe-235b-a22b",
    family="moe",
    num_layers=94,
    d_model=4096,
    num_heads=64,
    num_kv_heads=4,
    head_dim=128,
    d_ff=1536,
    moe_d_ff=1536,
    vocab_size=151936,
    num_experts=128,
    num_experts_per_tok=8,
    use_qk_norm=True,
    rope_theta=1_000_000.0,
)

SMOKE = ModelConfig(
    name="qwen3-moe-smoke",
    family="moe",
    num_layers=2,
    d_model=64,
    num_heads=8,
    num_kv_heads=2,
    head_dim=8,
    d_ff=96,
    moe_d_ff=96,
    vocab_size=512,
    num_experts=8,
    num_experts_per_tok=2,
    use_qk_norm=True,
)

OVERRIDES = {
    "train_4k": {"train_microbatches": 8, "train_remat": "full",
                 "train_optimizer": "adafactor"},
    "prefill_32k": {},
    "decode_32k": {"serve_kv_dtype": "int8"},
}
