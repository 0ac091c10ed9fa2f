"""qwen2-moe-a2.7b [moe] — 24L d_model=2048 16H (kv=16) per-expert d_ff=1408
vocab=151936, 60 routed experts top-4 + 4 shared experts.
[hf:Qwen/Qwen1.5-MoE-A2.7B; hf]

60 experts do not divide the 16-way model axis -> TPE scheme (per-expert
hidden sharded over the model axis, 1408/16 = 88), see repro.models.moe.
"""
from repro_torch.config import ModelConfig

CONFIG = ModelConfig(
    name="qwen2-moe-a2.7b",
    family="moe",
    num_layers=24,
    d_model=2048,
    num_heads=16,
    num_kv_heads=16,
    head_dim=128,
    d_ff=1408,
    moe_d_ff=1408,
    vocab_size=151936,
    num_experts=60,
    num_experts_per_tok=4,
    num_shared_experts=4,
)

SMOKE = ModelConfig(
    name="qwen2-moe-smoke",
    family="moe",
    num_layers=2,
    d_model=64,
    num_heads=4,
    num_kv_heads=4,
    head_dim=16,
    d_ff=48,
    moe_d_ff=48,
    vocab_size=512,
    num_experts=6,
    num_experts_per_tok=2,
    num_shared_experts=2,
)

OVERRIDES = {
    "train_4k": {"train_microbatches": 4, "train_remat": "full"},
    "decode_32k": {"serve_kv_dtype": "int8"},
}
