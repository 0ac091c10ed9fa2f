"""qwen3-1.7b [dense] — 28L d_model=2048 16H (GQA kv=8) d_ff=6144
vocab=151936, qk-norm, head_dim=128. [hf:Qwen/Qwen3-8B (family); hf]"""
from repro_torch.config import ModelConfig

CONFIG = ModelConfig(
    name="qwen3-1.7b",
    family="dense",
    num_layers=28,
    d_model=2048,
    num_heads=16,
    num_kv_heads=8,
    head_dim=128,
    d_ff=6144,
    vocab_size=151936,
    use_qk_norm=True,
    rope_theta=1_000_000.0,
)

SMOKE = ModelConfig(
    name="qwen3-smoke",
    family="dense",
    num_layers=2,
    d_model=64,
    num_heads=4,
    num_kv_heads=2,
    head_dim=16,
    d_ff=192,
    vocab_size=512,
    use_qk_norm=True,
)

OVERRIDES = {
    "train_4k": {"train_microbatches": 2, "train_remat": "full"},
    "decode_32k": {},
}
