"""mamba2-370m [ssm] — 48L d_model=1024 attention-free, d_inner=2048,
ssm_state=128, 32 SSD heads (head_dim 64), vocab=50280. SSD (state-space
duality) per arXiv:2405.21060. [unverified]

Attention-free: the model-axis shards d_inner / SSD heads instead of attention
heads (DESIGN.md §Arch-applicability). long_500k runs (O(1)-state decode).
"""
from repro_torch.config import ModelConfig

CONFIG = ModelConfig(
    name="mamba2-370m",
    family="ssm",
    num_layers=48,
    d_model=1024,
    num_heads=1,
    num_kv_heads=1,
    d_ff=0,
    vocab_size=50280,
    ssm_state=128,
    ssm_head_dim=64,
    ssm_expand=2,
)

SMOKE = ModelConfig(
    name="mamba2-smoke",
    family="ssm",
    num_layers=3,
    d_model=64,
    num_heads=1,
    num_kv_heads=1,
    d_ff=0,
    vocab_size=512,
    ssm_state=16,
    ssm_head_dim=16,
    ssm_chunk=16,
)

OVERRIDES = {
    "train_4k": {"train_microbatches": 1, "train_remat": "full"},
    "decode_32k": {},
    "long_500k": {},
}
