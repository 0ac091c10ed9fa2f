"""zamba2-7b [hybrid] — 81 Mamba2 layers d_model=3584 (d_inner=7168,
ssm_state=64, 112 SSD heads) + ONE shared transformer block (32H kv=32
head_dim=112, d_ff=14336) applied every 6 layers. vocab=32000.
[arXiv:2411.15242; unverified]

Sub-quadratic: long_500k runs (SSD state decode + 13 shared-attn KV caches).
Zamba2's per-application LoRA deltas on the shared block are omitted
(DESIGN.md §What we did not take).
"""
from repro_torch.config import ModelConfig

CONFIG = ModelConfig(
    name="zamba2-7b",
    family="hybrid",
    num_layers=81,
    d_model=3584,
    num_heads=32,
    num_kv_heads=32,
    head_dim=112,
    d_ff=14336,
    vocab_size=32000,
    ssm_state=64,
    ssm_head_dim=64,
    ssm_expand=2,
    hybrid_attn_every=6,
)

SMOKE = ModelConfig(
    name="zamba2-smoke",
    family="hybrid",
    num_layers=5,
    d_model=64,
    num_heads=4,
    num_kv_heads=4,
    head_dim=16,
    d_ff=128,
    vocab_size=512,
    ssm_state=16,
    ssm_head_dim=16,
    ssm_chunk=16,
    hybrid_attn_every=2,
)

OVERRIDES = {
    "train_4k": {"train_microbatches": 4, "train_remat": "full"},
    "decode_32k": {"serve_kv_dtype": "int8"},
    "long_500k": {"serve_kv_dtype": "int8", "serve_shard_cache_seq": True},
}
