"""gemma-2b [dense] — 18L d_model=2048 8H MQA (kv=1) d_ff=16384 vocab=256000,
GeGLU, head_dim=256, tied + scaled embeddings. [arXiv:2403.08295; hf]

8 heads / kv=1 do not divide the 16-way model axis: attention projections are
replicated (FSDP keeps memory flat); the GeGLU MLP (16384 hidden) and the
256k-vocab embedding carry the TP sharding. Noted in DESIGN.md.
"""
from repro_torch.config import ModelConfig

CONFIG = ModelConfig(
    name="gemma-2b",
    family="dense",
    num_layers=18,
    d_model=2048,
    num_heads=8,
    num_kv_heads=1,
    head_dim=256,
    d_ff=16384,
    vocab_size=256000,
    act="gelu",
    tie_embeddings=True,
    embed_scale=True,
)

SMOKE = ModelConfig(
    name="gemma-smoke",
    family="dense",
    num_layers=2,
    d_model=64,
    num_heads=4,
    num_kv_heads=1,
    head_dim=32,
    d_ff=256,
    vocab_size=512,
    act="gelu",
    tie_embeddings=True,
    embed_scale=True,
)

OVERRIDES = {
    "train_4k": {"train_microbatches": 2, "train_remat": "full"},
    "decode_32k": {},
}
