"""granite-3-2b [dense] — 40L d_model=2048 32H (GQA kv=8) d_ff=8192
vocab=49155, head_dim=64, tied embeddings.
[hf:ibm-granite/granite-3.0-2b-base; hf]"""
from repro_torch.config import ModelConfig

CONFIG = ModelConfig(
    name="granite-3-2b",
    family="dense",
    num_layers=40,
    d_model=2048,
    num_heads=32,
    num_kv_heads=8,
    head_dim=64,
    d_ff=8192,
    vocab_size=49155,
    tie_embeddings=True,
)

SMOKE = ModelConfig(
    name="granite-smoke",
    family="dense",
    num_layers=2,
    d_model=64,
    num_heads=8,
    num_kv_heads=2,
    head_dim=8,
    d_ff=256,
    vocab_size=512,
    tie_embeddings=True,
)

OVERRIDES = {
    "train_4k": {"train_microbatches": 2, "train_remat": "full"},
    "decode_32k": {},
}
