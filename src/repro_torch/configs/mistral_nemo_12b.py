"""mistral-nemo-12b [dense] — 40L d_model=5120 32H (GQA kv=8) d_ff=14336
vocab=131072, head_dim=128, 128k context (rope theta 1e6).
[hf:mistralai/Mistral-Nemo-Base-2407; hf]"""
from repro_torch.config import ModelConfig

CONFIG = ModelConfig(
    name="mistral-nemo-12b",
    family="dense",
    num_layers=40,
    d_model=5120,
    num_heads=32,
    num_kv_heads=8,
    head_dim=128,
    d_ff=14336,
    vocab_size=131072,
    rope_theta=1_000_000.0,
)

SMOKE = ModelConfig(
    name="nemo-smoke",
    family="dense",
    num_layers=2,
    d_model=128,
    num_heads=8,
    num_kv_heads=2,
    head_dim=16,
    d_ff=384,
    vocab_size=512,
)

OVERRIDES = {
    "train_4k": {"train_microbatches": 4, "train_remat": "full"},
    "decode_32k": {"serve_kv_dtype": "int8"},
}
