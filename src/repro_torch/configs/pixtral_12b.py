"""pixtral-12b [vlm] — Pixtral-ViT frontend (stub) + Mistral-Nemo-12B backbone.
40L d_model=5120 32H (GQA kv=8) d_ff=14336 vocab=131072, head_dim=128.
[hf:mistralai/Pixtral-12B-2409; unverified]

The vision frontend is a STUB per assignment: input_specs() provides
precomputed 1024-d patch embeddings (Pixtral's ViT width); a learned connector
projects them into the 5120-d backbone stream, prepended to the text tokens.
"""
from repro_torch.config import ModelConfig

CONFIG = ModelConfig(
    name="pixtral-12b",
    family="vlm",
    num_layers=40,
    d_model=5120,
    num_heads=32,
    num_kv_heads=8,
    head_dim=128,
    d_ff=14336,
    vocab_size=131072,
    rope_theta=1_000_000.0,
    frontend="vision_patches",
    frontend_dim=1024,
    num_patches=1024,  # 32x32 patch grid prepended to the text sequence
)

SMOKE = ModelConfig(
    name="pixtral-smoke",
    family="vlm",
    num_layers=2,
    d_model=128,
    num_heads=8,
    num_kv_heads=2,
    head_dim=16,
    d_ff=256,
    vocab_size=512,
    frontend="vision_patches",
    frontend_dim=32,
    num_patches=8,
)

OVERRIDES = {
    "train_4k": {"train_microbatches": 4, "train_remat": "full"},
    "prefill_32k": {},
    "decode_32k": {"serve_kv_dtype": "int8"},
}
