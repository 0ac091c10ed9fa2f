"""hubert-xlarge [audio] — 48L d_model=1280 16H (kv=16) d_ff=5120 vocab=504,
encoder-only (non-causal); wav2vec2-style conv feature extractor is a STUB:
input_specs() provides precomputed 512-d frames, a learned in_proj lifts them
to 1280. [arXiv:2106.07447; unverified]

Encoder-only: decode_32k and long_500k are skipped (no autoregressive step).
"""
from repro_torch.config import ModelConfig

CONFIG = ModelConfig(
    name="hubert-xlarge",
    family="audio",
    num_layers=48,
    d_model=1280,
    num_heads=16,
    num_kv_heads=16,
    head_dim=80,
    d_ff=5120,
    vocab_size=504,
    causal=False,
    frontend="audio_frames",
    frontend_dim=512,
)

SMOKE = ModelConfig(
    name="hubert-smoke",
    family="audio",
    num_layers=2,
    d_model=64,
    num_heads=4,
    num_kv_heads=4,
    head_dim=16,
    d_ff=128,
    vocab_size=64,
    causal=False,
    frontend="audio_frames",
    frontend_dim=32,
)

OVERRIDES = {
    "train_4k": {"train_microbatches": 2, "train_remat": "full"},
}
