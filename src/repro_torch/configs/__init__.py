"""Architecture registry: the 10 assigned archs + the paper's own ConvNet
spaces. ``make_run(arch, shape)`` composes a full RunConfig with per-cell
tuned defaults (microbatches, remat, KV dtype).

A copy of ``repro/configs/`` (pure Python data), kept field for field
equal to it."""
from __future__ import annotations

import importlib
from typing import Optional

from repro_torch.config import MeshConfig, ModelConfig, RunConfig, ServeConfig, SHAPES, TrainConfig

ARCHS = [
    "pixtral_12b",
    "qwen3_moe_235b",
    "qwen2_moe_a2_7b",
    "gemma_2b",
    "qwen3_1_7b",
    "granite_3_2b",
    "mistral_nemo_12b",
    "hubert_xlarge",
    "zamba2_7b",
    "mamba2_370m",
]

# CLI aliases (--arch ids as assigned)
ALIASES = {
    "pixtral-12b": "pixtral_12b",
    "qwen3-moe-235b-a22b": "qwen3_moe_235b",
    "qwen2-moe-a2.7b": "qwen2_moe_a2_7b",
    "gemma-2b": "gemma_2b",
    "qwen3-1.7b": "qwen3_1_7b",
    "granite-3-2b": "granite_3_2b",
    "mistral-nemo-12b": "mistral_nemo_12b",
    "hubert-xlarge": "hubert_xlarge",
    "zamba2-7b": "zamba2_7b",
    "mamba2-370m": "mamba2_370m",
}


def get(name: str) -> ModelConfig:
    name = ALIASES.get(name, name)
    mod = importlib.import_module(f"repro_torch.configs.{name}")
    return mod.CONFIG


def smoke(name: str) -> ModelConfig:
    """Reduced same-family config for CPU smoke tests."""
    name = ALIASES.get(name, name)
    mod = importlib.import_module(f"repro_torch.configs.{name}")
    return mod.SMOKE


def applicable_shapes(cfg: ModelConfig) -> dict[str, str]:
    """shape name -> 'ok' | skip reason, per DESIGN.md §Arch-applicability."""
    out = {}
    for sname, shape in SHAPES.items():
        if shape.mode == "decode" and not cfg.decoder:
            out[sname] = "skipped(encoder-only)"
        elif sname == "long_500k" and not cfg.subquadratic:
            out[sname] = (
                "skipped(encoder-only)" if not cfg.decoder
                else "skipped(full-attention)"
            )
        else:
            out[sname] = "ok"
    return out


def run_overrides(arch: str, shape_name: str) -> dict:
    """Per-cell tuned defaults (microbatching to fit HBM, KV quantization for
    long decode)."""
    arch = ALIASES.get(arch, arch)
    mod = importlib.import_module(f"repro_torch.configs.{arch}")
    table = getattr(mod, "OVERRIDES", {})
    return dict(table.get(shape_name, {}))


def make_run(
    arch: str,
    shape_name: str,
    multi_pod: bool = False,
    **extra,
) -> RunConfig:
    cfg = get(arch)
    shape = SHAPES[shape_name]
    ov = run_overrides(arch, shape_name)
    ov.update(extra)
    train_kw = {k[6:]: v for k, v in ov.items() if k.startswith("train_")}
    serve_kw = {k[6:]: v for k, v in ov.items() if k.startswith("serve_")}
    mesh_kw = {k[5:]: v for k, v in ov.items() if k.startswith("mesh_")}
    model_kw = {k[6:]: v for k, v in ov.items() if k.startswith("model_")}
    if model_kw:
        cfg = cfg.scaled(**model_kw)
    return RunConfig(
        model=cfg,
        shape=shape,
        mesh=MeshConfig(multi_pod=multi_pod, **mesh_kw),
        train=TrainConfig(**train_kw),
        serve=ServeConfig(**serve_kw),
    )
