"""Family dispatcher. Counterpart of ``repro/models/api.py``.

Every family is ported: dense, vlm and audio (``transformer``), moe
(``moe``), ssm (``ssm``) and hybrid (``hybrid``). The losses come with the
training slice of the port.
"""
from __future__ import annotations

import torch

from repro_torch.config import ModelConfig
from repro_torch.models import hybrid, moe, ssm, transformer

_FAMS = {
    "dense": transformer,
    "vlm": transformer,
    "audio": transformer,
    "moe": moe,
    "ssm": ssm,
    "hybrid": hybrid,
}


def module_for(cfg: ModelConfig):
    return _FAMS[cfg.family]


def init(seed: int, cfg: ModelConfig, device="cuda"):
    return module_for(cfg).init(seed, cfg, device=device)


def forward(params, batch: dict, cfg: ModelConfig, pc=None, *, remat: str = "none"):
    """Returns (logits, aux_loss_scalar): the moe family's router loss,
    zeros for the others."""
    mod = module_for(cfg)
    if cfg.family == "moe":
        return mod.forward(params, batch, cfg, pc, remat=remat)
    logits = mod.forward(params, batch, cfg, pc, remat=remat)
    return logits, torch.zeros((), dtype=torch.float32, device=logits.device)


def init_cache(cfg: ModelConfig, batch: int, max_len: int, kv_dtype="bfloat16",
               device="cuda"):
    if not cfg.decoder:
        raise ValueError(f"{cfg.name} is encoder-only: no decode cache")
    return module_for(cfg).init_cache(cfg, batch, max_len, kv_dtype, device=device)


def decode_step(params, cache, tokens, cache_index, cfg: ModelConfig, pc=None):
    return module_for(cfg).decode_step(params, cache, tokens, cache_index, cfg, pc)
