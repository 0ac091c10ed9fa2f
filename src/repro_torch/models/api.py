"""Family dispatcher. Counterpart of ``repro/models/api.py``.

The dense transformer families (dense, vlm, audio) are ported; the moe, ssm
and hybrid families, and the losses, come with later slices of the port and
raise ``NotImplementedError`` until then.
"""
from __future__ import annotations

import torch

from repro_torch.config import ModelConfig
from repro_torch.models import transformer

_FAMS = {
    "dense": transformer,
    "vlm": transformer,
    "audio": transformer,
}
_LATER = {
    "moe": "models/moe.py with the gmm kernel",
    "ssm": "models/ssm.py with the ssd_scan kernel",
    "hybrid": "models/hybrid.py with the ssd_scan kernel",
}


def module_for(cfg: ModelConfig):
    if cfg.family in _LATER:
        raise NotImplementedError(
            f"the {cfg.family} family comes with a later slice of the port "
            f"({_LATER[cfg.family]}; ROADMAP Queue 1, item 8)")
    return _FAMS[cfg.family]


def init(seed: int, cfg: ModelConfig, device="cuda"):
    return module_for(cfg).init(seed, cfg, device=device)


def forward(params, batch: dict, cfg: ModelConfig, pc=None, *, remat: str = "none"):
    """Returns (logits, aux_loss_scalar)."""
    logits = module_for(cfg).forward(params, batch, cfg, pc, remat=remat)
    return logits, torch.zeros((), dtype=torch.float32, device=logits.device)


def init_cache(cfg: ModelConfig, batch: int, max_len: int, kv_dtype="bfloat16",
               device="cuda"):
    if not cfg.decoder:
        raise ValueError(f"{cfg.name} is encoder-only: no decode cache")
    return module_for(cfg).init_cache(cfg, batch, max_len, kv_dtype, device=device)


def decode_step(params, cache, tokens, cache_index, cfg: ModelConfig, pc=None):
    return module_for(cfg).decode_step(params, cache, tokens, cache_index, cfg, pc)
