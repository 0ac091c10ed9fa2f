"""Family dispatcher + losses. Counterpart of ``repro/models/api.py``: the
launcher, the training step and the serve steps only talk to this module.

Every family is ported: dense, vlm and audio (``transformer``), moe
(``moe``), ssm (``ssm``) and hybrid (``hybrid``).
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


# ---------------------------------------------------------------------------
# Losses
# ---------------------------------------------------------------------------


def cross_entropy(logits: torch.Tensor, labels: torch.Tensor) -> torch.Tensor:
    """Mean token CE. logits (B,S,V) any float dtype (reduction in fp32);
    labels (B,S) with -1 = ignore."""
    valid = labels >= 0
    safe = labels.clamp_min(0).long()
    logits = logits.float()
    logz = torch.logsumexp(logits, dim=-1)
    gold = logits.gather(-1, safe[..., None])[..., 0]
    nll = (logz - gold) * valid
    return nll.sum() / valid.sum().clamp_min(1)


def loss_fn(params, batch: dict, cfg: ModelConfig, pc=None, *, remat: str = "none"):
    """Returns (loss, metrics dict). batch needs 'labels' (B,S)."""
    logits, aux = forward(params, batch, cfg, pc, remat=remat)
    ce = cross_entropy(logits, batch["labels"])
    loss = ce + cfg.router_aux_coef * aux if cfg.family == "moe" else ce
    return loss, {"ce": ce, "aux": aux, "loss": loss}
