"""Family dispatcher + losses. Counterpart of ``repro/models/api.py``: the
launcher, the training step and the serve steps only talk to this module.

Every family is ported: dense, vlm and audio (``transformer``), moe
(``moe``), ssm (``ssm``) and hybrid (``hybrid``).
"""
from __future__ import annotations

import torch

from repro_torch.config import ModelConfig
from repro_torch.models import hybrid, moe, ssm, transformer
from repro_torch.parallel.ctx import batch_input, replicated

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
    zero = torch.zeros((), dtype=torch.float32, device=logits.device)
    return logits, (zero if pc is None else replicated(zero, pc))


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


def _nll(logits: torch.Tensor, labels: torch.Tensor):
    """(summed token NLL, number of valid labels), fp32."""
    valid = labels >= 0
    safe = labels.clamp_min(0).long()
    logits = logits.float()
    logz = torch.logsumexp(logits, dim=-1)
    gold = logits.gather(-1, safe[..., None])[..., 0]
    return ((logz - gold) * valid).sum(), valid.sum()


def cross_entropy(logits: torch.Tensor, labels: torch.Tensor, pc=None) -> torch.Tensor:
    """Mean token CE. logits (B,S,V) any float dtype (reduction in fp32);
    labels (B,S) with -1 = ignore. With a ParallelCtx each rank sums its
    own rows' NLL (``_sharded_nll``), and the sums are reduced over the
    batch axes."""
    if pc is None:
        nll, count = _nll(logits, labels)
    else:
        nll, count = _sharded_nll(logits, batch_input(labels, pc), pc)
    return nll / count.clamp_min(1)


def _sharded_nll(logits, labels, pc):
    """(summed NLL, valid count) of DTensor logits sharded by batch and,
    where the logits are, by vocab over the model axis: each rank takes its
    vocab slice's row max, then its exp-sum against the rows' max and its
    share of the gold logits, so only (B, S) statistics cross the model
    axis, never the logits."""
    from repro_torch.parallel.ctx import P, Sum, constrain, shard_map

    bt = pc.batch_for(logits.shape[0])
    m = pc.model_axis
    split = logits.placements[pc.mesh.mesh_dim_names.index(m)].is_shard(2)
    rows, tok = P(bt, None, m if split else None), P(bt, None)
    share = Sum(tok, (m,)) if split else tok
    rank = pc.mesh.get_local_rank(m) if split else 0

    def row_max(lg):  # a constant shift: no gradient flows through it
        return lg.detach().float().amax(dim=-1)

    peak = shard_map(row_max, pc, (rows,), Sum(tok, (m,), "max") if split else tok)(logits)
    peak = constrain(peak, pc, *tok)

    def body(lg, lab, mx):
        lg = lg.float()
        vl = lg.shape[-1]
        total = torch.exp(lg - mx[..., None]).sum(dim=-1)
        local = lab.long() - rank * vl
        mine = (local >= 0) & (local < vl)
        gold = lg.gather(-1, local.clamp(0, vl - 1)[..., None])[..., 0] * mine
        return total, gold

    total, gold = shard_map(body, pc, (rows, tok, tok), (share, share))(logits, labels, peak)
    valid = labels >= 0
    return ((torch.log(total) + peak - gold) * valid).sum(), valid.sum()


def loss_fn(params, batch: dict, cfg: ModelConfig, pc=None, *, remat: str = "none"):
    """Returns (loss, metrics dict). batch needs 'labels' (B,S)."""
    logits, aux = forward(params, batch, cfg, pc, remat=remat)
    ce = cross_entropy(logits, batch["labels"], pc)
    loss = ce + cfg.router_aux_coef * aux if cfg.family == "moe" else ce
    return loss, {"ce": ce, "aux": aux, "loss": loss}
