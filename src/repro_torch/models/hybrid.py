"""Zamba2-style hybrid: a Mamba2 backbone with one *shared* transformer block
(attention + MLP, one set of weights) applied after every group of
``hybrid_attn_every`` Mamba2 layers. Counterpart of
``repro/models/hybrid.py``.

Layout: num_layers = n_groups * per + tail Mamba2 layers; the groups are
one (n_groups, per)-leading stack, the tail an L-leading one. The shared
block's KV caches are one per application, stacked over the groups; its
weights are not. The Mamba2 layers' chunk scans run on ``ops.ssd_scan``;
the shared block is ``transformer.block_apply`` with the port's
``serving.kvcache``.
"""
from __future__ import annotations

import torch

from repro_torch.common import dtype_of, fold_seed
from repro_torch.config import ModelConfig
from repro_torch.models import layers as L
from repro_torch.models import ssm
from repro_torch.models import transformer as T
from repro_torch.serving import kvcache


def _plan(cfg: ModelConfig) -> tuple[int, int, int]:
    per = cfg.hybrid_attn_every
    n_groups = cfg.num_layers // per
    tail = cfg.num_layers - n_groups * per
    return n_groups, per, tail


def init(seed: int, cfg: ModelConfig, device="cuda") -> dict:
    """Fresh parameters from ``seed`` on ``device``: the reference's shapes,
    layouts and init distributions, not its numbers (see
    ``transformer.init``)."""
    dtype = dtype_of(cfg.param_dtype)
    n_groups, per, tail = _plan(cfg)
    params = {
        "embed": L.init_embedding(fold_seed(seed, "embed", device=device), cfg, device=device),
        "groups": ssm.init_mamba_block(seed, cfg, "groups", lead=(n_groups, per),
                                       device=device),
        "shared": T.init_block(seed, cfg, "shared", device=device),
        "final_norm": L.init_rmsnorm(cfg.d_model, dtype, device=device),
    }
    if tail:
        params["tail"] = ssm.init_mamba_block(seed, cfg, "tail", lead=(tail,), device=device)
    return params


#: the reference's parameter tree with numpy leaves as the port's parameters
params_from_reference = T.params_from_reference


def forward(params, batch, cfg: ModelConfig, pc=None, *, remat: str = "none"):
    """Train / prefill forward: logits (B, S, V); each group's body (its
    Mamba2 layers, then the shared block) under the ``remat`` policy, the
    tail outside it, as in the reference."""
    x = T.shard_acts(L.embed(params["embed"], batch["tokens"], cfg, pc), pc, model=True)
    b, s, _ = x.shape
    positions = torch.arange(s, dtype=torch.int32, device=x.device).expand(b, s)

    def body(group, shared, x):
        x = ssm.mamba_stack(group, x, cfg, pc=pc)
        return T.shard_acts(T.block_apply(shared, x, cfg, positions=positions, pc=pc)[0], pc)

    body = T.remat_wrap(body, remat)
    for group in T._layers(params["groups"]):
        x = body(group, params["shared"], x)
    if "tail" in params:
        x = ssm.mamba_stack(params["tail"], x, cfg, pc=pc)
    x = L.rmsnorm(params["final_norm"], x, cfg.norm_eps)
    return T.shard_acts(L.unembed(params["embed"], x, cfg), pc, model=True)


def init_cache(cfg: ModelConfig, batch: int, max_len: int, kv_dtype="bfloat16",
               device="cuda") -> dict:
    """Zeros: each group's Mamba2 states (n_groups, per, ...), the shared
    block's kv cache for each application (n_groups, ...), the tail's
    states."""
    n_groups, per, tail = _plan(cfg)
    cache = {
        "groups_ssm": ssm.init_ssm_cache(cfg, batch, lead=(n_groups, per), device=device),
        "attn": kvcache.init_cache(batch, cfg.num_kv_heads, max_len, cfg.resolved_head_dim,
                                   kv_dtype, lead=(n_groups,), device=device),
    }
    if tail:
        cache["tail_ssm"] = ssm.init_ssm_cache(cfg, batch, lead=(tail,), device=device)
    return cache


def decode_step(params, cache, tokens, cache_index, cfg: ModelConfig, pc=None):
    """One decode step of one token per sequence at ``cache_index``. The
    cache is updated in place. Returns (logits (B, 1, V), cache)."""
    x = T.shard_acts(L.embed(params["embed"], tokens, cfg, pc), pc, model=True)
    b, s, _ = x.shape
    positions = (cache_index + torch.arange(s, dtype=torch.int32, device=x.device)
                 ).expand(b, s)
    for gi, group in enumerate(T._layers(params["groups"])):
        group_cache = {k: t[gi] for k, t in cache["groups_ssm"].items()}
        x = ssm.mamba_stack(group, x, cfg, cache=group_cache, pc=pc)
        kv = {k: t[gi] for k, t in cache["attn"].items()}
        x, _ = T.block_apply(params["shared"], x, cfg, positions=positions, cache=kv,
                             cache_index=cache_index, pc=pc)
    if "tail" in params:
        x = ssm.mamba_stack(params["tail"], x, cfg, cache=cache["tail_ssm"], pc=pc)
    x = L.rmsnorm(params["final_norm"], x, cfg.norm_eps)
    return T.shard_acts(L.unembed(params["embed"], x, cfg), pc, model=True), cache
