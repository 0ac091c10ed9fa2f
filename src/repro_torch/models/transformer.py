"""Decoder / encoder transformer (dense, VLM-backbone, audio-encoder
families). Counterpart of ``repro/models/transformer.py``.

Layers are stacked along a leading L dim, as in the reference (which scans
over them); the port loops over the stack in Python, each layer's
parameters being views into it (``_layers``). The remat policy is applied to
each layer's body, as the reference applies it to the scanned body.
"""
from __future__ import annotations

import functools
from typing import Optional

import torch
from torch.utils import checkpoint as ckpt

from repro_torch.common import dtype_of, fold_seed, tree_from_numpy, tree_leaves, tree_unflatten
from repro_torch.config import ModelConfig
from repro_torch.models import layers as L
from repro_torch.serving import kvcache

# ---------------------------------------------------------------------------
# Remat policies
# ---------------------------------------------------------------------------

# the products the "dots" policy saves: matrix products with no batch
# dimension (a (B, S, D) @ (D, F) product reaches aten as ``mm``), as
# ``jax.checkpoint_policies.dots_with_no_batch_dims_saveable`` saves them
_DOTS = (torch.ops.aten.mm.default, torch.ops.aten.addmm.default)


def _dots_policy(ctx, op, *args, **kwargs):
    if op in _DOTS:
        return ckpt.CheckpointPolicy.MUST_SAVE
    return ckpt.CheckpointPolicy.PREFER_RECOMPUTE


def remat_wrap(fn, remat: str):
    """``fn`` under the remat policy: ``"full"`` keeps only its inputs and
    recomputes the rest in the backward; ``"dots"`` also keeps the outputs of
    its matrix products with no batch dimension; anything else is ``fn``
    itself. The kernels launch through ``ctypes``, below what a policy sees,
    so under either policy they launch again in the recompute, as the
    reference's Pallas calls are recomputed."""
    if remat == "full":
        return functools.partial(ckpt.checkpoint, fn, use_reentrant=False,
                                 preserve_rng_state=False)
    if remat == "dots":
        return functools.partial(
            ckpt.checkpoint, fn, use_reentrant=False, preserve_rng_state=False,
            context_fn=functools.partial(ckpt.create_selective_checkpoint_contexts,
                                         _dots_policy))
    return fn


# ---------------------------------------------------------------------------
# Parameters
# ---------------------------------------------------------------------------


def init(seed: int, cfg: ModelConfig, device="cuda") -> dict:
    """Fresh parameters from ``seed``, drawn on ``device`` from named
    generators (one per parameter group, every layer's weights as one
    L-leading stack). The reference's shapes, layouts and init
    distributions; not its numbers, since ``jax.random`` is not reproduced."""
    dtype = dtype_of(cfg.param_dtype)

    def gen(*names):
        return fold_seed(seed, *names, device=device)

    params = {
        "embed": L.init_embedding(gen("embed"), cfg, device=device),
        "layers": init_block(seed, cfg, "layers", lead=(cfg.num_layers,), device=device),
        "final_norm": L.init_rmsnorm(cfg.d_model, dtype, device=device),
    }
    if cfg.frontend == "vision_patches":
        params["connector"] = L.dense_init(
            gen("connector"), (cfg.frontend_dim, cfg.d_model), dtype, device=device)
    if cfg.frontend == "audio_frames":
        params["in_proj"] = L.dense_init(
            gen("in_proj"), (cfg.frontend_dim, cfg.d_model), dtype, device=device)
    return params


def init_block(seed: int, cfg: ModelConfig, *names: str, lead=(), device="cuda") -> dict:
    """One block's parameters (a ``lead``-stacked one for a stack of
    blocks), drawn from the generators named ``names`` + "attn" / "mlp"."""
    dtype = dtype_of(cfg.param_dtype)
    return {
        "attn_norm": L.init_rmsnorm(cfg.d_model, dtype, lead=lead, device=device),
        "attn": L.init_attention(fold_seed(seed, *names, "attn", device=device), cfg,
                                 lead=lead, device=device),
        "mlp_norm": L.init_rmsnorm(cfg.d_model, dtype, lead=lead, device=device),
        "mlp": L.init_mlp(fold_seed(seed, *names, "mlp", device=device), cfg, lead=lead,
                          device=device),
    }


def params_from_reference(np_params: dict, device="cuda") -> dict:
    """The reference's parameter tree, with numpy arrays for leaves
    (``jax.tree.map(np.asarray, params)``), as the port's parameters: the
    same nesting, the L-leading layer stack and the same layouts."""
    return tree_from_numpy(np_params, device)


def _layers(stack: dict) -> list[dict]:
    """A stack of layers (every leaf leading with L) as one parameter dict
    per layer, made of views by one ``torch.unbind`` per leaf. Its backward
    stacks the L layers' gradients in one copy, where indexing layer by layer
    would add a zero-filled copy of the whole stack for every layer."""
    per_leaf = [torch.unbind(t) for t in tree_leaves(stack)]
    return [tree_unflatten(stack, [views[i] for views in per_leaf])
            for i in range(len(per_leaf[0]))]


# ---------------------------------------------------------------------------
# One transformer block
# ---------------------------------------------------------------------------


def block_apply(
    params: dict,
    x: torch.Tensor,
    cfg: ModelConfig,
    *,
    positions: torch.Tensor,
    cache: Optional[dict] = None,
    cache_index: Optional[int] = None,
) -> tuple[torch.Tensor, Optional[dict]]:
    h, new_cache = L.attention_block(
        params["attn"],
        L.rmsnorm(params["attn_norm"], x, cfg.norm_eps),
        cfg,
        positions=positions,
        cache=cache,
        cache_index=cache_index,
    )
    x = x + h
    x = x + L.mlp_block(params["mlp"], L.rmsnorm(params["mlp_norm"], x, cfg.norm_eps), cfg)
    return x, new_cache


# ---------------------------------------------------------------------------
# Whole model
# ---------------------------------------------------------------------------


def _embed_inputs(params: dict, batch: dict, cfg: ModelConfig, pc=None) -> torch.Tensor:
    cdt = dtype_of(cfg.compute_dtype)
    if cfg.frontend == "audio_frames":
        return batch["frames"].to(cdt) @ params["in_proj"].to(cdt)
    if cfg.frontend == "vision_patches":
        patches = batch["patches"].to(cdt) @ params["connector"].to(cdt)
        toks = L.embed(params["embed"], batch["tokens"], cfg, pc)
        return torch.cat([patches, toks], dim=1)
    return L.embed(params["embed"], batch["tokens"], cfg, pc)


def _check(pc) -> None:
    if pc is not None:
        raise NotImplementedError("a ParallelCtx (pc) comes with the port's parallel slice")


def forward(
    params: dict,
    batch: dict,
    cfg: ModelConfig,
    pc=None,
    *,
    remat: str = "none",
    return_cache: bool = False,
    kv_dtype=torch.bfloat16,
):
    """Train / prefill forward. Returns logits (B, S, V); with return_cache also
    returns a stacked (L-leading) KV cache holding the prefilled keys/values,
    each (L, B, KV, S, hd)."""
    _check(pc)
    x = _embed_inputs(params, batch, cfg, pc)
    b, s, _ = x.shape
    positions = torch.arange(s, dtype=torch.int32, device=x.device).expand(b, s)
    cdt = dtype_of(cfg.compute_dtype)
    kvh, hd = cfg.num_kv_heads, cfg.resolved_head_dim

    def body(lp, x):
        return block_apply(lp, x, cfg, positions=positions)[0]

    body = remat_wrap(body, remat)
    ks, vs = [], []
    for lp in _layers(params["layers"]):
        y = body(lp, x)
        if return_cache:
            # re-project k/v for the cache, as the reference does
            xin = L.rmsnorm(lp["attn_norm"], x, cfg.norm_eps).to(cdt)
            k = (xin @ lp["attn"]["wk"].to(cdt)).reshape(b, s, kvh, hd)
            v = (xin @ lp["attn"]["wv"].to(cdt)).reshape(b, s, kvh, hd)
            if cfg.use_qk_norm:
                k = L.rmsnorm(lp["attn"]["k_norm"], k, cfg.norm_eps)
            k = L.apply_rope(k, positions, cfg.rope_theta)
            ks.append(k.transpose(1, 2).to(kv_dtype))
            vs.append(v.transpose(1, 2).to(kv_dtype))
        x = y
    x = L.rmsnorm(params["final_norm"], x, cfg.norm_eps)
    logits = L.unembed(params["embed"], x, cfg)
    if return_cache:
        return logits, {"k": torch.stack(ks), "v": torch.stack(vs)}
    return logits


def init_cache(cfg: ModelConfig, batch: int, max_len: int, kv_dtype="bfloat16",
               device="cuda") -> dict:
    """A stacked (L-leading) cache of zeros."""
    return kvcache.init_cache(batch, cfg.num_kv_heads, max_len, cfg.resolved_head_dim,
                              kv_dtype, lead=(cfg.num_layers,), device=device)


def decode_step(
    params: dict,
    cache: dict,
    tokens: torch.Tensor,
    cache_index: int,
    cfg: ModelConfig,
    pc=None,
) -> tuple[torch.Tensor, dict]:
    """One decode step. tokens: (B, s), written at ``cache_index``. cache:
    stacked (L, ...) kv cache, updated in place. Returns (logits (B, s, V),
    cache)."""
    _check(pc)
    x = L.embed(params["embed"], tokens, cfg, pc)
    b, s, _ = x.shape
    positions = (cache_index + torch.arange(s, dtype=torch.int32, device=x.device)
                 ).expand(b, s)
    for i, lp in enumerate(_layers(params["layers"])):
        layer_cache = {name: t[i] for name, t in cache.items()}
        x, _ = block_apply(lp, x, cfg, positions=positions, cache=layer_cache,
                           cache_index=cache_index)
    x = L.rmsnorm(params["final_norm"], x, cfg.norm_eps)
    logits = L.unembed(params["embed"], x, cfg)
    return logits, cache
