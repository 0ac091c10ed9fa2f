"""Step factories for train / prefill / decode. Counterpart of
``repro/train/steps.py`` (``make_train_step``, ``make_prefill_step``,
``make_decode_step``) and the shape-only stand-ins (``input_specs``,
``abstract_params``, ``abstract_cache``).

As in the reference, with ``pc=None`` each factory returns the step and
``None`` for every sharding spec; with a ``ParallelCtx`` it returns the
reference's spec trees (``P``s), by which the caller places the state,
batch and cache (``parallel.sharding.distribute_tree``), and the step
takes DTensors. The serve steps run without autograd.
"""
from __future__ import annotations

import torch
from torch.distributed.tensor import DTensor

from repro_torch.common import tree_cast, tree_leaves, tree_map, tree_unflatten
from repro_torch.config import ModelConfig, RunConfig, ShapeConfig
from repro_torch.models import api
from repro_torch.parallel import sharding
from repro_torch.parallel.ctx import P
from repro_torch.train.optim import make_optimizer


# ---------------------------------------------------------------------------
# Shape-only stand-ins (meta tensors: nothing is allocated or drawn)
# ---------------------------------------------------------------------------


def input_specs(cfg: ModelConfig, shape: ShapeConfig) -> dict:
    """Meta tensors standing in for every model input of this cell, with the
    reference's shapes and dtypes: float32 frames and patches, int32 tokens
    and labels."""
    b, s = shape.global_batch, shape.seq_len

    def spec(dims, dtype=torch.int32):
        return torch.empty(dims, dtype=dtype, device="meta")

    if shape.mode == "decode":  # one new token against a seq_len cache
        return {"tokens": spec((b, 1))}
    if cfg.family == "audio":
        out = {"frames": spec((b, s, cfg.frontend_dim), torch.float32)}
    elif cfg.family == "vlm":
        p = cfg.num_patches
        out = {"patches": spec((b, p, cfg.frontend_dim), torch.float32),
               "tokens": spec((b, s - p))}
    else:
        out = {"tokens": spec((b, s))}
    if shape.mode == "train":
        out["labels"] = spec((b, s))
    return out


def abstract_params(cfg: ModelConfig):
    """The parameter tree as meta tensors: ``api.init`` on the meta device."""
    return api.init(0, cfg, device="meta")


def abstract_cache(cfg: ModelConfig, shape: ShapeConfig, kv_dtype: str):
    """The decode cache as meta tensors: ``api.init_cache`` on the meta
    device."""
    return api.init_cache(cfg, shape.global_batch, shape.seq_len, kv_dtype, device="meta")


# ---------------------------------------------------------------------------
# Train step
# ---------------------------------------------------------------------------


def _loss_and_grads(params, batch: dict, run: RunConfig, pc=None):
    """(loss, metrics, grads) of one batch: the gradient of ``api.loss_fn``
    with respect to every floating-point leaf of ``params``, in the leaf's
    type (zeros for a leaf the loss does not use). Nothing waits for the
    device: loss and metrics are detached 0-d tensors."""
    leaves = [t.detach().requires_grad_(True) if t.is_floating_point() else t
              for t in tree_leaves(params)]
    loss, metrics = api.loss_fn(tree_unflatten(params, leaves), batch, run.model, pc,
                                remat=run.train.remat)
    wanted = [t for t in leaves if t.requires_grad]
    got = iter(torch.autograd.grad(loss, wanted, allow_unused=True))
    grads = []
    for t in leaves:
        g = next(got) if t.requires_grad else None
        if g is None:
            g = torch.zeros_like(t)
        elif isinstance(g, DTensor):  # onto the parameter's own placements
            g = g.redistribute(t.device_mesh, t.placements)
        grads.append(g)
    return (loss.detach(), {k: v.detach() for k, v in metrics.items()},
            tree_unflatten(params, grads))


def value_and_grad(params, batch: dict, run: RunConfig, pc=None):
    """(loss, metrics, grads) of the training step before its optimizer
    update: over ``run.train.microbatches`` splits of the batch, the fp32
    mean of the splits' gradients (``gacc + g / k``, as the reference's scan
    accumulates) and the metrics ``loss``, ``ce`` (both the mean loss) and
    ``aux`` (0). With a ParallelCtx each split is the reference's (a
    contiguous block of rows of the whole batch), sharded anew by the
    model's first constraint."""
    k = run.train.microbatches
    if k == 1:
        return _loss_and_grads(params, batch, run, pc)
    if pc is not None:
        batch = {n: t.full_tensor() if isinstance(t, DTensor) else t for n, t in batch.items()}
    micro = {name: t.reshape((k, t.shape[0] // k) + t.shape[1:]) for name, t in batch.items()}
    gacc = tree_map(lambda p: torch.zeros_like(p, dtype=torch.float32), params)
    lacc = 0.0
    for i in range(k):
        loss, _, grads = _loss_and_grads(params, {n: t[i] for n, t in micro.items()}, run,
                                         pc)
        for a, g in zip(tree_leaves(gacc), tree_leaves(grads)):
            a.add_(g.float() / k)
        lacc = lacc + loss / k
    zero = torch.zeros_like(lacc)
    return lacc, {"loss": lacc, "ce": lacc, "aux": zero}, gacc


def make_train_step(run: RunConfig, pc=None):
    """Returns (train_step, state_specs, batch_specs): ``None`` specs
    without a ParallelCtx.

    train_step(state, batch) -> (state, metrics), state = {"params", "opt"};
    metrics are 0-d tensors on the state's device (nothing calls
    ``.item()``). The step updates the state in place and returns it: the
    state belongs to the step (see ``train.optim``). With
    ``cast_params_once`` the gradients are taken with respect to the
    ``compute_dtype`` tree, cast once before the microbatches, and only the
    optimizer touches the fp32 master copy.

    With a ParallelCtx the state is DTensors placed by ``state_specs`` and
    the batch DTensors placed by ``batch_specs`` (or plain tensors, taken
    as the whole batch on every rank). Each gradient is redistributed onto
    its parameter's placements (DTensor leaves a sum pending over the
    ranks that split the work), the clip's global norm is reduced over
    every shard, the optimizer updates each shard in place, and the
    metrics come back as plain 0-d tensors, the same on every rank.
    """
    cfg, tcfg = run.model, run.train
    opt = make_optimizer(tcfg)

    def train_step(state, batch):
        master = state["params"]
        params = tree_cast(master, cfg.compute_dtype) if tcfg.cast_params_once else master
        _, metrics, grads = value_and_grad(params, batch, run, pc)
        del params
        with torch.profiler.record_function("optimizer.step"):
            new_params, new_opt, opt_metrics = opt.step(master, grads, state["opt"])
        metrics = dict(metrics, **opt_metrics)
        if pc is not None:
            metrics = {k: v.full_tensor() if isinstance(v, DTensor) else v
                       for k, v in metrics.items()}
        return {"params": new_params, "opt": new_opt}, metrics

    if pc is None:
        return train_step, None, None
    aparams = abstract_params(cfg)
    pspecs = sharding.param_specs(aparams, cfg, pc, run.mesh)
    ospecs = _opt_specs(opt.init(aparams), pspecs)
    bspecs = sharding.batch_specs(input_specs(cfg, run.shape), pc)
    return train_step, {"params": pspecs, "opt": ospecs}, bspecs


def _opt_specs(aopt, pspecs):
    """Optimizer-state specs mirror the param specs; scalars and factored
    Adafactor vectors are replicated."""

    def build(sub):
        if isinstance(sub, dict) and set(sub) >= {"step"}:
            out = {}
            for key, val in sub.items():
                if key == "step":
                    out[key] = P()
                else:
                    out[key] = _match_tree(val, pspecs)
            return out
        return None

    return build(aopt)


def _match_tree(opt_branch, pspecs):
    """Map opt-state leaves to the corresponding param spec (same structure),
    replicating any leaf whose shape no longer matches (factored stats)."""

    def go(o, s):
        if isinstance(o, dict) and not hasattr(o, "shape"):
            if isinstance(s, dict):
                # same structural level
                if set(o) <= set(s):
                    return {k2: go(v2, s[k2]) for k2, v2 in o.items()}
            # factored adafactor node {vr, vc} / {v} under a param leaf spec
            return {k2: _spec_for_factored(v2, s) for k2, v2 in o.items()}
        if isinstance(o, (list, tuple)):
            return type(o)(go(v2, s2) for v2, s2 in zip(o, s))
        return s  # leaf: same shape as param -> same spec

    return go(opt_branch, pspecs)


def _spec_for_factored(leaf, param_spec: P):
    """vr drops the last dim, vc drops the second-to-last; v keeps the spec."""
    if not hasattr(leaf, "shape"):
        return P()
    nspec = len(param_spec)
    if leaf.ndim == nspec:
        return param_spec
    return P(*([None] * leaf.ndim))


# ---------------------------------------------------------------------------
# Prefill / decode steps
# ---------------------------------------------------------------------------


def make_prefill_step(run: RunConfig, pc=None):
    """prefill(params, batch) -> logits (B, S, V). Returns (prefill_step,
    param_specs, batch_specs)."""
    cfg = run.model

    @torch.no_grad()
    def prefill_step(params, batch):
        logits, _ = api.forward(params, batch, cfg, pc, remat="none")
        return logits

    if pc is None:
        return prefill_step, None, None
    pspecs = sharding.param_specs(abstract_params(cfg), cfg, pc, run.mesh)
    bspecs = sharding.batch_specs(input_specs(cfg, run.shape), pc)
    return prefill_step, pspecs, bspecs


def make_decode_step(run: RunConfig, pc=None):
    """decode(params, cache, tokens, index) -> (next_token, logits, cache);
    the cache is updated in place. Returns (decode_step, param_specs,
    cache_specs, batch_specs); with a ParallelCtx the next token comes back
    as a plain tensor, the same on every rank."""
    cfg = run.model

    @torch.no_grad()
    def decode_step(params, cache, tokens, index):
        logits, new_cache = api.decode_step(params, cache, tokens, index, cfg, pc)
        last = logits[:, -1:]
        if pc is not None:
            last = last.full_tensor()
        next_tok = last.argmax(dim=-1).to(torch.int32)
        return next_tok, logits, new_cache

    if pc is None:
        return decode_step, None, None, None
    pspecs = sharding.param_specs(abstract_params(cfg), cfg, pc, run.mesh)
    acache = abstract_cache(cfg, run.shape, run.serve.kv_dtype)
    cspecs = sharding.cache_specs(acache, cfg, pc, run.serve.shard_cache_seq)
    bspecs = sharding.batch_specs(
        {"tokens": torch.empty((run.shape.global_batch, 1), dtype=torch.int32,
                               device="meta")}, pc)
    return decode_step, pspecs, cspecs, bspecs
