"""Step factories for train / prefill / decode. Counterpart of
``repro/train/steps.py`` (``make_train_step``, ``make_prefill_step``,
``make_decode_step``) and the shape-only stand-ins (``input_specs``,
``abstract_params``, ``abstract_cache``); the sharded (``pc``) variants
come with the parallel slice.

As in the reference, with ``pc=None`` each factory returns the step and
``None`` for every sharding spec. The serve steps run without autograd.
"""
from __future__ import annotations

import torch

from repro_torch.common import tree_cast, tree_leaves, tree_map, tree_unflatten
from repro_torch.config import ModelConfig, RunConfig, ShapeConfig
from repro_torch.models import api
from repro_torch.train.optim import make_optimizer


def _no_pc(pc) -> None:
    if pc is not None:
        raise NotImplementedError("sharded steps (pc) come with the port's parallel slice")


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


def _loss_and_grads(params, batch: dict, run: RunConfig):
    """(loss, metrics, grads) of one batch: the gradient of ``api.loss_fn``
    with respect to every floating-point leaf of ``params``, in the leaf's
    type (zeros for a leaf the loss does not use). Nothing waits for the
    device: loss and metrics are detached 0-d tensors."""
    leaves = [t.detach().requires_grad_(True) if t.is_floating_point() else t
              for t in tree_leaves(params)]
    loss, metrics = api.loss_fn(tree_unflatten(params, leaves), batch, run.model,
                                remat=run.train.remat)
    wanted = [t for t in leaves if t.requires_grad]
    got = iter(torch.autograd.grad(loss, wanted, allow_unused=True))
    grads = []
    for t in leaves:
        g = next(got) if t.requires_grad else None
        grads.append(torch.zeros_like(t) if g is None else g)
    return (loss.detach(), {k: v.detach() for k, v in metrics.items()},
            tree_unflatten(params, grads))


def value_and_grad(params, batch: dict, run: RunConfig):
    """(loss, metrics, grads) of the training step before its optimizer
    update: over ``run.train.microbatches`` splits of the batch, the fp32
    mean of the splits' gradients (``gacc + g / k``, as the reference's scan
    accumulates) and the metrics ``loss``, ``ce`` (both the mean loss) and
    ``aux`` (0)."""
    k = run.train.microbatches
    if k == 1:
        return _loss_and_grads(params, batch, run)
    micro = {name: t.reshape((k, t.shape[0] // k) + t.shape[1:]) for name, t in batch.items()}
    gacc = tree_map(lambda p: torch.zeros(p.shape, dtype=torch.float32, device=p.device),
                    params)
    lacc = 0.0
    for i in range(k):
        loss, _, grads = _loss_and_grads(params, {n: t[i] for n, t in micro.items()}, run)
        for a, g in zip(tree_leaves(gacc), tree_leaves(grads)):
            a.add_(g.float() / k)
        lacc = lacc + loss / k
    zero = torch.zeros((), dtype=torch.float32, device=lacc.device)
    return lacc, {"loss": lacc, "ce": lacc, "aux": zero}, gacc


def make_train_step(run: RunConfig, pc=None):
    """Returns (train_step, None, None).

    train_step(state, batch) -> (state, metrics), state = {"params", "opt"};
    metrics are 0-d tensors on the state's device (nothing calls
    ``.item()``). The step updates the state in place and returns it: the
    state belongs to the step (see ``train.optim``). With
    ``cast_params_once`` the gradients are taken with respect to the
    ``compute_dtype`` tree, cast once before the microbatches, and only the
    optimizer touches the fp32 master copy.
    """
    _no_pc(pc)
    cfg, tcfg = run.model, run.train
    opt = make_optimizer(tcfg)

    def train_step(state, batch):
        master = state["params"]
        params = tree_cast(master, cfg.compute_dtype) if tcfg.cast_params_once else master
        _, metrics, grads = value_and_grad(params, batch, run)
        del params
        with torch.profiler.record_function("optimizer.step"):
            new_params, new_opt, opt_metrics = opt.step(master, grads, state["opt"])
        return {"params": new_params, "opt": new_opt}, dict(metrics, **opt_metrics)

    return train_step, None, None


# ---------------------------------------------------------------------------
# Prefill / decode steps
# ---------------------------------------------------------------------------


def make_prefill_step(run: RunConfig, pc=None):
    """prefill(params, batch) -> logits (B, S, V)."""
    _no_pc(pc)
    cfg = run.model

    @torch.no_grad()
    def prefill_step(params, batch):
        logits, _ = api.forward(params, batch, cfg, pc, remat="none")
        return logits

    return prefill_step, None, None


def make_decode_step(run: RunConfig, pc=None):
    """decode(params, cache, tokens, index) -> (next_token, logits, cache);
    the cache is updated in place."""
    _no_pc(pc)
    cfg = run.model

    @torch.no_grad()
    def decode_step(params, cache, tokens, index):
        logits, new_cache = api.decode_step(params, cache, tokens, index, cfg, pc)
        next_tok = logits[:, -1:].argmax(dim=-1).to(torch.int32)
        return next_tok, logits, new_cache

    return decode_step, None, None, None
