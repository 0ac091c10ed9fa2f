"""Optimizers in plain PyTorch: AdamW, Adafactor (factored second moments —
the memory-frugal choice at 100B+ scale), RMSProp (the paper's proxy-task
optimizer) and SGD+momentum. Plus warmup+cosine LR schedule and global-norm
clipping. Counterpart of ``repro/train/optim.py``, with its API and state
keys:

    opt = make_optimizer(train_cfg)
    state = opt.init(params)
    params, state, metrics = opt.step(params, grads, state)

``step`` updates ``params`` and the state's tensors in place and returns
them (the state belongs to the step, as the reference launcher's
``donate_argnums=(0,)`` gives its state to the jitted step): at qwen3-1.7B's
2 B parameters, a functional update would hold a second copy of the 24 GB
of parameters and moments. Gradients are clipped in place where they are
fp32. Metrics and the step count stay 0-d tensors on the parameters'
device; nothing here waits for the device.

Numerics follow the reference: the step count, schedule and bias
corrections in float32; clipped gradients in fp32 whatever their own type
(jax promotes a bf16 gradient times the fp32 scale to fp32, torch would
keep bf16); weight decay on every leaf with ``ndim >= 2`` (a layer-stacked
``(L, d)`` leaf included); Adafactor factors a leaf whose last two dims are
both at least 128 and clips its update by one RMS over the whole leaf.
"""
from __future__ import annotations

import math
from typing import Callable, NamedTuple

import torch

from repro_torch.common import global_norm, tree_leaves, tree_map
from repro_torch.config import TrainConfig


class Optimizer(NamedTuple):
    init: Callable
    step: Callable


def lr_schedule(cfg: TrainConfig):
    """step (an integer tensor) -> the learning rate, a float32 tensor."""

    def f(step):
        step = step.float()
        warm = cfg.learning_rate * step / max(cfg.warmup_steps, 1)
        prog = (step - cfg.warmup_steps) / max(cfg.total_steps - cfg.warmup_steps, 1)
        prog = prog.clamp(0.0, 1.0)
        cos = cfg.learning_rate * 0.5 * (1.0 + torch.cos(math.pi * prog))
        return torch.where(step < cfg.warmup_steps, warm, cos)

    return f


def clip_by_global_norm(grads, max_norm: float):
    """(grads scaled to a global norm of at most ``max_norm``, in fp32, and
    the norm before clipping). An fp32 gradient is scaled in place."""
    norm = global_norm(grads)
    scale = torch.clamp(max_norm / torch.clamp(norm, min=1e-9), max=1.0)
    return tree_map(lambda g: g.float().mul_(scale), grads), norm


def _is_matrix(x) -> bool:
    return x.ndim >= 2 and x.shape[-1] >= 128 and x.shape[-2] >= 128


def _zeros_f32(p: torch.Tensor) -> torch.Tensor:
    """fp32 zeros shaped (and, for a DTensor, placed) as ``p``."""
    return torch.zeros_like(p, dtype=torch.float32, memory_format=torch.contiguous_format)


def _apply(p: torch.Tensor, delta: torch.Tensor) -> None:
    """p <- p - delta (delta fp32), rounded to p's type."""
    if p.dtype == torch.float32:
        p.sub_(delta)
    else:
        p.copy_(p.float() - delta)


def _step0(params) -> torch.Tensor:
    """The step count's start: an int32 0 on the parameters' device."""
    return torch.zeros((), dtype=torch.int32, device=tree_leaves(params)[0].device)


def _weight_decay(p: torch.Tensor, wd: float):
    return wd * p.float() if p.ndim >= 2 else 0.0


def make_optimizer(cfg: TrainConfig) -> Optimizer:
    sched = lr_schedule(cfg)

    def _start(params, grads, state):
        grads, gnorm = clip_by_global_norm(grads, cfg.grad_clip)
        t = state["step"] + 1
        return tree_leaves(grads), gnorm, t, sched(t)

    if cfg.optimizer == "adamw":

        def init(params):
            return {"step": _step0(params), "mu": tree_map(_zeros_f32, params),
                    "nu": tree_map(_zeros_f32, params)}

        def step(params, grads, state):
            grads, gnorm, t, lr = _start(params, grads, state)
            b1, b2 = cfg.beta1, cfg.beta2
            bc1 = 1 - b1 ** t.float()
            bc2 = 1 - b2 ** t.float()
            for p, g, m, v in zip(tree_leaves(params), grads, tree_leaves(state["mu"]),
                                  tree_leaves(state["nu"])):
                m.mul_(b1).add_(g, alpha=1 - b1)
                v.mul_(b2).addcmul_(g, g, value=1 - b2)
                u = (m / bc1).div_((v / bc2).sqrt_().add_(cfg.eps))
                if p.ndim >= 2:
                    u.add_(p.float(), alpha=cfg.weight_decay)
                _apply(p, u.mul_(lr))
            return params, {"step": t, "mu": state["mu"], "nu": state["nu"]}, {
                "grad_norm": gnorm, "lr": lr}

        return Optimizer(init, step)

    if cfg.optimizer == "adafactor":

        def init(params):
            def factored(p):
                if _is_matrix(p):
                    return {"vr": _zeros_f32(p[..., 0]), "vc": _zeros_f32(p[..., 0, :])}
                return {"v": _zeros_f32(p)}

            return {"step": _step0(params), "v": tree_map(factored, params)}

        def step(params, grads, state):
            grads, gnorm, t, lr = _start(params, grads, state)
            decay = 1.0 - t.float() ** -0.8
            for p, g, v in zip(tree_leaves(params), grads, _per_param(state["v"], params)):
                g2 = g.square() + 1e-30
                if "vr" in v:
                    v["vr"].copy_(decay * v["vr"] + (1 - decay) * g2.mean(dim=-1))
                    v["vc"].copy_(decay * v["vc"] + (1 - decay) * g2.mean(dim=-2))
                    r = v["vr"] / v["vr"].mean(dim=-1, keepdim=True)
                    u = g / (torch.sqrt(r[..., None]) * torch.sqrt(v["vc"][..., None, :]))
                else:
                    v["v"].copy_(decay * v["v"] + (1 - decay) * g2)
                    u = g / torch.sqrt(v["v"] + 1e-30)
                # update clipping (Adafactor's RMS-1 rule), one RMS per leaf
                rms = torch.sqrt(u.square().mean() + 1e-30)
                u = u / torch.clamp(rms, min=1.0)
                _apply(p, lr * (u + _weight_decay(p, cfg.weight_decay)))
            return params, {"step": t, "v": state["v"]}, {"grad_norm": gnorm, "lr": lr}

        return Optimizer(init, step)

    if cfg.optimizer == "rmsprop":

        def init(params):
            return {"step": _step0(params), "v": tree_map(_zeros_f32, params)}

        def step(params, grads, state):
            grads, gnorm, t, lr = _start(params, grads, state)
            for p, g, v in zip(tree_leaves(params), grads, tree_leaves(state["v"])):
                v.copy_(0.9 * v + 0.1 * g.square())
                _apply(p, lr * g / (torch.sqrt(v) + 1e-8))
            return params, {"step": t, "v": state["v"]}, {"grad_norm": gnorm, "lr": lr}

        return Optimizer(init, step)

    if cfg.optimizer == "sgd":

        def init(params):
            return {"step": _step0(params), "m": tree_map(_zeros_f32, params)}

        def step(params, grads, state):
            grads, gnorm, t, lr = _start(params, grads, state)
            for p, g, m in zip(tree_leaves(params), grads, tree_leaves(state["m"])):
                m.copy_(0.9 * m + g)
                _apply(p, lr * m)
            return params, {"step": t, "m": state["m"]}, {"grad_norm": gnorm, "lr": lr}

        return Optimizer(init, step)

    raise ValueError(f"unknown optimizer {cfg.optimizer}")


def _per_param(v_tree, params) -> list[dict]:
    """Adafactor's state as one {vr, vc} or {v} dict per parameter leaf, in
    ``tree_leaves(params)`` order (its dicts sit where the parameters'
    leaves sit)."""
    if isinstance(params, dict):
        return [d for k in params for d in _per_param(v_tree[k], params[k])]
    if isinstance(params, (list, tuple)):
        return [d for i, p in enumerate(params) for d in _per_param(v_tree[i], p)]
    return [v_tree]
