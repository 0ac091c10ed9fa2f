"""Oneshot NAHAS: joint search with weight sharing (paper Sec. 3.5.2).

A single super-network carries the union of all NAS options; each step samples
one sub-network (single-path one-shot), trains the shared weights on the proxy
task, and lets a REINFORCE controller (TuNAS-style: absolute reward, warmup,
momentum-0.95 baseline) optimize the NAS *and* HAS decision points together.
Hardware latency/area inside the loop comes from the trained MLP cost model
(querying the simulator directly "becomes the new bottleneck for NAHAS oneshot
search" — Sec. 3.5.2), falling back to the simulator when no cost model is
supplied.

Weight sharing implementation (masked superkernels, static shapes):
  * kernel size  — a 7×7 kernel masked down to the sampled 5×5 / 3×3 ring
  * expansion    — max-expansion channels, channel-masked to the sampled ratio
  * op type      — IBN and Fused-IBN branches share the block; both are
                   computed and the sampled one is selected elementwise

Per the paper's own finding, oneshot targets the *small-model* regime: it
shares kernel/expansion/op decisions and leaves filter-multiplier/groups to
the multi-trial path ("constructing a super-network … impractically too
expensive when the search space is larger").

Counterpart of ``repro/core/oneshot.py``. ``oneshot_space`` and
``_vec_to_arrays`` are copies. The supernet is torch on ``device`` (the card
unless the caller asks for the CPU): every 1×1 convolution (expand, project,
head) goes through ``convnets._pointwise``, the ``ibn_pointwise`` kernel on
the card, forward and backward; the 7×7 fused and depthwise convolutions
are ``F.conv2d``. ``supernet_forward`` keeps the reference's work: both
branches of every block are computed, and ``torch.where`` selects one as
``jnp.where`` does, so the unselected branch also gets its (zero)
backward. ``init_supernet`` draws the reference's shapes and
distributions from one named generator per layer group;
``params_from_reference`` converts the reference's parameters.
"""
from __future__ import annotations

import dataclasses
import functools
from dataclasses import replace
from typing import Optional

import numpy as np
import torch

from repro_torch.common import fold_seed, tree_leaves, tree_unflatten
from repro_torch.core import has as has_lib
from repro_torch.core import simulator
from repro_torch.core.controllers import ReinforceConfig, ReinforceController
from repro_torch.core.reward import RewardConfig, reward as reward_fn
from repro_torch.core.space import Choice, Space, concat
from repro_torch.data.synthetic import VisionStream
from repro_torch.models import convnets as C


# ---------------------------------------------------------------------------
# Oneshot decision space (kernel / expansion / op per block)
# ---------------------------------------------------------------------------


def oneshot_space(base: C.ConvNetSpec) -> Space:
    choices = []
    for i, _ in enumerate(base.blocks):
        choices.append(Choice(f"b{i}_kernel", (3, 5, 7)))
        if i > 0:
            choices.append(Choice(f"b{i}_exp", (3, 6)))
        choices.append(Choice(f"b{i}_op", ("ibn", "fused")))

    def decode(d):
        blocks = []
        for i, b in enumerate(base.blocks):
            blocks.append(replace(
                b, kernel=d[f"b{i}_kernel"],
                expansion=d.get(f"b{i}_exp", 1 if i == 0 else b.expansion),
                op=d[f"b{i}_op"],
            ))
        return replace(base, blocks=tuple(blocks))

    return Space(choices, decode, "oneshot")


# ---------------------------------------------------------------------------
# Supernet
# ---------------------------------------------------------------------------

_MAX_K = 7
_MAX_EXP = 6


def init_supernet(seed: int, base: C.ConvNetSpec, device="cuda") -> dict:
    """Fresh fp32 supernet parameters from ``seed``: the reference's shapes
    and init distributions, one named generator per layer group."""
    dtype = torch.float32
    params = {
        "stem_w": C._conv_init(fold_seed(seed, "stem"), 3, 3, 3, base.stem_filters,
                               dtype, device),
        "stem_gn": C._gn_init(base.stem_filters, dtype, device),
        "blocks": [],
    }
    cin = base.stem_filters
    for i, b in enumerate(base.blocks):
        mid = cin * _MAX_EXP
        gen = fold_seed(seed, f"block{i}")
        params["blocks"].append({
            "expand_w": C._conv_init(gen, 1, 1, cin, mid, dtype, device),
            "expand_gn": C._gn_init(mid, dtype, device),
            "dw_w": C._conv_init(gen, _MAX_K, _MAX_K, 1, mid, dtype, device),
            "dw_gn": C._gn_init(mid, dtype, device),
            "fused_w": C._conv_init(gen, _MAX_K, _MAX_K, cin, mid, dtype, device),
            "fused_gn": C._gn_init(mid, dtype, device),
            "project_w": C._conv_init(gen, 1, 1, mid, b.filters, dtype, device),
            "project_gn": C._gn_init(b.filters, dtype, device),
        })
        cin = b.filters
    params["head_w"] = C._conv_init(fold_seed(seed, "head"), 1, 1, cin,
                                    base.head_filters, dtype, device)
    params["head_gn"] = C._gn_init(base.head_filters, dtype, device)
    params["classifier"] = (
        torch.randn((base.head_filters, base.num_classes),
                    generator=fold_seed(seed, "cls")) * 0.01
    ).to(device)
    return params


# the reference's supernet parameters as the port's: the same nesting and
# HWIO layouts as the convnets' trees
params_from_reference = C.params_from_reference


@functools.lru_cache(maxsize=64)
def _kernel_mask(k_sel: int, device: torch.device) -> torch.Tensor:
    """(7, 7, 1, 1) mask selecting the centered k×k window of the sampled k."""
    r = torch.abs(torch.arange(_MAX_K) - _MAX_K // 2)
    ring = torch.maximum(r[:, None], r[None, :])  # 0..3
    return (ring <= (k_sel - 1) // 2).float()[:, :, None, None].to(device)


@functools.lru_cache(maxsize=256)
def _channel_mask(mid: int, width: int, device: torch.device) -> torch.Tensor:
    """(mid,) mask of the first ``width`` channels."""
    return (torch.arange(mid) < width).float().to(device)


def supernet_forward(
    params: dict,
    images: torch.Tensor,
    base: C.ConvNetSpec,
    ks,     # (n_blocks,) sampled kernel sizes
    exps,   # (n_blocks,) sampled expansions (block 0 value ignored)
    ops,    # (n_blocks,) 0 = ibn, 1 = fused
) -> torch.Tensor:
    """images (B, H, W, 3) -> logits (B, num_classes). ``ks``, ``exps`` and
    ``ops`` are host integer sequences (``_vec_to_arrays``)."""
    dev = images.device
    fused = torch.as_tensor(np.asarray(ops) == 1, device=dev)
    x = C._act(C._gn(params["stem_gn"], C._conv(images, params["stem_w"], 2)), "relu")
    cin = base.stem_filters
    for i, b in enumerate(base.blocks):
        p = params["blocks"][i]
        mid = cin * _MAX_EXP
        exp_i = 1 if i == 0 else int(exps[i])
        ch_mask = _channel_mask(mid, cin * exp_i, dev)
        kmask = _kernel_mask(int(ks[i]), dev)
        # IBN branch
        hi = C._act(C._gn(p["expand_gn"], C._pointwise(x, p["expand_w"])), b.act)
        hi = hi * ch_mask
        hi = C._act(C._gn(p["dw_gn"],
                          C._depthwise(hi, p["dw_w"] * kmask, b.stride)), b.act)
        # Fused branch
        hf = C._act(C._gn(p["fused_gn"],
                          C._conv(x, p["fused_w"] * kmask, b.stride)), b.act)
        h = torch.where(fused[i], hf, hi) * ch_mask
        h = C._gn(p["project_gn"], C._pointwise(h, p["project_w"]))
        if b.stride == 1 and cin == b.filters:
            h = h + x
        x = h
        cin = b.filters
    x = C._act(C._gn(params["head_gn"], C._pointwise(x, params["head_w"])), "relu")
    x = x.mean(dim=(1, 2))
    return x @ params["classifier"]


def loss_fn(params: dict, images, labels, base: C.ConvNetSpec, ks, exps, ops):
    """Mean softmax cross-entropy of the sampled sub-network's logits."""
    logits = supernet_forward(params, images, base, ks, exps, ops)
    logz = torch.logsumexp(logits, dim=-1)
    gold = torch.gather(logits, 1, labels[:, None])[:, 0]
    return torch.mean(logz - gold)


def loss_and_grads(params: dict, images, labels, base: C.ConvNetSpec, ks, exps, ops):
    """The sampled sub-network's loss and its gradient with respect to every
    shared weight, as a tree like ``params`` (zeros where the draw does not
    reach)."""
    leaves = [p.detach().requires_grad_(True) for p in tree_leaves(params)]
    with torch.enable_grad():
        loss = loss_fn(tree_unflatten(params, leaves), images, labels, base, ks, exps, ops)
        grads = torch.autograd.grad(loss, leaves)
    return loss.detach(), tree_unflatten(params, list(grads))


def train_step(params: dict, images, labels, base: C.ConvNetSpec, ks, exps, ops,
               lr: float):
    """One plain SGD step of the shared weights on the sampled sub-network:
    returns (new params, loss before the step)."""
    loss, grads = loss_and_grads(params, images, labels, base, ks, exps, ops)
    new = [(p - lr * g).detach() for p, g in zip(tree_leaves(params), tree_leaves(grads))]
    return tree_unflatten(params, new), loss


# ---------------------------------------------------------------------------
# The oneshot search loop
# ---------------------------------------------------------------------------


@dataclasses.dataclass
class OneshotConfig:
    steps: int = 400
    warmup_frac: float = 0.25  # weights-only warmup (TuNAS)
    batch: int = 64
    lr: float = 0.05
    image_size: int = 32
    num_classes: int = 10
    seed: int = 0
    controller_every: int = 1
    device: str = "cuda"


def _vec_to_arrays(space: Space, base: C.ConvNetSpec, vec: np.ndarray):
    d = space.to_dict(vec)
    n = len(base.blocks)
    ks = np.array([d[f"b{i}_kernel"] for i in range(n)], np.int32)
    exps = np.array(
        [d.get(f"b{i}_exp", 1 if i == 0 else 6) for i in range(n)], np.int32)
    ops = np.array(
        [1 if d[f"b{i}_op"] == "fused" else 0 for i in range(n)], np.int32)
    return ks, exps, ops


def oneshot_search(
    base: C.ConvNetSpec,
    rcfg: RewardConfig,
    cfg: OneshotConfig = OneshotConfig(),
    cost_model=None,
    has_space: Optional[Space] = None,
) -> dict:
    base = replace(base, image_size=cfg.image_size, num_classes=cfg.num_classes)
    nas_space = oneshot_space(base)
    has_space = has_space or has_lib.has_space()
    joint = concat(nas_space, has_space)
    ctrl = ReinforceController(joint, ReinforceConfig(), seed=cfg.seed, device=cfg.device)
    rng_np = np.random.default_rng(cfg.seed)

    params = init_supernet(cfg.seed, base, device=cfg.device)
    stream = VisionStream(image_size=cfg.image_size,
                          num_classes=cfg.num_classes, batch=cfg.batch,
                          seed=cfg.seed)

    def on_device(b):
        return (torch.from_numpy(b["images"]).to(cfg.device),
                torch.from_numpy(b["labels"]).long().to(cfg.device))

    def val_acc(p, images, labels, ks, exps, ops):
        with torch.no_grad():
            logits = supernet_forward(p, images, base, ks, exps, ops)
            return float(torch.mean((torch.argmax(logits, -1) == labels).float()))

    def hw_metrics(av, hv):
        spec = nas_space.decode(av)
        h = has_space.decode(hv)
        if cost_model is not None:
            feats = np.concatenate([nas_space.features(av),
                                    has_space.features(hv)])[None]
            lat, area = cost_model.predict(feats)
            return float(lat[0]), float(area[0]), spec, h
        sim = simulator.simulate_safe(spec, h)
        if sim is None:
            return None, None, spec, h
        return sim["latency_ms"], sim["area_mm2"], spec, h

    history = []
    warmup = int(cfg.steps * cfg.warmup_frac)
    for step in range(cfg.steps):
        vec = (joint.sample(rng_np) if step < warmup
               else ctrl.sample(1)[0])
        av, hv = vec[: nas_space.num_decisions], vec[nas_space.num_decisions:]
        ks, exps, ops = _vec_to_arrays(nas_space, base, av)
        params, loss = train_step(params, *on_device(stream.batch_at(step)), base,
                                  ks, exps, ops, cfg.lr)
        if step >= warmup and step % cfg.controller_every == 0:
            acc = val_acc(params, *on_device(stream.batch_at(50_000 + step)), ks, exps, ops)
            lat, area, spec, h = hw_metrics(av, hv)
            r = reward_fn(acc, lat, area, rcfg)
            ctrl.update(vec[None], np.array([r]))
            history.append({
                "step": step, "loss": float(loss), "accuracy": acc,
                "latency_ms": lat, "area_mm2": area, "reward": float(r),
                "valid": lat is not None,
            })
    best_vec = ctrl.best()
    av, hv = best_vec[: nas_space.num_decisions], best_vec[nas_space.num_decisions:]
    return {
        "best_arch": nas_space.decode(av),
        "best_hw": has_space.decode(hv),
        "best_vec": best_vec,
        "history": history,
        "supernet_params": params,
        "nas_space": nas_space,
        "has_space": has_space,
    }
