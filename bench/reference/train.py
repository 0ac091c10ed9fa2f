"""The reference's training steps: the mean token cross-entropy (plus the
configuration's auxiliary-loss weight times its auxiliary loss), its
gradient by autograd in float32, clipped to a global norm, and AdamW with
decoupled weight decay on every leaf of two or more dimensions as laid out
(layer stacks included) and a linear warm-up, as the traffic file states.
Microbatches are the run's: the loss is the mean of theirs. Rows of a
microbatch go in blocks where the model has no term across rows; every
block recomputes its layers in the backward (checkpoints), so that the
reference fits beside its optimizer state."""
from __future__ import annotations

import math

import torch

from bench import tree as T


def lr_at(opt: dict, t: int) -> float:
    lr, warm, total = opt["learning_rate"], opt["warmup_steps"], opt["total_steps"]
    if t < warm:
        return lr * t / max(warm, 1)
    prog = min(max((t - warm) / max(total - warm, 1), 0.0), 1.0)
    return lr * 0.5 * (1.0 + math.cos(math.pi * prog))


def nll_sum(model, params, h, labels, num, rows: int = 1) -> torch.Tensor:
    """Summed cross-entropy of the valid labels (>= 0), the head taken
    ``rows`` rows at a time."""
    total = h.new_zeros(())
    for r in range(0, h.shape[0], rows):
        logits = model.head(params, h[r:r + rows], num)
        lab = labels[r:r + rows].long()
        valid = lab >= 0
        gold = logits.gather(-1, lab.clamp_min(0)[..., None])[..., 0]
        total = total + ((torch.logsumexp(logits, -1) - gold) * valid).sum()
    return total


def run(model, conf: dict, paths: list, draw, batches: list, opt: dict, micro: int,
        rows_block: int, num, fault: str = "") -> dict:
    """Trains the weights ``draw(path)`` gives for each of ``paths``, in
    float32, on ``batches`` (dicts of tokens and labels on the device).
    Returns each step's loss, each slice's (``tree.slices``) clipped first
    gradient norm, and each slice's change after the last step, against the
    weights drawn again. ``fault="half_batch"`` leaves out the second half
    of every batch (a fault planted in the control)."""
    params = T.build((p, draw(p).float().requires_grad_(True)) for p in paths)
    flat = [t for _, t in T.leaves(params)]
    mu = [torch.zeros_like(t) for t in flat]
    nu = [torch.zeros_like(t) for t in flat]
    coef = conf.get("router_aux_loss_coef", 0.0)
    losses, grad_norms = [], None
    for step, batch in enumerate(batches, 1):
        toks, labs = batch["tokens"], batch["labels"]
        if fault == "half_batch":
            toks, labs = toks[: toks.shape[0] // 2], labs[: labs.shape[0] // 2]
        k = min(micro, toks.shape[0])
        per = toks.shape[0] // k
        loss = 0.0
        for i in range(k):
            mt, ml = toks[i * per:(i + 1) * per], labs[i * per:(i + 1) * per]
            count = (ml >= 0).sum().clamp_min(1)
            block = rows_block if model.ROWS_INDEPENDENT else per
            for r in range(0, per, block):
                h, aux = model.hidden(params, mt[r:r + block], conf, num, remat=True)
                part = nll_sum(model, params, h, ml[r:r + block], num) / count
                part = (part + coef * aux * (h.shape[0] / per)) / k
                part.backward()
                loss += float(part.detach())
        losses.append(loss)
        with torch.no_grad():
            grads = [t.grad if t.grad is not None else torch.zeros_like(t) for t in flat]
            norm = torch.sqrt(sum(g.square().sum() for g in grads))
            scale = torch.clamp(opt["grad_clip"] / torch.clamp(norm, min=1e-9), max=1.0)
            for g in grads:
                g.mul_(scale)
            if step == 1:
                grad_norms = _slice_norms(params, grads)
            lr = lr_at(opt, step)
            b1, b2 = opt["beta1"], opt["beta2"]
            for t, g, m, v in zip(flat, grads, mu, nu):
                m.mul_(b1).add_(g, alpha=1 - b1)
                v.mul_(b2).addcmul_(g, g, value=1 - b2)
                u = (m / (1 - b1 ** step)) / ((v / (1 - b2 ** step)).sqrt() + opt["eps"])
                if t.ndim >= 2:
                    u = u + opt["weight_decay"] * t
                t.sub_(lr * u)
                t.grad = None
    with torch.no_grad():
        for p, t in zip(paths, flat):
            t.sub_(draw(p).float())  # the change, leaf by leaf
        change = _slice_norms(params, flat)
    return {"loss": losses, "grad": grad_norms, "change": change}


def _slice_norms(params: dict, values: list) -> dict:
    shaped = T.build((p, v) for (p, _), v in zip(T.leaves(params), values))
    return {n: float(torch.linalg.vector_norm(t.float())) for n, t in T.slices(shaped)}
