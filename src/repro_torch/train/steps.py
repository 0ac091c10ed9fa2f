"""Step factories for serving: prefill and decode. Counterpart of
``repro/train/steps.py`` (``make_prefill_step``, ``make_decode_step``); the
training steps and the sharded (``pc``) variants come with later slices.

As in the reference, with ``pc=None`` each factory returns the step and
``None`` for every sharding spec. The steps run without autograd.
"""
from __future__ import annotations

import torch

from repro_torch.config import RunConfig
from repro_torch.models import api


def _no_pc(pc) -> None:
    if pc is not None:
        raise NotImplementedError("sharded steps (pc) come with the port's parallel "
                                  "slice (ROADMAP Queue 1, item 9)")


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
