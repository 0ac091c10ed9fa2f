"""Plain PyTorch versions of the port's kernels: the ground truth each
hand-written kernel is held against on the card, and what the wrappers run
for tensors that lie on the CPU. Counterpart of ``repro/kernels/ref.py``."""
from __future__ import annotations

import math
from typing import Optional

import torch
import torch.nn.functional as F


def ibn_pointwise_ref(x, w, b: Optional[torch.Tensor] = None,
                      act: str = "relu") -> torch.Tensor:
    """1x1 conv + bias + activation. x: (N, Cin), w: (Cin, Cout), b: (Cout,)
    or None for no bias. fp32 math, then a cast to ``x.dtype``."""
    y = x.float() @ w.float()
    if b is not None:
        y = y + b.float()
    if act == "relu":
        y = F.relu(y)
    elif act == "silu":
        y = F.silu(y)
    return y.to(x.dtype)


def flash_attention_ref(q, k, v, *, causal: bool = True) -> torch.Tensor:
    """q (B, H, Sq, hd), k/v (B, KV, Skv, hd) -> (B, H, Sq, hd) in q's
    dtype, GQA with H = KV·G. What the Pallas kernel computes, in one pass:
    fp32 scores scaled by 1/√hd after the product; under ``causal`` the mask
    ``k_pos <= q_pos`` aligned top-left, as the kernel and the model's
    attention align it (``repro``'s jnp oracle aligns it bottom-right,
    ROADMAP H2); an fp32 softmax whose numerator is rounded to v's dtype
    before the product with v and whose denominator is the fp32 sum."""
    b, h, sq, hd = q.shape
    kv, skv = k.shape[1], k.shape[2]
    g = h // kv
    qg = q.reshape(b, kv, g, sq, hd).float()
    s = torch.einsum("bkgsd,bktd->bkgst", qg, k.float()) * (1.0 / math.sqrt(hd))
    if causal:
        keep = torch.ones((sq, skv), dtype=torch.bool, device=q.device).tril()
        s = s.masked_fill(~keep, -1e30)
    p = torch.exp(s - s.amax(dim=-1, keepdim=True))
    denom = p.sum(dim=-1, keepdim=True).clamp_min(1e-30)
    out = torch.einsum("bkgst,bktd->bkgsd", p.to(v.dtype).float(), v.float()) / denom
    return out.reshape(b, h, sq, hd).to(q.dtype)
