"""Plain layers of the reference, written from the published descriptions:
RMSNorm, RoPE (rotate-half), causal softmax attention, SwiGLU, the
depthwise causal convolution and the chunked SSD of Mamba2
(arXiv:2405.21060, its "minimal" listing). Float32 throughout; every
product goes through ``num`` (``numerics.Numerics``)."""
from __future__ import annotations

import math

import torch
import torch.nn.functional as F


def rmsnorm(x: torch.Tensor, scale: torch.Tensor, eps: float) -> torch.Tensor:
    return x * torch.rsqrt(x.square().mean(-1, keepdim=True) + eps) * scale


def rope(x: torch.Tensor, theta: float) -> torch.Tensor:
    """x (B, S, H, hd) at positions 0..S-1, the halves rotated."""
    s, hd = x.shape[1], x.shape[-1]
    freqs = 1.0 / theta ** (torch.arange(0, hd, 2, device=x.device, dtype=torch.float32) / hd)
    ang = torch.arange(s, device=x.device, dtype=torch.float32)[:, None] * freqs
    cos, sin = torch.cos(ang)[None, :, None], torch.sin(ang)[None, :, None]
    x1, x2 = x.chunk(2, dim=-1)
    return torch.cat([x1 * cos - x2 * sin, x2 * cos + x1 * sin], dim=-1)


def causal_attention(q, k, v, num) -> torch.Tensor:
    """q, k, v (B, S, H, hd), one kv head a query head -> (B, S, H, hd)."""
    s, hd = q.shape[1], q.shape[-1]
    scores = num.ein("bshd,bthd->bhst", q, k) / math.sqrt(hd)
    mask = torch.ones(s, s, dtype=torch.bool, device=q.device).tril()
    probs = torch.softmax(scores.masked_fill(~mask, float("-inf")), dim=-1)
    return num.ein("bhst,bthd->bshd", probs, v)


def swiglu(x, w_gate, w_up, w_down, num) -> torch.Tensor:
    return num.mm(F.silu(num.mm(x, w_gate)) * num.mm(x, w_up), w_down)


def causal_conv(x: torch.Tensor, w: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """Depthwise causal convolution: x (B, S, C), w (W, C), b (C,)."""
    width, s = w.shape[0], x.shape[1]
    pad = F.pad(x, (0, 0, width - 1, 0))
    return sum(pad[:, i:i + s] * w[i] for i in range(width)) + b


def segsum(x: torch.Tensor) -> torch.Tensor:
    """(..., T) -> (..., T, T): sum of x over (j, i] at [i, j], -inf above
    the diagonal."""
    t = x.shape[-1]
    cs = torch.cumsum(x, dim=-1)
    out = cs[..., :, None] - cs[..., None, :]
    mask = torch.ones(t, t, dtype=torch.bool, device=x.device).tril()
    return out.masked_fill(~mask, float("-inf"))


def ssd(x, dt, a, bm, cm, chunk: int, num) -> torch.Tensor:
    """The SSD scan from a zero state: x (B, S, H, P), dt (B, S, H),
    a (H,) negative, bm/cm (B, S, N) shared by every head (one group).
    y_t = sum_{s<=t} C_t . B_s exp(sum_{s<r<=t} dt_r a) dt_s x_s."""
    b, s, h, p = x.shape
    q = min(chunk, s)
    pad = (-s) % q
    if pad:  # zeros past the end change nothing before it
        x, dt = F.pad(x, (0, 0, 0, 0, 0, pad)), F.pad(dt, (0, 0, 0, pad))
        bm, cm = F.pad(bm, (0, 0, 0, pad)), F.pad(cm, (0, 0, 0, pad))
    c = (s + pad) // q
    xd = (x * dt[..., None]).reshape(b, c, q, h, p)
    da = (dt * a).reshape(b, c, q, h).permute(0, 3, 1, 2)  # (B, H, c, q)
    bm, cm = bm.reshape(b, c, q, -1), cm.reshape(b, c, q, -1)
    cum = torch.cumsum(da, dim=-1)
    # within a chunk
    decay = torch.exp(segsum(da))  # (B, H, c, q, q)
    cb = num.ein("bcln,bcsn->bcls", cm, bm)
    y = num.ein("bhcls,bcshp->bclhp", decay * cb[:, None], xd)
    # each chunk's state, then carried across chunks
    states = num.ein("bcln,bclhp->bchpn", bm, xd * torch.exp(cum[..., -1:] - cum)
                     .permute(0, 2, 3, 1)[..., None])
    states = torch.cat([torch.zeros_like(states[:, :1]), states], dim=1)
    carry = torch.exp(segsum(F.pad(cum[..., -1], (1, 0))))  # (B, H, c+1, c+1)
    states = num.ein("bhzc,bchpn->bzhpn", carry, states)[:, :-1]
    y = y + (num.ein("bcln,bchpn->bclhp", cm, states)
             * torch.exp(cum).permute(0, 2, 3, 1)[..., None])
    return y.reshape(b, c * q, h, p)[:, :s]
