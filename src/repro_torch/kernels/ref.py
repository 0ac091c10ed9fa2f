"""Plain PyTorch versions of the port's kernels: the ground truth each
hand-written kernel is held against on the card, and what the wrappers run
for tensors that lie on the CPU. Counterpart of ``repro/kernels/ref.py``.
``vjp`` gives the gradient of a plain version by recomputing it."""
from __future__ import annotations

import math
from typing import Callable, Optional, Sequence

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


def ssd_scan_ref(x, dt, A, B, C, chunk: int):
    """The sequential (non-chunked) SSD recurrence, one step per position.
    x (B,S,H,P), dt (B,S,H), A (H,), B/C (B,S,G,N) with H a multiple of G.
    Returns (y (B,S,H,P) in x's dtype, final_state (B,H,P,N) fp32).
    ``chunk`` is unused: the recurrence has no chunks."""
    b, s, h, p = x.shape
    g, n = B.shape[2], B.shape[3]
    bg = B.repeat_interleave(h // g, dim=2).float()  # (B,S,H,N)
    cg = C.repeat_interleave(h // g, dim=2).float()
    dtf, xf, af = dt.float(), x.float(), A.float()
    state = torch.zeros((b, h, p, n), dtype=torch.float32, device=x.device)
    ys = []
    for i in range(s):
        da = torch.exp(dtf[:, i] * af)  # (B,H)
        xdt = xf[:, i] * dtf[:, i][..., None]  # (B,H,P)
        state = state * da[..., None, None] + torch.einsum("bhp,bhn->bhpn", xdt, bg[:, i])
        ys.append(torch.einsum("bhpn,bhn->bhp", state, cg[:, i]))
    return torch.stack(ys, dim=1).to(x.dtype), state


def segsum(x: torch.Tensor) -> torch.Tensor:
    """x (..., Q) -> (..., Q, Q) with out[i, j] = sum of x[j+1..i] for
    i >= j and -inf above the diagonal, so that exp() of it is the masked
    decay matrix with no overflow."""
    q = x.shape[-1]
    cs = torch.cumsum(x, dim=-1)
    diff = cs[..., :, None] - cs[..., None, :]
    mask = torch.ones((q, q), dtype=torch.bool, device=x.device).tril()
    return diff.masked_fill(~mask, -math.inf)


def ssd_chunked(x, dt, A, Bm, Cm, chunk: int) -> tuple[torch.Tensor, torch.Tensor]:
    """The Mamba2 SSD chunk scan as the model computes it: chunks of
    ``min(chunk, S)`` positions, the tail padded with zeros (dt = 0, so a
    padded step neither decays nor adds to the state), the dual quadratic
    form inside a chunk and a (B,H,P,N) fp32 state carried across chunks.
    Shapes as ``ssd_scan_ref``; returns (y in x's dtype, final state fp32).
    What the ssd_scan kernel computes."""
    b, s, h, p = x.shape
    g, n = Bm.shape[2], Bm.shape[3]
    hg = h // g
    q = min(chunk, s)
    pad = (-s) % q
    if pad:
        x = F.pad(x, (0, 0, 0, 0, 0, pad))
        dt = F.pad(dt, (0, 0, 0, pad))
        Bm = F.pad(Bm, (0, 0, 0, 0, 0, pad))
        Cm = F.pad(Cm, (0, 0, 0, 0, 0, pad))
    nc = (s + pad) // q
    af = A.float()
    state = torch.zeros((b, h, p, n), dtype=torch.float32, device=x.device)
    ys = []
    for c in range(nc):
        sl = slice(c * q, (c + 1) * q)
        x_c, dt_c = x[:, sl].float(), dt[:, sl].float()  # (B,Q,H,P) (B,Q,H)
        da = dt_c * af  # (B,Q,H) <= 0
        lmat = torch.exp(segsum(da.transpose(1, 2)))  # (B,H,Q,Q)
        xdt = x_c * dt_c[..., None]  # (B,Q,H,P)
        bg = Bm[:, sl].repeat_interleave(hg, dim=2).float()  # (B,Q,H,N)
        cg = Cm[:, sl].repeat_interleave(hg, dim=2).float()
        scores = torch.einsum("bihn,bjhn->bhij", cg, bg) * lmat
        y = torch.einsum("bhij,bjhp->bihp", scores, xdt)
        cs = torch.cumsum(da, dim=1)  # (B,Q,H)
        y = y + torch.einsum("bihn,bhpn->bihp", cg, state) * torch.exp(cs)[..., None]
        tot = cs[:, -1, :]  # (B,H)
        decay_out = torch.exp(tot[:, None, :] - cs)  # (B,Q,H)
        state = state * torch.exp(tot)[..., None, None] + torch.einsum(
            "bjhn,bjhp->bhpn", bg * decay_out[..., None], xdt)
        ys.append(y)
    y = torch.cat(ys, dim=1)[:, :s]
    return y.to(x.dtype), state


def gmm_ref(x, w) -> torch.Tensor:
    """Grouped matmul y[e] = x[e] @ w[e]: x (E,C,D), w (E,D,F) -> (E,C,F).
    fp32 math, then a cast to ``x.dtype``."""
    return torch.bmm(x.float(), w.float()).to(x.dtype)


def vjp(fn: Callable, inputs: Sequence[torch.Tensor], needs_grad: Sequence[bool],
        grads_out: Sequence[Optional[torch.Tensor]]) -> tuple:
    """The VJP of ``fn`` at ``inputs``, recomputed under autograd: for each
    input that ``needs_grad`` marks, the gradient of ``fn``'s outputs
    against ``grads_out`` (``None`` for an output that has no gradient);
    ``None`` for the other inputs. What a kernel's ``backward`` returns where
    the TPU kernel had no VJP and the reference differentiates the plain
    jnp function instead."""
    with torch.enable_grad():
        leaves = [t.detach().requires_grad_(bool(need)) for t, need in zip(inputs, needs_grad)]
        outs = fn(*leaves)
        outs = (outs,) if isinstance(outs, torch.Tensor) else tuple(outs)
        pairs = [(o, g) for o, g in zip(outs, grads_out) if g is not None]
        wanted = [t for t in leaves if t.requires_grad]
        if not pairs or not wanted:
            return tuple(None for _ in inputs)
        got = iter(torch.autograd.grad([o for o, _ in pairs], wanted, [g for _, g in pairs],
                                       allow_unused=True))
    return tuple(next(got) if t.requires_grad else None for t in leaves)
