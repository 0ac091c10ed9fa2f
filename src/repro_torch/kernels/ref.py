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


def flash_attention_bwd(q, k, v, o, do, *, causal: bool = True) -> tuple:
    """The gradient of ``flash_attention_ref`` written out, as the backward
    kernels compute it: (dq, dk, dv) in q's, k's and v's dtypes from q, k, v,
    the forward's output o and its cotangent do (each (B, heads, S, hd)).
    With the scores s (fp32, scaled, masked as the forward masks them), the
    rows' log-sum-exp and P = exp(s - lse): D = rowsum(do · o); dv = Pᵀ do
    with P rounded to v's dtype; dS = P (do vᵀ - D), rounded to q's dtype
    for dq = dS k / √hd and dk = dSᵀ q / √hd; GQA sums each kv head's G
    query heads."""
    b, h, sq, hd = q.shape
    kv, skv = k.shape[1], k.shape[2]
    g = h // kv
    scale = 1.0 / math.sqrt(hd)
    qg = q.reshape(b, kv, g, sq, hd).float()
    kf, vf = k.float(), v.float()
    s = torch.einsum("bkgsd,bktd->bkgst", qg, kf) * scale
    if causal:
        keep = torch.ones((sq, skv), dtype=torch.bool, device=q.device).tril()
        s = s.masked_fill(~keep, -1e30)
    p = torch.exp(s - torch.logsumexp(s, dim=-1, keepdim=True))
    dog = do.reshape(b, kv, g, sq, hd).float()
    dsum = (dog * o.reshape(b, kv, g, sq, hd).float()).sum(-1, keepdim=True)
    dv = torch.einsum("bkgst,bkgsd->bktd", p.to(v.dtype).float(), dog)
    dp = torch.einsum("bkgsd,bktd->bkgst", dog, vf)
    ds = (p * (dp - dsum)).to(q.dtype).float()
    dq = torch.einsum("bkgst,bktd->bkgsd", ds, kf) * scale
    dk = torch.einsum("bkgst,bkgsd->bktd", ds, qg) * scale
    return dq.reshape(b, h, sq, hd).to(q.dtype), dk.to(k.dtype), dv.to(v.dtype)


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


def ssd_chunked_bwd(x, dt, A, Bm, Cm, dy, dstate: Optional[torch.Tensor],
                    chunk: int) -> tuple:
    """The gradient of ``ssd_chunked`` written out, as the backward kernels
    compute it: (dx, ddt, dA, dB, dC) in the inputs' dtypes from the
    forward's inputs, y's cotangent ``dy`` and the final state's
    ``dstate`` (None for none). fp32 throughout, per chunk c (cs the chunk's
    cumsum of dt·A, tot its last entry, L the masked decay, xdt = x·dt):
    1. the chunks' own state terms, Sf = Σ_j xdt_jᵀ B_j e^(tot-cs_j) and
       Sb = Σ_i e^(cs_i) dy_iᵀ C_i;
    2. the states passed over the chunks: h_in(c+1) = e^tot h_in(c) + Sf(c)
       forwards from 0, dh_out(c-1) = e^tot dh_out(c) + Sb(c) backwards
       from ``dstate``;
    3. each chunk's gradients from h_in and dh_out: dxdt = ((C Bᵀ)∘L)ᵀ dy +
       u, u = e^(tot-cs) B dh_outᵀ; dC = ((dy xdtᵀ)∘L) B + e^cs dy h_in;
       dB = ((dy xdtᵀ)∘L)ᵀ C + e^(tot-cs) xdt dh_out; the cumsum's cotangent
       from L, e^cs and e^(tot-cs), summed in reverse into dt's and A's;
    4. B's and C's gradients summed over each group's heads; padded tail
       positions (dt = 0) add nothing."""
    b, s, h, p = x.shape
    g, n = Bm.shape[2], Bm.shape[3]
    hg = h // g
    q = min(chunk, s)
    pad = (-s) % q
    nc = (s + pad) // q

    def chunked(t, inner):  # (B, S, heads, *inner) fp32 -> (B, nc, Q, heads, *inner)
        t = t.float()
        if pad:
            t = F.pad(t, (0, 0) * inner + (0, 0, 0, pad))
        return t.reshape(b, nc, q, *t.shape[2:])

    xf, dyf, dtf = chunked(x, 1), chunked(dy, 1), chunked(dt, 0)
    bg = chunked(Bm.repeat_interleave(hg, dim=2), 1)
    cg = chunked(Cm.repeat_interleave(hg, dim=2), 1)
    af = A.float()
    da = dtf * af  # (B, nc, Q, H)
    cs = torch.cumsum(da, dim=2)
    tot = cs[:, :, -1]  # (B, nc, H)
    ecs, eout = torch.exp(cs), torch.exp(tot[:, :, None] - cs)
    lmat = torch.exp(segsum(da.transpose(2, 3)))  # (B, nc, H, Q, Q)
    xdt = xf * dtf[..., None]
    # 1-2: the states each chunk starts from and its final state's cotangent
    sf = torch.einsum("bcjhn,bcjhp->bchpn", bg * eout[..., None], xdt)
    sb = torch.einsum("bcihp,bcihn->bchpn", dyf * ecs[..., None], cg)
    etot = torch.exp(tot)[..., None, None]
    h_in, state = [], torch.zeros((b, h, p, n), dtype=torch.float32, device=x.device)
    for c in range(nc):
        h_in.append(state)
        state = state * etot[:, c] + sf[:, c]
    dh_out = [None] * nc
    carry = (dstate.float() if dstate is not None
             else torch.zeros((b, h, p, n), dtype=torch.float32, device=x.device))
    for c in reversed(range(nc)):
        dh_out[c] = carry
        carry = carry * etot[:, c] + sb[:, c]
    hin, dhout = torch.stack(h_in, 1), torch.stack(dh_out, 1)  # (B, nc, H, P, N)
    # 3: each chunk's gradients
    scores = torch.einsum("bcihn,bcjhn->bchij", cg, bg) * lmat
    dsc = torch.einsum("bcihp,bcjhp->bchij", dyf, xdt)
    u = torch.einsum("bcjhn,bchpn->bcjhp", bg, dhout) * eout[..., None]
    dxdt = torch.einsum("bchij,bcihp->bcjhp", scores, dyf) + u
    dsl = dsc * lmat
    dC = (torch.einsum("bchij,bcjhn->bcihn", dsl, bg)
          + torch.einsum("bcihp,bchpn->bcihn", dyf, hin) * ecs[..., None])
    dB = (torch.einsum("bchij,bcihn->bcjhn", dsl, cg)
          + torch.einsum("bcjhp,bchpn->bcjhn", xdt, dhout) * eout[..., None])
    ystate = torch.einsum("bcihn,bchpn->bcihp", cg, hin) * ecs[..., None]
    m = dsc * scores
    w = (xdt * u).sum(-1)  # (B, nc, Q, H)
    dcs = (m.sum(-1) - m.sum(-2)).transpose(2, 3) + (dyf * ystate).sum(-1) - w
    dtot = torch.exp(tot) * (hin * dhout).sum((-2, -1)) + w.sum(2)  # (B, nc, H)
    dda = torch.flip(torch.cumsum(torch.flip(dcs, (2,)), 2), (2,)) + dtot[:, :, None]
    ddt = dda * af + (dxdt * xf).sum(-1)
    dA = (dda * dtf).sum((0, 1, 2))
    dx = dxdt * dtf[..., None]

    def unchunked(t):
        return t.reshape(b, nc * q, *t.shape[3:])[:, :s]

    dB = unchunked(dB).reshape(b, s, g, hg, n).sum(3)
    dC = unchunked(dC).reshape(b, s, g, hg, n).sum(3)
    return (unchunked(dx).to(x.dtype), unchunked(ddt).to(dt.dtype), dA.to(A.dtype),
            dB.to(Bm.dtype), dC.to(Cm.dtype))


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
