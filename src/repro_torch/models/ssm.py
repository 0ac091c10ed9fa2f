"""Mamba2 (SSD, state-space duality) blocks and the pure-SSM LM.
Counterpart of ``repro/models/ssm.py``.

The prefill/train path sends its chunk scan through ``ops.ssd_scan``: on
the card the ssd_scan kernel, on the CPU its plain version
(``kernels.ref.ssd_chunked``, the reference's chunked algorithm). Decode
runs the one-token recurrence ``ssd_decode`` in torch, as the reference
does. Layers are one L-leading stack, looped over in Python; the decode
cache is a stacked (L-leading) dict updated in place. A ``ParallelCtx``
(``pc``) raises, as in ``models.transformer``.
"""
from __future__ import annotations

import math
from typing import Optional

import torch
import torch.nn.functional as F

from repro_torch.common import dtype_of, fold_seed
from repro_torch.config import ModelConfig
from repro_torch.kernels import ops as kops
from repro_torch.models import layers as L
from repro_torch.models import transformer as T

# ---------------------------------------------------------------------------
# SSD decode (one token; the chunked scan is ops.ssd_scan)
# ---------------------------------------------------------------------------


def ssd_decode(x, dt, A, Bm, Cm, state):
    """Single-token recurrence. x (B,1,H,P), dt (B,1,H), B/C (B,1,G,N),
    state (B,H,P,N) fp32. Returns (y (B,1,H,P), new_state)."""
    h = x.shape[2]
    hg = h // Bm.shape[2]
    da = torch.exp(dt[:, 0].float() * A.float())  # (B,H)
    bg = Bm[:, 0].repeat_interleave(hg, dim=1).float()  # (B,H,N)
    cg = Cm[:, 0].repeat_interleave(hg, dim=1).float()
    xdt = x[:, 0].float() * dt[:, 0].float()[..., None]  # (B,H,P)
    new_state = state * da[..., None, None] + torch.einsum("bhp,bhn->bhpn", xdt, bg)
    y = torch.einsum("bhpn,bhn->bhp", new_state, cg)
    return y[:, None].to(x.dtype), new_state


# ---------------------------------------------------------------------------
# Mamba2 mixer layer
# ---------------------------------------------------------------------------


def init_mamba_block(seed: int, cfg: ModelConfig, *names: str, lead=(), device="cuda") -> dict:
    """One Mamba2 block's parameters (``lead``-stacked), drawn from
    generators named ``names`` + the parameter's name: the reference's
    shapes and distributions."""
    d, d_inner, h = cfg.d_model, cfg.ssm_d_inner, cfg.ssm_nheads
    g, n, w = cfg.ssm_ngroups, cfg.ssm_state, cfg.ssm_conv_width
    dtype = dtype_of(cfg.param_dtype)
    lead = tuple(lead)

    def gen(name):
        return fold_seed(seed, *names, name, device=device)

    def uniform(name, shape, lo, hi):
        u = torch.rand(lead + shape, generator=gen(name), device=device, dtype=torch.float32)
        return u * (hi - lo) + lo

    # dt bias so that softplus(dt_bias) spans ~[1e-3, 1e-1] (the mamba2 default)
    dt0 = torch.exp(uniform("dt", (h,), math.log(1e-3), math.log(0.1)))
    dt_bias = dt0 + torch.log(-torch.expm1(-dt0))  # inverse softplus
    bc = 2 * g * n
    kw = dict(lead=lead, device=device)

    def conv_w(name, c):
        t = torch.randn(lead + (w, c), generator=gen(name), device=device, dtype=torch.float32)
        return t.mul_(1.0 / math.sqrt(w)).to(dtype)

    return {
        "norm": L.init_rmsnorm(d, dtype, **kw),
        "wz": L.dense_init(gen("wz"), (d, d_inner), dtype, **kw),
        "wx": L.dense_init(gen("wx"), (d, d_inner), dtype, **kw),
        "wbc": L.dense_init(gen("wbc"), (d, bc), dtype, **kw),
        "wdt": L.dense_init(gen("wdt"), (d, h), dtype, **kw),
        "dt_bias": dt_bias,
        "A_log": torch.log(uniform("A", (h,), 1.0, 16.0)),
        "D": torch.ones(lead + (h,), dtype=torch.float32, device=device),
        "conv_x_w": conv_w("convx", d_inner),
        "conv_x_b": torch.zeros(lead + (d_inner,), dtype=dtype, device=device),
        "conv_bc_w": conv_w("convbc", bc),
        "conv_bc_b": torch.zeros(lead + (bc,), dtype=dtype, device=device),
        "gate_norm": L.init_rmsnorm(d_inner, dtype, **kw),
        "wo": L.dense_init(gen("wo"), (d_inner, d), dtype, fan_in=d_inner, **kw),
    }


def causal_conv(x: torch.Tensor, w: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """Depthwise causal conv. x (B,S,C), w (W,C)."""
    width = w.shape[0]
    pad = F.pad(x, (0, 0, width - 1, 0))
    s = x.shape[1]
    out = torch.zeros_like(x)
    for i in range(width):  # width is 4: unrolled adds, no gather
        out = out + pad[:, i:i + s, :] * w[i]
    return out + b


def init_ssm_cache(cfg: ModelConfig, batch: int, *, lead=(), device="cuda") -> dict:
    """Zeros of the decode state: the (B,H,P,N) fp32 SSD state and the
    last conv_width - 1 inputs of each causal conv, ``lead``-stacked."""
    w = cfg.ssm_conv_width - 1
    cdt = dtype_of(cfg.compute_dtype)
    lead = tuple(lead)
    return {
        "state": torch.zeros(lead + (batch, cfg.ssm_nheads, cfg.ssm_head_dim, cfg.ssm_state),
                             dtype=torch.float32, device=device),
        "conv_x": torch.zeros(lead + (batch, w, cfg.ssm_d_inner), dtype=cdt, device=device),
        "conv_bc": torch.zeros(lead + (batch, w, 2 * cfg.ssm_ngroups * cfg.ssm_state),
                               dtype=cdt, device=device),
    }


def mamba_mixer(
    params: dict,
    x: torch.Tensor,
    cfg: ModelConfig,
    cache: Optional[dict] = None,
) -> tuple[torch.Tensor, Optional[dict]]:
    """x (B,S,D) -> (B,S,D). With a cache, S must be 1 (decode); the new
    cache comes back as new tensors."""
    b, s, d = x.shape
    cdt = dtype_of(cfg.compute_dtype)
    d_inner, h, p = cfg.ssm_d_inner, cfg.ssm_nheads, cfg.ssm_head_dim
    g, n = cfg.ssm_ngroups, cfg.ssm_state

    xn = L.rmsnorm(params["norm"], x, cfg.norm_eps).to(cdt)
    z = xn @ params["wz"].to(cdt)
    xc = xn @ params["wx"].to(cdt)
    bc = xn @ params["wbc"].to(cdt)
    dt = F.softplus((xn @ params["wdt"].to(cdt)).float() + params["dt_bias"])  # (B,S,H)

    new_cache = None
    if cache is None:
        conv_x = causal_conv(xc, params["conv_x_w"].to(cdt), params["conv_x_b"].to(cdt))
        conv_bc = causal_conv(bc, params["conv_bc_w"].to(cdt), params["conv_bc_b"].to(cdt))
    else:
        if s != 1:
            raise ValueError(f"the SSM decode step takes one token, got {s}")
        win_x = torch.cat([cache["conv_x"].to(cdt), xc], dim=1)
        win_bc = torch.cat([cache["conv_bc"].to(cdt), bc], dim=1)
        conv_x = (torch.einsum("bwc,wc->bc", win_x, params["conv_x_w"].to(cdt))
                  + params["conv_x_b"].to(cdt))[:, None]
        conv_bc = (torch.einsum("bwc,wc->bc", win_bc, params["conv_bc_w"].to(cdt))
                   + params["conv_bc_b"].to(cdt))[:, None]
        new_conv_x, new_conv_bc = win_x[:, 1:], win_bc[:, 1:]
    conv_x = F.silu(conv_x)
    conv_bc = F.silu(conv_bc)

    xs = conv_x.reshape(b, s, h, p)
    bmat = conv_bc[..., : g * n].reshape(b, s, g, n)  # views into conv_bc, no copy
    cmat = conv_bc[..., g * n:].reshape(b, s, g, n)
    A = -torch.exp(params["A_log"])

    if cache is None:
        y, _ = kops.ssd_scan(xs, dt, A, bmat, cmat, chunk=cfg.ssm_chunk)
    else:
        y, new_state = ssd_decode(xs, dt, A, bmat, cmat, cache["state"])
        new_cache = {"state": new_state, "conv_x": new_conv_x, "conv_bc": new_conv_bc}

    y = y + params["D"].to(cdt)[None, None, :, None] * xs
    y = y.reshape(b, s, d_inner)
    y = L.rmsnorm(params["gate_norm"], y * F.silu(z), cfg.norm_eps)
    out = y @ params["wo"].to(cdt)
    return out.to(x.dtype), new_cache


def mamba_stack(stack: dict, x: torch.Tensor, cfg: ModelConfig,
                cache: Optional[dict] = None, remat: str = "none") -> torch.Tensor:
    """Every block of an L-leading stack in turn, each adding its mixer's
    output to the residual, under the ``remat`` policy
    (``transformer.remat_wrap``). With a stacked cache (decode), each
    block's slice of the cache is overwritten in place with its new state."""

    def block(lp, x, layer_cache):
        y, new = mamba_mixer(lp, x, cfg, cache=layer_cache)
        if layer_cache is not None:
            for k, t in new.items():
                layer_cache[k].copy_(t)
        return x + y

    block = T.remat_wrap(block, remat)
    for i, lp in enumerate(T._layers(stack)):
        x = block(lp, x, None if cache is None else {k: t[i] for k, t in cache.items()})
    return x


# ---------------------------------------------------------------------------
# Pure-SSM LM (mamba2-370m)
# ---------------------------------------------------------------------------


def init(seed: int, cfg: ModelConfig, device="cuda") -> dict:
    """Fresh parameters from ``seed`` on ``device``: the reference's shapes,
    layouts and init distributions, not its numbers (see
    ``transformer.init``)."""
    dtype = dtype_of(cfg.param_dtype)
    return {
        "embed": L.init_embedding(fold_seed(seed, "embed", device=device), cfg, device=device),
        "layers": init_mamba_block(seed, cfg, "layers", lead=(cfg.num_layers,), device=device),
        "final_norm": L.init_rmsnorm(cfg.d_model, dtype, device=device),
    }


#: the reference's parameter tree with numpy leaves as the port's parameters
params_from_reference = T.params_from_reference


def forward(params, batch, cfg: ModelConfig, pc=None, *, remat: str = "none"):
    """Train / prefill forward: logits (B, S, V), each layer's body under
    the ``remat`` policy."""
    T._check(pc)
    x = L.embed(params["embed"], batch["tokens"], cfg, pc)
    x = mamba_stack(params["layers"], x, cfg, remat=remat)
    x = L.rmsnorm(params["final_norm"], x, cfg.norm_eps)
    return L.unembed(params["embed"], x, cfg)


def init_cache(cfg: ModelConfig, batch: int, max_len: int = 0, kv_dtype="bfloat16",
               device="cuda") -> dict:
    """A stacked (L-leading) cache of zeros; an SSM's cache does not grow
    with the sequence, so ``max_len`` and ``kv_dtype`` are unused."""
    return init_ssm_cache(cfg, batch, lead=(cfg.num_layers,), device=device)


def decode_step(params, cache, tokens, cache_index, cfg: ModelConfig, pc=None):
    """One decode step of one token per sequence. The stacked cache is
    updated in place. Returns (logits (B, 1, V), cache)."""
    T._check(pc)
    x = L.embed(params["embed"], tokens, cfg, pc)
    x = mamba_stack(params["layers"], x, cfg, cache=cache)
    x = L.rmsnorm(params["final_norm"], x, cfg.norm_eps)
    return L.unembed(params["embed"], x, cfg), cache
