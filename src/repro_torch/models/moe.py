"""Mixture-of-Experts transformer. Counterpart of ``repro/models/moe.py``.

The reference's single-device path (``ep_scheme`` "ref": no
``ParallelCtx``): route each token to its top-k experts, scatter the tokens
into per-expert capacity buckets, run the experts' gated MLPs as three
grouped products, and gather the outputs back weighted by the router. The
three products (the reference's ``ecd,edf->ecf`` einsums) go through
``ops.gmm``: on the card the gmm kernel, on the CPU its plain version. The
expert-parallel (EP) and tensor-parallel-expert (TPE) schemes come with the
port's parallel slice and raise until then, as a ``pc`` does everywhere.
"""
from __future__ import annotations

import math

import torch
import torch.nn.functional as F

from repro_torch.common import dtype_of, fold_seed, round_up
from repro_torch.config import ModelConfig
from repro_torch.kernels import ops as kops
from repro_torch.models import layers as L
from repro_torch.models import transformer as T

# ---------------------------------------------------------------------------
# Routing + dispatch
# ---------------------------------------------------------------------------


def capacity_for(n_tokens: int, cfg: ModelConfig) -> int:
    assignments = n_tokens * cfg.num_experts_per_tok
    if assignments <= 8192:
        return assignments  # decode / tiny batches: never drop
    c = math.ceil(assignments * cfg.capacity_factor / cfg.num_experts)
    return round_up(max(c, 8), 8)


def route(x2d: torch.Tensor, wr: torch.Tensor, cfg: ModelConfig):
    """Returns (top_w (N,k) fp32, top_e (N,k) int64, aux_loss scalar)."""
    logits = x2d.float() @ wr.float()  # (N, E)
    probs = torch.softmax(logits, dim=-1)
    top_w, top_e = torch.topk(probs, cfg.num_experts_per_tok, dim=-1)
    top_w = top_w / top_w.sum(dim=-1, keepdim=True).clamp_min(1e-9)
    # Switch-style load-balance aux loss
    e = cfg.num_experts
    assign = F.one_hot(top_e[:, 0], e).float()  # primary expert
    aux = e * torch.sum(assign.mean(dim=0) * probs.mean(dim=0))
    return top_w, top_e, aux


def dispatch(x2d, top_e, num_experts: int, capacity: int, e_start: int, e_count: int):
    """Scatter tokens into per-expert capacity buckets.

    Returns (buf (e_count, C, D), dest (N*k,), keep (N*k,) bool). ``dest``
    indexes the flattened local buffer; dropped or remote assignments point
    at the overflow row, which is discarded (only it takes duplicate
    writes)."""
    n, k = top_e.shape
    d = x2d.shape[-1]
    flat_e = top_e.reshape(-1)  # (N*k,), token-major
    onehot = F.one_hot(flat_e, num_experts)
    pos = ((torch.cumsum(onehot, dim=0) - onehot) * onehot).sum(dim=1)  # (N*k,)
    keep = (flat_e >= e_start) & (flat_e < e_start + e_count) & (pos < capacity)
    dest = torch.where(keep, (flat_e - e_start) * capacity + pos,
                       torch.full_like(flat_e, e_count * capacity))
    token_idx = torch.arange(n, device=x2d.device).repeat_interleave(k)
    buf = torch.zeros((e_count * capacity + 1, d), dtype=x2d.dtype, device=x2d.device)
    buf[dest] = x2d[token_idx]
    return buf[:-1].reshape(e_count, capacity, d), dest, keep


def combine(y_buf, dest, keep, top_w, n: int, k: int):
    """Gather expert outputs back per assignment and weighted-sum over the
    k slots; fp32 (N, D)."""
    d = y_buf.shape[-1]
    flat = torch.cat([y_buf.reshape(-1, d), y_buf.new_zeros((1, d))])
    y_assign = flat[dest]  # the overflow row is zeros
    w = (top_w.reshape(-1) * keep.float())[:, None]
    return (y_assign.float() * w).reshape(n, k, d).sum(dim=1)


def expert_ffn(buf, wg, wu, wo, cfg: ModelConfig):
    """buf (E_loc, C, D); weights (E_loc, D, F) / (E_loc, F, D). Every
    weight is cast to the compute dtype on each call, as in the reference."""
    cdt = dtype_of(cfg.compute_dtype)
    x = buf.to(cdt)
    gate = kops.gmm(x, wg.to(cdt))
    up = kops.gmm(x, wu.to(cdt))
    act = F.silu(gate) if cfg.act == "silu" else F.gelu(gate, approximate="tanh")
    return kops.gmm(act * up, wo.to(cdt))


# ---------------------------------------------------------------------------
# The MoE FFN layer
# ---------------------------------------------------------------------------


def ep_scheme(cfg: ModelConfig, pc) -> str:
    if pc is None or pc.model_size == 1:
        return "ref"
    if cfg.num_experts % pc.model_size == 0:
        return "ep"
    f = cfg.moe_d_ff or cfg.d_ff
    if f % pc.model_size == 0:
        return "tpe"
    return "ref"


def _moe_ffn_local(x3d, wr, wg, wu, wo, cfg, e_start, e_count):
    """The MoE ffn on local tokens. x3d: (Bl, S, D)."""
    bl, s, d = x3d.shape
    n = bl * s
    x2d = x3d.reshape(n, d)
    top_w, top_e, aux = route(x2d, wr, cfg)
    cap = capacity_for(n, cfg)
    buf, dest, keep = dispatch(x2d, top_e, cfg.num_experts, cap, e_start, e_count)
    y_buf = expert_ffn(buf, wg, wu, wo, cfg)
    out = combine(y_buf, dest, keep, top_w, n, cfg.num_experts_per_tok)
    return out.reshape(bl, s, d).to(x3d.dtype), aux


def moe_ffn(params: dict, x: torch.Tensor, cfg: ModelConfig, pc=None):
    """Routed-experts FFN. Returns (out (B,S,D), aux loss scalar)."""
    scheme = ep_scheme(cfg, pc)
    if scheme != "ref":
        raise NotImplementedError(f"the {scheme} expert scheme comes with the port's "
                                  "parallel slice")
    return _moe_ffn_local(x, params["router"], params["wg"], params["wu"], params["wo"],
                          cfg, 0, cfg.num_experts)


# ---------------------------------------------------------------------------
# Blocks / model
# ---------------------------------------------------------------------------


def init_moe_ffn(seed: int, cfg: ModelConfig, *names: str, lead=(), device="cuda") -> dict:
    d = cfg.d_model
    f = cfg.moe_d_ff or cfg.d_ff
    e = cfg.num_experts
    dtype = dtype_of(cfg.param_dtype)
    kw = dict(lead=lead, device=device)

    def gen(name):
        return fold_seed(seed, *names, name, device=device)

    p = {
        "router": L.dense_init(gen("router"), (d, e), torch.float32, **kw),
        "wg": L.dense_init(gen("wg"), (e, d, f), dtype, fan_in=d, **kw),
        "wu": L.dense_init(gen("wu"), (e, d, f), dtype, fan_in=d, **kw),
        "wo": L.dense_init(gen("wo"), (e, f, d), dtype, fan_in=f, **kw),
    }
    if cfg.num_shared_experts:
        p["shared"] = L.init_mlp(gen("shared"), cfg, d_ff=cfg.num_shared_experts * f, **kw)
        p["shared_gate"] = L.dense_init(gen("sg"), (d, 1), torch.float32, **kw)
    return p


def init_block(seed: int, cfg: ModelConfig, *names: str, lead=(), device="cuda") -> dict:
    dtype = dtype_of(cfg.param_dtype)
    return {
        "attn_norm": L.init_rmsnorm(cfg.d_model, dtype, lead=lead, device=device),
        "attn": L.init_attention(fold_seed(seed, *names, "attn", device=device), cfg,
                                 lead=lead, device=device),
        "mlp_norm": L.init_rmsnorm(cfg.d_model, dtype, lead=lead, device=device),
        "moe": init_moe_ffn(seed, cfg, *names, "moe", lead=lead, device=device),
    }


def block_apply(params, x, cfg: ModelConfig, pc=None, *, positions, cache=None,
                cache_index=None):
    """Returns (x, new_cache, aux)."""
    h, new_cache = L.attention_block(
        params["attn"],
        L.rmsnorm(params["attn_norm"], x, cfg.norm_eps),
        cfg,
        positions=positions,
        cache=cache,
        cache_index=cache_index,
    )
    x = x + h
    xin = L.rmsnorm(params["mlp_norm"], x, cfg.norm_eps)
    ff, aux = moe_ffn(params["moe"], xin, cfg, pc)
    if cfg.num_shared_experts:
        # an fp32 product, as jax promotes a bf16 gate (cast_params_once) to fp32
        gate = torch.sigmoid(xin.float() @ params["moe"]["shared_gate"].float()).to(x.dtype)
        ff = ff + gate * L.mlp_block(params["moe"]["shared"], xin, cfg)
    return x + ff, new_cache, aux


def init(seed: int, cfg: ModelConfig, device="cuda") -> dict:
    """Fresh parameters from ``seed`` on ``device``: the reference's shapes,
    layouts and init distributions, not its numbers (see
    ``transformer.init``)."""
    dtype = dtype_of(cfg.param_dtype)
    return {
        "embed": L.init_embedding(fold_seed(seed, "embed", device=device), cfg, device=device),
        "layers": init_block(seed, cfg, "layers", lead=(cfg.num_layers,), device=device),
        "final_norm": L.init_rmsnorm(cfg.d_model, dtype, device=device),
    }


#: the reference's parameter tree with numpy leaves as the port's parameters
params_from_reference = T.params_from_reference


def forward(params, batch, cfg: ModelConfig, pc=None, *, remat: str = "none"):
    """Returns (logits (B, S, V), aux loss averaged over the layers); each
    layer's body under the ``remat`` policy."""
    T._check(pc)
    x = L.embed(params["embed"], batch["tokens"], cfg, pc)
    b, s, _ = x.shape
    positions = torch.arange(s, dtype=torch.int32, device=x.device).expand(b, s)

    def body(lp, x):
        y, _, layer_aux = block_apply(lp, x, cfg, pc, positions=positions)
        return y, layer_aux

    body = T.remat_wrap(body, remat)
    aux = torch.zeros((), dtype=torch.float32, device=x.device)
    for lp in T._layers(params["layers"]):
        x, layer_aux = body(lp, x)
        aux = aux + layer_aux
    x = L.rmsnorm(params["final_norm"], x, cfg.norm_eps)
    return L.unembed(params["embed"], x, cfg), aux / cfg.num_layers


def init_cache(cfg: ModelConfig, batch: int, max_len: int, kv_dtype="bfloat16",
               device="cuda") -> dict:
    return T.init_cache(cfg, batch, max_len, kv_dtype, device=device)


def decode_step(params, cache, tokens, cache_index, cfg: ModelConfig, pc=None):
    """One decode step of ``s`` tokens per sequence written at
    ``cache_index`` (``s > 1`` fills the cache from a prompt). The stacked kv
    cache is updated in place. Returns (logits (B, s, V), cache)."""
    T._check(pc)
    x = L.embed(params["embed"], tokens, cfg, pc)
    b, s, _ = x.shape
    positions = (cache_index + torch.arange(s, dtype=torch.int32, device=x.device)
                 ).expand(b, s)
    for i, lp in enumerate(T._layers(params["layers"])):
        layer_cache = {name: t[i] for name, t in cache.items()}
        x, _, _ = block_apply(lp, x, cfg, pc, positions=positions, cache=layer_cache,
                              cache_index=cache_index)
    x = L.rmsnorm(params["final_norm"], x, cfg.norm_eps)
    return L.unembed(params["embed"], x, cfg), cache
