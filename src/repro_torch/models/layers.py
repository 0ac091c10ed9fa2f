"""Core transformer layers: norms, RoPE, attention (naive / chunked-flash /
the flash_attention kernel), gated MLPs, embeddings. Functional, as the
reference: ``init_*`` builds parameter dicts, the other functions are pure.
Counterpart of ``repro/models/layers.py``.

Shape conventions:
  x       : (B, S, D)
  q       : (B, S, H, hd)      k/v : (B, S, KV, hd)
  caches  : k/v (B, KV, S_max, hd)  (+ int8 scales (B, KV, S_max, 1) when quantized)

Where the reference asks XLA for an fp32 product of low-precision inputs
(``preferred_element_type=jnp.float32``) the port casts the inputs to fp32
before the product. ``init_*`` take a ``lead`` shape so that the
transformer can draw every layer's weights as one L-leading stack.
"""
from __future__ import annotations

import math
from typing import Optional

import torch
import torch.nn.functional as F

from repro_torch.common import dtype_of
from repro_torch.config import ModelConfig
from repro_torch.kernels import ops as kops
from repro_torch.serving.kvcache import cache_kv, cache_update, quantized

# ---------------------------------------------------------------------------
# Initializers
# ---------------------------------------------------------------------------


def dense_init(gen, shape, dtype, fan_in: Optional[int] = None, *, lead=(),
               device="cuda"):
    """Normal(0, 1/fan_in) of ``lead + shape`` from ``gen`` (a generator on
    ``device``); ``fan_in`` defaults to ``shape[0]``. Scaled in place, so
    an fp32 stack is allocated once (qwen2-moe's expert stack alone is
    16.6 GB)."""
    fan_in = fan_in or shape[0]
    std = 1.0 / math.sqrt(fan_in)
    w = torch.randn(tuple(lead) + tuple(shape), generator=gen, device=device,
                    dtype=torch.float32)
    return w.mul_(std).to(dtype)


def embed_init(gen, shape, dtype, *, device="cuda"):
    w = torch.randn(tuple(shape), generator=gen, device=device, dtype=torch.float32)
    return (w * 0.02).to(dtype)


# ---------------------------------------------------------------------------
# Norms
# ---------------------------------------------------------------------------


def init_rmsnorm(d: int, dtype, *, lead=(), device="cuda") -> dict:
    return {"scale": torch.ones(tuple(lead) + (d,), dtype=dtype, device=device)}


def rmsnorm(params: dict, x: torch.Tensor, eps: float = 1e-6) -> torch.Tensor:
    dtype = x.dtype
    x = x.float()
    var = x.square().mean(dim=-1, keepdim=True)
    x = x * torch.rsqrt(var + eps)
    return (x * (1.0 + params["scale"].float() - 1.0)).to(dtype)


# ---------------------------------------------------------------------------
# RoPE
# ---------------------------------------------------------------------------


def rope_frequencies(head_dim: int, theta: float, device=None) -> torch.Tensor:
    exponents = torch.arange(0, head_dim, 2, dtype=torch.float32, device=device) / head_dim
    return 1.0 / (theta**exponents)  # (hd/2,)


def apply_rope(x: torch.Tensor, positions: torch.Tensor, theta: float) -> torch.Tensor:
    """x: (B, S, H, hd), positions: (B, S) int."""
    hd = x.shape[-1]
    freqs = rope_frequencies(hd, theta, x.device)
    angles = positions[..., None].float() * freqs  # (B, S, hd/2)
    cos = torch.cos(angles)[:, :, None, :]
    sin = torch.sin(angles)[:, :, None, :]
    x1, x2 = x.float().chunk(2, dim=-1)
    out = torch.cat([x1 * cos - x2 * sin, x2 * cos + x1 * sin], dim=-1)
    return out.to(x.dtype)


# ---------------------------------------------------------------------------
# Attention cores
# ---------------------------------------------------------------------------


def _grouped_scores(q: torch.Tensor, k: torch.Tensor) -> torch.Tensor:
    """q: (B,S,H,hd) k: (B,T,KV,hd) -> fp32 scores (B, KV, G, S, T), H = KV*G."""
    b, s, h, hd = q.shape
    kv = k.shape[2]
    qg = q.reshape(b, s, kv, h // kv, hd)
    return torch.einsum("bskgd,btkd->bkgst", qg.float(), k.float())


def _grouped_out(probs: torch.Tensor, v: torch.Tensor) -> torch.Tensor:
    """probs: (B,KV,G,S,T) v: (B,T,KV,hd) -> (B,S,H,hd)."""
    b, kv, g, s, t = probs.shape
    out = torch.einsum("bkgst,btkd->bskgd", probs, v)
    return out.reshape(b, s, kv * g, v.shape[-1])


def _positions(n: int, offset, device) -> torch.Tensor:
    return torch.arange(n, device=device) + offset


def naive_attention(
    q: torch.Tensor,
    k: torch.Tensor,
    v: torch.Tensor,
    *,
    causal: bool,
    q_offset=0,
    kv_len=None,
) -> torch.Tensor:
    """Materializes the full score matrix. Reference / short-seq path.

    q_offset: position of q[0] within the kv sequence (decode: cur position).
    kv_len:   number of valid kv entries (decode with a preallocated cache).
    """
    scale = 1.0 / math.sqrt(q.shape[-1])
    scores = _grouped_scores(q, k) * scale  # (B,KV,G,S,T) fp32
    s, t = scores.shape[-2], scores.shape[-1]
    q_pos = _positions(s, q_offset, q.device)[:, None]
    k_pos = torch.arange(t, device=q.device)[None, :]
    mask = torch.ones((s, t), dtype=torch.bool, device=q.device)
    if causal:
        mask = mask & (k_pos <= q_pos)
    if kv_len is not None:
        mask = mask & (k_pos < kv_len)
    scores = torch.where(mask, scores, -1e30)
    probs = torch.softmax(scores, dim=-1).to(v.dtype)
    return _grouped_out(probs, v)


def chunked_attention(
    q: torch.Tensor,
    k: torch.Tensor,
    v: torch.Tensor,
    *,
    causal: bool,
    chunk: int = 1024,
    q_offset=0,
    kv_len=None,
) -> torch.Tensor:
    """Flash-style online-softmax attention, looping over KV chunks: the
    reference's CPU stand-in for the flash kernel and its flash-decoding path
    (S_q == 1 against a long cache)."""
    b, s, h, hd = q.shape
    t = k.shape[1]
    kvh = k.shape[2]
    g = h // kvh
    chunk = min(chunk, t)
    n_chunks = -(-t // chunk)
    pad = n_chunks * chunk - t
    if pad:
        k = F.pad(k, (0, 0, 0, 0, 0, pad))
        v = F.pad(v, (0, 0, 0, 0, 0, pad))
    scale = 1.0 / math.sqrt(hd)
    qg = (q * scale).reshape(b, s, kvh, g, hd).float()
    q_pos = _positions(s, q_offset, q.device)

    m = torch.full((b, kvh, g, s), -math.inf, device=q.device)
    l = torch.zeros((b, kvh, g, s), device=q.device)
    acc = torch.zeros((b, s, kvh, g, hd), device=q.device)
    for idx in range(n_chunks):
        k_i = k[:, idx * chunk:(idx + 1) * chunk]  # (B,chunk,KV,hd)
        v_i = v[:, idx * chunk:(idx + 1) * chunk]
        k_pos = idx * chunk + torch.arange(chunk, device=q.device)
        scores = torch.einsum("bskgd,btkd->bkgst", qg, k_i.float())  # (B,KV,G,S,chunk)
        mask = torch.ones((s, chunk), dtype=torch.bool, device=q.device)
        if causal:
            mask = mask & (k_pos[None, :] <= q_pos[:, None])
        if kv_len is not None:
            mask = mask & (k_pos[None, :] < kv_len)
        else:
            mask = mask & (k_pos[None, :] < t)  # padding chunk tail
        scores = torch.where(mask, scores, -1e30)
        m_new = torch.maximum(m, scores.amax(dim=-1))
        p = torch.exp(scores - m_new[..., None])
        corr = torch.exp(m - m_new)
        l = l * corr + p.sum(dim=-1)
        pv = torch.einsum("bkgst,btkd->bskgd", p.to(v_i.dtype), v_i)
        acc = acc * corr.permute(0, 3, 1, 2)[..., None] + pv.float()
        m = m_new
    out = acc / l.clamp_min(1e-30).permute(0, 3, 1, 2)[..., None]
    return out.reshape(b, s, h, hd).to(q.dtype)


def chunked_attention_quantized(
    q: torch.Tensor,  # (B, S, H, hd)
    cache: dict,      # int8 k/v (B, KV, T, hd) + fp32 scales (B, KV, T, 1)
    *,
    chunk: int = 1024,
    q_offset=0,
    kv_len=None,
) -> torch.Tensor:
    """Flash-decoding over an int8 KV cache, dequantizing one chunk at a
    time (``cfg.lazy_kv_dequant``), so the whole cache is never
    materialized in the compute dtype."""
    b, s, h, hd = q.shape
    kvh, t = cache["k"].shape[1], cache["k"].shape[2]
    g = h // kvh
    chunk = min(chunk, t)
    n_chunks = -(-t // chunk)
    if t % chunk:
        raise ValueError(f"cache length {t} must be a multiple of the chunk {chunk}")
    scale = 1.0 / math.sqrt(hd)
    qg = (q * scale).reshape(b, s, kvh, g, hd).float()
    q_pos = _positions(s, q_offset, q.device)

    m = torch.full((b, kvh, g, s), -math.inf, device=q.device)
    l = torch.zeros((b, kvh, g, s), device=q.device)
    acc = torch.zeros((b, s, kvh, g, hd), device=q.device)
    for idx in range(n_chunks):
        sl = slice(idx * chunk, (idx + 1) * chunk)
        k_f = cache["k"][:, :, sl].float() * cache["k_scale"][:, :, sl]  # this tile only
        k_pos = idx * chunk + torch.arange(chunk, device=q.device)
        scores = torch.einsum("bskgd,bktd->bkgst", qg, k_f)
        mask = k_pos[None, :] <= q_pos[:, None]
        if kv_len is not None:
            mask = mask & (k_pos[None, :] < kv_len)
        scores = torch.where(mask, scores, -1e30)
        m_new = torch.maximum(m, scores.amax(dim=-1))
        p = torch.exp(scores - m_new[..., None])
        corr = torch.exp(m - m_new)
        l = l * corr + p.sum(dim=-1)
        v_f = cache["v"][:, :, sl].float() * cache["v_scale"][:, :, sl]
        pv = torch.einsum("bkgst,bktd->bskgd", p, v_f)
        acc = acc * corr.permute(0, 3, 1, 2)[..., None] + pv
        m = m_new
    out = acc / l.clamp_min(1e-30).permute(0, 3, 1, 2)[..., None]
    return out.reshape(b, s, h, hd).to(q.dtype)


def attention_core(q, k, v, cfg: ModelConfig, *, causal: bool, q_offset=0,
                   kv_len=None) -> torch.Tensor:
    """``attn_impl="flash_pallas"`` with no cache runs the flash_attention
    kernel (its plain version for CPU tensors; on a CUDA tensor it launches
    or raises), at every head_dim of the repo's configs (16 to 256, 80 and
    112 among them: ``kernels.flash_attention.HEAD_DIMS``). With a cache
    (``kv_len`` given) or a ``q_offset``, which the kernel does not take, it
    takes the chunked path, as in the reference."""
    impl = cfg.attn_impl
    if impl == "flash_pallas":
        if kv_len is None and q_offset == 0:
            return kops.flash_attention(q, k, v, causal=causal)
        impl = "chunked"
    if impl == "chunked":
        return chunked_attention(q, k, v, causal=causal, chunk=cfg.attn_chunk,
                                 q_offset=q_offset, kv_len=kv_len)
    return naive_attention(q, k, v, causal=causal, q_offset=q_offset, kv_len=kv_len)


# ---------------------------------------------------------------------------
# Attention block (projections + rope + cache handling)
# ---------------------------------------------------------------------------


def init_attention(gen, cfg: ModelConfig, *, lead=(), device="cuda") -> dict:
    d, h, kv, hd = cfg.d_model, cfg.num_heads, cfg.num_kv_heads, cfg.resolved_head_dim
    dtype = dtype_of(cfg.param_dtype)
    kw = dict(lead=lead, device=device)
    p = {
        "wq": dense_init(gen, (d, h * hd), dtype, **kw),
        "wk": dense_init(gen, (d, kv * hd), dtype, **kw),
        "wv": dense_init(gen, (d, kv * hd), dtype, **kw),
        "wo": dense_init(gen, (h * hd, d), dtype, fan_in=h * hd, **kw),
    }
    if cfg.use_qk_norm:
        p["q_norm"] = init_rmsnorm(hd, dtype, **kw)
        p["k_norm"] = init_rmsnorm(hd, dtype, **kw)
    return p


def attention_block(
    params: dict,
    x: torch.Tensor,
    cfg: ModelConfig,
    *,
    positions: torch.Tensor,
    cache: Optional[dict] = None,
    cache_index: Optional[int] = None,
    pc=None,
) -> tuple[torch.Tensor, Optional[dict]]:
    """Full attention block. If ``cache`` is given, runs one decode step: x
    is (B, s, D) and k/v are written into the cache at ``cache_index`` (in
    place; see ``serving.kvcache.cache_update``). With a ParallelCtx, x and
    the weights are DTensors: the projections are DTensor products, and
    everything from the heads to the attention output runs on each rank's
    local batch and heads (``_sharded_heads``)."""
    b, s, d = x.shape
    h, kvh, hd = cfg.num_heads, cfg.num_kv_heads, cfg.resolved_head_dim
    cdt = dtype_of(cfg.compute_dtype)
    xc = x.to(cdt)
    q = xc @ params["wq"].to(cdt)
    k = xc @ params["wk"].to(cdt)
    v = xc @ params["wv"].to(cdt)
    if pc is not None:
        out, new_cache = _sharded_heads(params, q, k, v, cfg, pc, positions=positions,
                                        cache=cache, cache_index=cache_index)
    else:
        out, new_cache = _heads(params, q.reshape(b, s, h, hd), k.reshape(b, s, kvh, hd),
                                v.reshape(b, s, kvh, hd), cfg, positions=positions,
                                cache=cache, cache_index=cache_index)
        out = out.reshape(b, s, h * hd)
    out = out @ params["wo"].to(cdt)
    return out.to(x.dtype), new_cache


def _heads(params, q, k, v, cfg: ModelConfig, *, positions, cache, cache_index,
           kv_index=None):
    """q (B,S,H,hd), k/v (B,S,KV,hd) -> the attention output (B,S,H,hd):
    qk-norm, RoPE, then attention over the sequence or, with a cache, one
    decode step against it (written in place). ``kv_index`` picks, for
    each of q's heads, the kv head it reads (a sharded call's local heads)."""
    s = q.shape[1]
    if cfg.use_qk_norm:
        q = rmsnorm(params["q_norm"], q, cfg.norm_eps)
        k = rmsnorm(params["k_norm"], k, cfg.norm_eps)
    q = apply_rope(q, positions, cfg.rope_theta)
    k = apply_rope(k, positions, cfg.rope_theta)
    if cache is None:
        if kv_index is not None:
            k, v = k.index_select(2, kv_index), v.index_select(2, kv_index)
        return attention_core(q, k, v, cfg, causal=cfg.causal), None
    new_cache = cache_update(cache, k, v, cache_index)
    read = new_cache
    if kv_index is not None:  # (B, KV, S, hd|1) -> the local q heads' kv heads
        read = {n: t.index_select(1, kv_index) for n, t in new_cache.items()}
    if cfg.lazy_kv_dequant and quantized(read):
        out = chunked_attention_quantized(q, read, chunk=cfg.attn_chunk,
                                          q_offset=cache_index, kv_len=cache_index + s)
    else:
        k_full, v_full = cache_kv(read)
        out = attention_core(q, k_full, v_full, cfg, causal=True,
                             q_offset=cache_index, kv_len=cache_index + s)
    return out, new_cache


def _sharded_heads(params, q, k, v, cfg: ModelConfig, pc, *, positions, cache,
                   cache_index):
    """``_heads`` over DTensors q (B,S,H*hd), k/v (B,S,KV*hd) from the
    sharded projections: each rank takes its batch shard and, where the q
    heads divide the model axis, its q heads. Where the kv heads divide
    too, each rank's kv heads are the ones its q heads read; otherwise
    (the GQA guard's fused kv*hd sharding, or replicated kv) k and v are
    gathered whole and each rank picks, for every local q head, its kv
    head. Returns the output (B,S,H*hd) sharded like q, and the cache."""
    from repro_torch.parallel.ctx import P, Sum, assign, shard_map

    h, kvh, hd = cfg.num_heads, cfg.num_kv_heads, cfg.resolved_head_dim
    m, msz = pc.model_axis, pc.model_size
    bt = pc.batch_for(q.shape[0])
    q_split = pc.tp and h % msz == 0
    kv_split = q_split and kvh % msz == 0
    q_ax = m if q_split else None
    kv_ax = m if kv_split else None
    rank = pc.mesh.get_local_rank(m) if q_split else 0
    hl = h // msz if q_split else h
    work = tuple(pc.batch_axes if bt is not None else ()) + ((m,) if q_split else ())
    norm_names = [n for n in ("q_norm", "k_norm") if cfg.use_qk_norm]
    names = list(cache) if cache is not None else []
    # a (B, KV, S, hd|1) cache is read by batch, and by kv heads where they
    # divide the model axis; one the rules shard on head_dim is gathered,
    # written whole and scattered back
    cache_specs = [P(bt, kv_ax, None, None)] * len(names)

    def body(q, k, v, *rest):
        norms = {n: {"scale": t} for n, t in zip(norm_names, rest)}
        layer_cache = dict(zip(names, rest[len(norm_names):]))
        bl, s = q.shape[:2]
        q = q.reshape(bl, s, hl, hd)
        k = k.reshape(bl, s, -1, hd)
        v = v.reshape(bl, s, -1, hd)
        pos = positions[:bl]  # rows are equal: the local batch's positions
        kv_index = None
        if q_split and not kv_split:
            # k/v came whole: each local q head's kv head (groups of one)
            kv_index = torch.arange(rank * hl, (rank + 1) * hl, device=q.device) // (h // kvh)
        out, new_cache = _heads(norms, q, k, v, cfg, positions=pos,
                                cache=layer_cache or None, cache_index=cache_index,
                                kv_index=kv_index)
        out = out.reshape(bl, s, hl * hd)
        if cache is None:
            return out
        return (out, *(new_cache[n] for n in names))

    in_specs = ([P(bt, None, q_ax), P(bt, None, kv_ax), P(bt, None, kv_ax)]
                + [P(None)] * len(norm_names) + cache_specs)
    # a gathered k/v feeds only the local heads' share; the norms' scales
    # take a share from every rank's batch and heads
    kv_grad = Sum(P(bt, None, None), (m,)) if q_split and not kv_split else None
    grad_specs = ([None, kv_grad or in_specs[1], kv_grad or in_specs[2]]
                  + [Sum(P(None), work)] * len(norm_names) + cache_specs)
    out_specs = P(bt, None, q_ax)
    if cache is not None:
        out_specs = [out_specs] + cache_specs
    res = shard_map(body, pc, in_specs, out_specs, grad_specs)(
        q, k, v, *(params[n]["scale"] for n in norm_names), *(cache[n] for n in names))
    if cache is None:
        return res, None
    out, *new = res
    for n, t in zip(names, new):
        if t.placements != cache[n].placements:  # written on a gathered copy
            assign(cache[n], t)
    return out, dict(cache)


# ---------------------------------------------------------------------------
# Gated MLP (SwiGLU / GeGLU)
# ---------------------------------------------------------------------------


def init_mlp(gen, cfg: ModelConfig, d_ff: Optional[int] = None, *, lead=(),
             device="cuda") -> dict:
    d, f = cfg.d_model, d_ff or cfg.d_ff
    dtype = dtype_of(cfg.param_dtype)
    kw = dict(lead=lead, device=device)
    return {
        "wi_gate": dense_init(gen, (d, f), dtype, **kw),
        "wi_up": dense_init(gen, (d, f), dtype, **kw),
        "wo": dense_init(gen, (f, d), dtype, fan_in=f, **kw),
    }


def mlp_block(params: dict, x: torch.Tensor, cfg: ModelConfig) -> torch.Tensor:
    cdt = dtype_of(cfg.compute_dtype)
    xc = x.to(cdt)
    gate = xc @ params["wi_gate"].to(cdt)
    up = xc @ params["wi_up"].to(cdt)
    # jax.nn.gelu defaults to the tanh approximation
    act = F.silu(gate) if cfg.act == "silu" else F.gelu(gate, approximate="tanh")
    return ((act * up) @ params["wo"].to(cdt)).to(x.dtype)


# ---------------------------------------------------------------------------
# Embedding / unembedding
# ---------------------------------------------------------------------------


def init_embedding(gen, cfg: ModelConfig, *, device="cuda") -> dict:
    dtype = dtype_of(cfg.param_dtype)
    p = {"embedding": embed_init(gen, (cfg.vocab_size, cfg.d_model), dtype, device=device)}
    if not cfg.tie_embeddings:
        p["unembed"] = dense_init(gen, (cfg.d_model, cfg.vocab_size), dtype, device=device)
    return p


def embed(params: dict, tokens: torch.Tensor, cfg: ModelConfig, pc=None) -> torch.Tensor:
    """Token embedding lookup. With a ParallelCtx the gather runs on each
    rank's local pieces (``ctx.shard_map``), with zero collectives, as the
    reference's ``shard_map`` body does: with TP on and a d_model that
    divides, the table is sharded on d_model over the model axis; otherwise
    the table is gathered whole first. Tokens are sharded by batch where
    the batch divides."""
    cdt = dtype_of(cfg.compute_dtype)
    table = params["embedding"]
    if pc is None:
        x = table[tokens].to(cdt)  # gather, then cast: the same values
    else:
        x = _sharded_embed(table, tokens, cdt, pc)
    if cfg.embed_scale:
        x = x * torch.tensor(math.sqrt(cfg.d_model), dtype=cdt, device=x.device)
    return x


def _sharded_embed(table, tokens, cdt, pc):
    from repro_torch.parallel.ctx import P, Sum, shard_map

    bt = pc.batch_for(tokens.shape[0])
    d_ax = pc.model_axis if pc.tp and table.shape[1] % pc.model_size == 0 else None
    tab_spec = P(None, d_ax)
    # each rank scatters its own tokens' rows into the table's gradient
    tab_grad = Sum(tab_spec, pc.batch_axes) if bt is not None else tab_spec
    return shard_map(lambda tok, tab: tab.to(cdt)[tok], pc,
                     in_specs=(P(bt, None), tab_spec), out_specs=P(bt, None, d_ax),
                     grad_specs=(None, tab_grad))(tokens, table)


def unembed(params: dict, x: torch.Tensor, cfg: ModelConfig) -> torch.Tensor:
    cdt = dtype_of(cfg.compute_dtype)
    if cfg.tie_embeddings:
        w = params["embedding"].to(cdt).T
    else:
        w = params["unembed"].to(cdt)
    logits = (x.to(cdt) @ w).to(dtype_of(cfg.logits_dtype))
    if cfg.logit_softcap > 0:
        c = cfg.logit_softcap
        logits = torch.tanh(logits / c) * c
    return logits
