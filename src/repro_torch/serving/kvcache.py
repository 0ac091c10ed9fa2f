"""KV cache with optional int8 quantization (per-token, per-head scales).
Counterpart of ``repro/serving/kvcache.py``.

Layout: k/v stored as (B, KV_heads, S_max, head_dim). The int8 path stores
int8 values plus a per-(token, head) fp32 scale, halving the cache's bytes.
``torch.round`` rounds half to even, as ``jnp.round`` does, so from the same
k/v the int8 values and scales equal the reference's bit for bit.

``cache_update`` writes into the cache's tensors in place, where the
reference returns new arrays: a decode step then moves only the new
token's k/v, not the whole preallocated cache.
"""
from __future__ import annotations

import torch

from repro_torch.common import dtype_of


def init_cache(batch: int, kv_heads: int, max_len: int, head_dim: int,
               dtype="bfloat16", *, lead=(), device="cuda") -> dict:
    """Zeros of (*lead, B, KV, max_len, hd); ``lead`` stacks one per layer."""
    shape = tuple(lead) + (batch, kv_heads, max_len, head_dim)
    scale_shape = shape[:-1] + (1,)
    dtype = dtype_of(dtype)
    if dtype == torch.int8:
        return {
            "k": torch.zeros(shape, dtype=torch.int8, device=device),
            "v": torch.zeros(shape, dtype=torch.int8, device=device),
            "k_scale": torch.zeros(scale_shape, dtype=torch.float32, device=device),
            "v_scale": torch.zeros(scale_shape, dtype=torch.float32, device=device),
        }
    return {
        "k": torch.zeros(shape, dtype=dtype, device=device),
        "v": torch.zeros(shape, dtype=dtype, device=device),
    }


def quantized(cache: dict) -> bool:
    return "k_scale" in cache


def _quantize(x: torch.Tensor) -> tuple[torch.Tensor, torch.Tensor]:
    """x: (..., hd) -> int8 values + fp32 scale broadcast over hd."""
    xf = x.float()
    amax = xf.abs().amax(dim=-1, keepdim=True)
    scale = amax.clamp_min(1e-8) / 127.0
    q = torch.round(xf / scale).clamp(-127, 127).to(torch.int8)
    return q, scale


def cache_update(cache: dict, k: torch.Tensor, v: torch.Tensor, index: int) -> dict:
    """Write new k/v (..., B, s, KV, hd) at position ``index`` along the
    cache's sequence dim, in place; returns a dict of the same tensors.
    Leading dims pass through, so a stacked (L-leading) cache takes the
    stacked k/v of every layer in one call."""
    k = k.transpose(-3, -2)  # (..., B, KV, s, hd)
    v = v.transpose(-3, -2)
    index = int(index)
    s, max_len = k.shape[-2], cache["k"].shape[-2]
    if not 0 <= index <= max_len - s:
        raise ValueError(f"cannot write {s} positions at {index} into a cache of {max_len}")
    sl = slice(index, index + s)
    if quantized(cache):
        kq, ks = _quantize(k)
        vq, vs = _quantize(v)
        cache["k"][..., sl, :] = kq
        cache["v"][..., sl, :] = vq
        cache["k_scale"][..., sl, :] = ks
        cache["v_scale"][..., sl, :] = vs
    else:
        cache["k"][..., sl, :] = k.to(cache["k"].dtype)
        cache["v"][..., sl, :] = v.to(cache["v"].dtype)
    return dict(cache)


def cache_kv(cache: dict, dtype=torch.bfloat16) -> tuple[torch.Tensor, torch.Tensor]:
    """Return k/v as (B, S_max, KV, hd) in ``dtype`` (dequantizing if int8)."""
    if quantized(cache):
        k = (cache["k"].float() * cache["k_scale"]).to(dtype)
        v = (cache["v"].float() * cache["v_scale"]).to(dtype)
    else:
        k, v = cache["k"].to(dtype), cache["v"].to(dtype)
    return k.transpose(1, 2), v.transpose(1, 2)
