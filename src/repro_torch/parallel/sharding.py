"""Sharding rules: map (param path, shape) -> partition spec (``P``).
Counterpart of ``repro/parallel/sharding.py``: the same rules, whose specs
equal the reference's entry for entry, plus ``distribute_tree``, which
places a tree of tensors on a DeviceMesh by them.

Scheme
------
* TP (model axis): attention q heads, MLP hidden, vocab, SSD heads/d_inner,
  MoE experts (EP) or per-expert hidden (TPE).
* GQA guard: kv projections are sharded over the model axis only when the kv
  head count divides it; otherwise replicated (gemma MQA, kv=8 models on a
  16-way axis). Q heads likewise fall back to replication when H doesn't
  divide (gemma-2b H=8 on 16: attention replicated, MLP still TP).
* FSDP (data axis): any still-unsharded dim of a large param is additionally
  sharded over the data axis (ZeRO-3 style); XLA inserts the per-layer
  all-gathers (here DTensor's redistributes). Threshold + on/off from
  MeshConfig.
* Everything else (norms, scalars, router) is replicated.

The same rules produce optimizer-state and gradient shardings (identical tree
structure); the sharded train step redistributes each gradient onto its
parameter's placements.
"""
from __future__ import annotations

from typing import Optional

import numpy as np
from torch.distributed.tensor import DTensor
from torch.distributed.tensor._utils import compute_local_shape_and_global_offset

from repro_torch.config import MeshConfig, ModelConfig
from repro_torch.parallel.ctx import P, ParallelCtx, check_even, placements

# path components that carry stacked layer dims (prepend None per component)
_STACK_KEYS = {"layers": 1, "groups": 2, "tail": 1}


def tree_map_with_path_str(fn, tree, *rest):
    """``fn(path, leaf, *rest_leaves)`` over a dict/list/tuple tree, with
    the leaf's 'a/b/0' path."""

    def go(prefix, t, *r):
        if isinstance(t, dict):
            return {k: go(prefix + (str(k),), t[k], *(x[k] for x in r)) for k in t}
        if isinstance(t, (list, tuple)) and not isinstance(t, P):
            return type(t)(go(prefix + (str(i),), v, *(x[i] for x in r))
                           for i, v in enumerate(t))
        return fn("/".join(prefix), t, *r)

    return go((), tree, *rest)


def _divisible(n: int, by: int) -> bool:
    return by > 0 and n % by == 0


def _core_spec(
    path: str, shape: tuple[int, ...], cfg: ModelConfig, pc: ParallelCtx
) -> list[Optional[str]]:
    """Spec for the unstacked ('core') shape."""
    m = pc.model_axis
    msz = pc.model_size
    parts = path.split("/")
    name = parts[-1]
    spec: list[Optional[str]] = [None] * len(shape)
    if not pc.tp:
        return spec  # TP off: FSDP-only sharding (both axes as data)

    q_shardable = _divisible(cfg.num_heads, msz)
    kv_shardable = _divisible(cfg.num_kv_heads, msz)

    if name in ("wq",):
        if q_shardable:
            spec[-1] = m
    elif name in ("wk", "wv"):
        # kv heads, or — when kv < msz (GQA) — the fused (kv*hd) dim: the
        # KV cache is then head_dim-sharded, which keeps cache writes local
        # (replicated caches get all-gathered EVERY decode step otherwise)
        if kv_shardable or _divisible(shape[-1], msz):
            spec[-1] = m
    elif name == "wo" and "attn" in parts:
        if q_shardable:
            spec[-2] = m
    elif name in ("wi_gate", "wi_up"):
        if _divisible(shape[-1], msz):
            spec[-1] = m
    elif name == "wo" and ("mlp" in parts or "shared" in parts):
        if _divisible(shape[-2], msz):
            spec[-2] = m
    elif name in ("wg", "wu") and "moe" in parts:
        # (E, D, F)
        if _divisible(cfg.num_experts, msz):
            spec[0] = m  # EP
        elif _divisible(shape[-1], msz):
            spec[-1] = m  # TPE
    elif name == "wo" and "moe" in parts:
        # (E, F, D)
        if _divisible(cfg.num_experts, msz):
            spec[0] = m
        elif _divisible(shape[-2], msz):
            spec[-2] = m
    elif name == "embedding":
        # shard d_model, NOT vocab: the token gather then slices locally with
        # no resharding (vocab-sharded tables force an involuntary full
        # rematerialization in SPMD). The unembed matmul contracts the sharded
        # dim (tied) or uses its own vocab-sharded matrix (untied).
        if _divisible(shape[1], msz):
            spec[1] = m
    elif name == "unembed":
        if _divisible(shape[-1], msz):
            spec[-1] = m
    elif name in ("wz", "wx"):
        if _divisible(shape[-1], msz):
            spec[-1] = m
    elif name == "wdt":
        if _divisible(cfg.ssm_nheads, msz):
            spec[-1] = m
    elif name == "conv_x_w":
        if _divisible(shape[-1], msz):
            spec[-1] = m
    elif name == "conv_x_b":
        if _divisible(shape[-1], msz):
            spec[-1] = m
    elif name == "wo" and len(shape) == 2 and shape[0] == cfg.ssm_d_inner:
        if _divisible(shape[0], msz):
            spec[0] = m
    elif name == "gate_norm" or parts[-2:-1] == ["gate_norm"]:
        pass
    return spec


def _ssm_wo(path: str) -> bool:
    parts = path.split("/")
    return parts[-1] == "wo" and not any(
        k in parts for k in ("attn", "mlp", "moe", "shared")
    )


def _fsdp_upgrade(
    spec: list[Optional[str]],
    shape: tuple[int, ...],
    pc: ParallelCtx,
    mesh_cfg: MeshConfig,
    skip: bool = False,
) -> list[Optional[str]]:
    if skip or not mesh_cfg.fsdp_params:
        return spec
    if int(np.prod(shape)) < mesh_cfg.fsdp_min_size:
        return spec
    if pc.tp:
        fs_axis: object = pc.data_axis
        dsz = pc.shape[pc.data_axis]
    else:
        # TP off: FSDP over BOTH axes (data, model)
        fs_axis = ("data", pc.model_axis)
        dsz = pc.shape["data"] * pc.shape[pc.model_axis]
    # largest-first unsharded dim that divides
    order = sorted(range(len(shape)), key=lambda i: -shape[i])
    for i in order:
        if spec[i] is None and _divisible(shape[i], dsz):
            spec[i] = fs_axis
            return spec
    return spec


def param_spec(
    path: str, shape: tuple[int, ...], cfg: ModelConfig, pc: ParallelCtx,
    mesh_cfg: MeshConfig,
) -> P:
    parts = path.split("/")
    lead = _STACK_KEYS.get(parts[0], 0)
    core_shape = shape[lead:]
    if _ssm_wo(path):
        spec = [None] * len(core_shape)
        if _divisible(core_shape[0], pc.model_size):
            spec[0] = pc.model_axis
    else:
        spec = _core_spec(path, core_shape, cfg, pc)
    # with TP on, the embedding table's spec must match the local embed's
    # (P(None, model)): FSDP-upgrading it would force a per-use gather; with
    # TP off the plain-gather path handles any sharding
    spec = _fsdp_upgrade(spec, core_shape, pc, mesh_cfg,
                         skip=parts[-1] == "embedding" and pc.tp)
    return P(*([None] * lead + spec))


def param_specs(params, cfg: ModelConfig, pc: ParallelCtx, mesh_cfg: MeshConfig):
    """Build the full spec tree for a param tree (tensors or meta tensors)."""
    return tree_map_with_path_str(
        lambda path, leaf: param_spec(path, leaf.shape, cfg, pc, mesh_cfg), params
    )


# ---------------------------------------------------------------------------
# Activation / batch / cache specs
# ---------------------------------------------------------------------------


def batch_specs(batch_shapes: dict, pc: ParallelCtx) -> dict:
    """Shard the leading batch dim over the DP axes when divisible."""
    out = {}
    bt = pc.batch_axes if len(pc.batch_axes) > 1 else pc.batch_axes[0]
    for k, sds in batch_shapes.items():
        if sds.shape and _divisible(sds.shape[0], pc.batch_size):
            out[k] = P(bt, *([None] * (len(sds.shape) - 1)))
        else:
            out[k] = P(*([None] * len(sds.shape)))
    return out


def cache_spec(
    path: str, shape: tuple[int, ...], cfg: ModelConfig, pc: ParallelCtx,
    shard_seq: bool = False,
) -> P:
    """KV/SSM cache sharding. Layout (with stacked leading dims):
    kv k/v:    (L, B, KV, S, hd)      ssm state: (L, B, H, P, N)
    hybrid kv: (G, B, KV, S, hd)      conv:      (L, B, W, C)
    """
    parts = path.split("/")
    name = parts[-1]
    m, msz = pc.model_axis, pc.model_size
    bsz = pc.batch_size
    bt = pc.batch_axes if len(pc.batch_axes) > 1 else pc.batch_axes[0]
    spec: list = [None] * len(shape)

    # batch/head dims are indexed from the right so stacked lead dims pass through
    if name in ("k", "v", "k_scale", "v_scale"):
        # (..., B, KV, S, hd/1)
        b_i, kv_i, s_i, h_i = (len(shape) - 4, len(shape) - 3,
                               len(shape) - 2, len(shape) - 1)
        if _divisible(shape[b_i], bsz):
            spec[b_i] = bt
        if _divisible(cfg.num_kv_heads, msz):
            spec[kv_i] = m
        elif _divisible(shape[h_i], msz):
            spec[h_i] = m  # GQA: head_dim-sharded cache (matches wk/wv)
        if shard_seq and spec[b_i] is None and _divisible(shape[s_i], bsz):
            spec[s_i] = bt  # flash-decoding style sequence sharding
        return P(*spec)
    if name == "state":
        # (..., B, H, P, N)
        b_i, h_i = len(shape) - 4, len(shape) - 3
        if _divisible(shape[b_i], bsz):
            spec[b_i] = bt
        if _divisible(shape[h_i], msz):
            spec[h_i] = m
        return P(*spec)
    if name in ("conv_x", "conv_bc"):
        # (..., B, W, C)
        b_i, c_i = len(shape) - 3, len(shape) - 1
        if _divisible(shape[b_i], bsz):
            spec[b_i] = bt
        if name == "conv_x" and _divisible(shape[c_i], msz):
            spec[c_i] = m
        return P(*spec)
    return P(*spec)


def cache_specs(cache, cfg: ModelConfig, pc: ParallelCtx, shard_seq: bool = False):
    return tree_map_with_path_str(
        lambda path, leaf: cache_spec(path, leaf.shape, cfg, pc, shard_seq), cache
    )


def logits_spec(pc: ParallelCtx, batch_divisible: bool = True) -> P:
    bt = pc.batch_axes if len(pc.batch_axes) > 1 else pc.batch_axes[0]
    return P(bt if batch_divisible else None, None, pc.model_axis)


def distribute_tree(tree, specs, mesh):
    """Every tensor of ``tree`` as a DTensor on ``mesh`` placed by the
    matching ``P`` of ``specs``. A leaf every rank holds whole (the same
    values on each) gives each rank a copy of its own slice, with no
    communication (the leaf itself is never aliased: it may be another
    process's memory); a DTensor leaf is redistributed."""

    def place(path, t, spec):
        check_even(t.shape, spec, mesh)
        pl = placements(spec, mesh)
        if isinstance(t, DTensor):
            return t.redistribute(mesh, pl)
        return local_slice(t, mesh, pl)

    return tree_map_with_path_str(place, tree, specs)


def local_slice(t, mesh, pl) -> DTensor:
    """This rank's slice of the whole tensor ``t``, copied to the mesh's
    device, as a DTensor on ``mesh`` placed by ``pl``."""
    shape, offset = compute_local_shape_and_global_offset(t.shape, mesh, pl)
    local = t[tuple(slice(o, o + n) for o, n in zip(offset, shape))].to(
        mesh.device_type, copy=True)
    return DTensor.from_local(local, mesh, pl, run_check=False, shape=t.shape,
                              stride=contiguous_strides(t.shape))


def contiguous_strides(shape) -> tuple:
    out, n = [], 1
    for d in reversed(tuple(shape)):
        out.append(n)
        n *= d
    return tuple(reversed(out))


def shardings(tree, specs, mesh):
    """A ``(mesh, placements)`` pair for each ``P`` of ``specs``, in
    ``tree``'s structure: what ``train.checkpoint.restore`` places leaves
    by."""
    return tree_map_with_path_str(lambda path, t, spec: (mesh, placements(spec, mesh)),
                                  tree, specs)
