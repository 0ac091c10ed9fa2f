"""Three-term roofline analysis: the port's counterpart of
``repro/launch/roofline.py``.

  compute_s    = HLO_FLOPs_per_device / peak_bf16
  memory_s     = HLO_bytes_per_device / hbm_bw
  collective_s = per-chip wire bytes (ring-model per collective) / ici_link_bw

``parse_collectives`` reads the post-SPMD compiled HLO text: every
all-gather / all-reduce / reduce-scatter / all-to-all / collective-permute
instruction's result shape (local, since the module is the per-device SPMD
program) plus its replica-group size, converted to wire bytes with the
standard ring formulas (``wire_bytes``, which the port's dry run,
``launch.dryrun``, shares). ``analyze`` reads one dry-run record (its
``cost_analysis`` and ``collectives``). The text parsing and the arithmetic
are copies of the reference's.

``count_params`` counts the elements of ``train.steps.abstract_params``
(meta tensors, nothing allocated), and ``model_flops`` is the reference's
op for op, so its floats are bitwise-equal to the reference's.
"""
from __future__ import annotations

import dataclasses
import re

import numpy as np

from repro_torch.common import tree_size
from repro_torch.config import ModelConfig, ShapeConfig
from repro_torch.launch.hwspecs import V5E, ChipSpec

_DTYPE_BYTES = {
    "pred": 1, "s8": 1, "u8": 1, "s16": 2, "u16": 2, "bf16": 2, "f16": 2,
    "s32": 4, "u32": 4, "f32": 4, "s64": 8, "u64": 8, "f64": 8, "c64": 8,
    "c128": 16,
}

_COLL_RE = re.compile(
    r"=\s*((?:\([^)]*\))|(?:[a-z0-9]+\[[0-9,]*\]))\S*\s+"
    r"(all-reduce|all-gather|reduce-scatter|all-to-all|collective-permute)"
    r"(-start)?\("
)
_SHAPE_RE = re.compile(r"([a-z0-9]+)\[([0-9,]*)\]")
_GROUPS_RE = re.compile(r"replica_groups=\[(\d+),(\d+)\]")
_GROUPS_LIST_RE = re.compile(r"replica_groups=\{\{([^}]*)\}")


def _shape_bytes(shape_str: str) -> int:
    total = 0
    for dtype, dims in _SHAPE_RE.findall(shape_str):
        if dtype not in _DTYPE_BYTES:
            continue
        n = 1
        for d in dims.split(","):
            if d:
                n *= int(d)
        total += n * _DTYPE_BYTES[dtype]
    return total


def _group_size(line: str) -> int:
    m = _GROUPS_RE.search(line)
    if m:
        return int(m.group(2))  # [ngroups, group_size]<=[...]
    m = _GROUPS_LIST_RE.search(line)
    if m:
        return len([x for x in m.group(1).split(",") if x.strip() != ""])
    return 2


@dataclasses.dataclass
class CollectiveStats:
    counts: dict
    result_bytes: dict
    wire_bytes: dict  # ring-model per-chip bytes on the wire

    @property
    def total_wire(self) -> float:
        return float(sum(self.wire_bytes.values()))

    @property
    def total_result(self) -> float:
        return float(sum(self.result_bytes.values()))

    def to_dict(self):
        return {
            "counts": self.counts,
            "result_bytes": self.result_bytes,
            "wire_bytes": self.wire_bytes,
            "total_wire_bytes": self.total_wire,
        }


def wire_bytes(op: str, b, g: int):
    """Per-chip bytes on the wire of one collective ``op`` (an HLO name:
    all-reduce, all-gather, reduce-scatter, all-to-all or
    collective-permute) whose local result is ``b`` bytes, over a group of
    ``g``: the ring model. ``parse_collectives`` and the dry run's trace
    (``launch.dryrun``) both count by it."""
    if op == "all-reduce":
        return 2 * b * (g - 1) / max(g, 1)
    if op == "all-gather":
        # result is the gathered (local-full) tensor; each chip receives
        # (g-1)/g of it
        return b * (g - 1) / max(g, 1)
    if op == "reduce-scatter":
        # result is the scattered shard; operand = g * result
        return b * (g - 1)
    if op == "all-to-all":
        return b * (g - 1) / max(g, 1)
    return b  # collective-permute


def parse_collectives(hlo_text: str) -> CollectiveStats:
    counts: dict = {}
    rbytes: dict = {}
    wbytes: dict = {}
    for line in hlo_text.splitlines():
        m = _COLL_RE.search(line)
        if not m:
            continue
        shape_str, op, started = m.group(1), m.group(2), m.group(3)
        if started and "-done" in line:
            continue
        b = _shape_bytes(shape_str)
        g = _group_size(line)
        wire = wire_bytes(op, b, g)
        counts[op] = counts.get(op, 0) + 1
        rbytes[op] = rbytes.get(op, 0) + b
        wbytes[op] = wbytes.get(op, 0) + wire
    return CollectiveStats(counts, rbytes, wbytes)


# ---------------------------------------------------------------------------
# Useful-FLOPs model (6·N·D / 2·N·D)
# ---------------------------------------------------------------------------


def count_params(cfg: ModelConfig) -> dict:
    """Parameter counts from the abstract init (meta tensors, no
    allocation)."""
    from repro_torch.train.steps import abstract_params

    aparams = abstract_params(cfg)
    total = tree_size(aparams)
    embed_table = cfg.vocab_size * cfg.d_model
    expert = 0
    if cfg.family == "moe":
        layers = aparams["layers"]
        moe = layers["moe"]
        expert = sum(
            int(np.prod(moe[k].shape)) for k in ("wg", "wu", "wo") if k in moe
        )
    return {"total": int(total), "embed_table": int(embed_table),
            "expert": int(expert)}


def model_flops(cfg: ModelConfig, shape: ShapeConfig) -> float:
    """MODEL_FLOPS: 6·N·D (train) / 2·N·D (inference) with N = active matmul
    params (MoE experts scaled by top-k/E; lookup-only embedding excluded),
    plus the quadratic attention term."""
    counts = count_params(cfg)
    n = counts["total"]
    if not cfg.tie_embeddings:
        n -= counts["embed_table"]  # lookup only; unembed stays
    if cfg.family == "moe" and cfg.num_experts:
        frac = cfg.num_experts_per_tok / cfg.num_experts
        n = n - counts["expert"] + counts["expert"] * frac
    if shape.mode == "decode":
        tokens = shape.global_batch  # one new token per sequence
        mult = 2.0
        attn_ctx = shape.seq_len
    elif shape.mode == "prefill":
        tokens = shape.global_batch * shape.seq_len
        mult = 2.0
        attn_ctx = shape.seq_len / 2  # causal average context
    else:
        tokens = shape.global_batch * shape.seq_len
        mult = 6.0
        attn_ctx = shape.seq_len / 2
    flops = mult * n * tokens
    # attention quadratic term: 4·ctx·H·hd per token per layer (QK^T + PV)
    if cfg.family in ("dense", "vlm", "audio", "moe"):
        att = 4.0 * attn_ctx * cfg.num_heads * cfg.resolved_head_dim * cfg.num_layers
        flops += (mult / 2.0) * att * tokens
    elif cfg.family == "hybrid":
        n_attn = cfg.num_layers // cfg.hybrid_attn_every
        att = 4.0 * attn_ctx * cfg.num_heads * cfg.resolved_head_dim * n_attn
        flops += (mult / 2.0) * att * tokens
    return float(flops)


# ---------------------------------------------------------------------------
# Roofline report
# ---------------------------------------------------------------------------


def roofline_terms(
    cost: dict,
    coll: CollectiveStats,
    chip: ChipSpec = V5E,
) -> dict:
    flops = float(cost.get("flops", 0.0))
    bytes_ = float(cost.get("bytes accessed", 0.0))
    compute_s = flops / chip.peak_bf16_flops
    memory_s = bytes_ / chip.hbm_bw
    collective_s = coll.total_wire / chip.ici_link_bw
    terms = {"compute_s": compute_s, "memory_s": memory_s,
             "collective_s": collective_s}
    dominant = max(terms, key=terms.get)
    bound = max(terms.values())
    total_lb = bound  # perfectly-overlapped lower bound
    return {
        **terms,
        "dominant": dominant,
        "step_lower_bound_s": total_lb,
        "hlo_flops_per_device": flops,
        "hlo_bytes_per_device": bytes_,
        "wire_bytes_per_device": coll.total_wire,
    }


def analyze(record: dict, cfg: ModelConfig, shape: ShapeConfig,
            chip: ChipSpec = V5E) -> dict:
    """record: dict with 'cost_analysis' + 'collectives' (from dryrun)."""
    coll = CollectiveStats(
        record["collectives"]["counts"],
        record["collectives"]["result_bytes"],
        record["collectives"]["wire_bytes"],
    )
    terms = roofline_terms(record["cost_analysis"], coll, chip)
    mf = model_flops(cfg, shape)
    chips = record.get("num_devices", 256)
    hlo_global = terms["hlo_flops_per_device"] * chips
    terms["model_flops_global"] = mf
    terms["hlo_flops_global"] = hlo_global
    terms["useful_flops_ratio"] = mf / hlo_global if hlo_global else 0.0
    # roofline fraction: useful work per second at the bound vs chip peak
    step_s = terms["step_lower_bound_s"]
    if step_s > 0:
        terms["roofline_fraction"] = (mf / chips / step_s) / chip.peak_bf16_flops
    else:
        terms["roofline_fraction"] = 0.0
    return terms
