"""Analytical cycle model + area/power model of the parameterized edge
accelerator (the paper's in-house cycle-accurate simulator stand-in).

Model (per layer-op, see models/convnets.LayerOp):
  * compute cycles: output pixels × ceil-tiled over the hardware parallelism —
    cout across (PEs × lanes), the k²·cin reduction across (SIMD × 4-way).
    Depthwise convs have no channel reduction, so the 4-way dot units idle
    (the paper's "regular conv up to 3x more efficient than depthwise" on
    EdgeTPU-class hardware emerges from exactly this term).
  * io cycles: weights + input + output bytes through io_bandwidth; weights
    re-streamed once per output tile pass when they exceed local memory.
  * latency = Σ max(compute, io) + fixed per-op overhead  (DMA overlap)
  * invalid configs (Sec 3.3 "the HAS space contains many invalid points"):
    register file too small for the SIMD working row, local memory smaller
    than the largest single tile, io starvation beyond 100x, or model weights
    exceeding 8x total on-chip memory (compiler refuses to tile).

Energy: per-MAC + per-DRAM-byte + leakage·latency. Area: per-component terms.
Calibration: the baseline config runs MobileNetV2 @224 in ≈0.30 ms / 0.70 mJ
(Table 3 row 2), and peaks at 26 int8-TOPS @ 0.8 GHz.

Everything is vectorized over layers (numpy), so labelling 500k cost-model
samples is cheap — the property the paper relies on.

Entry points:
  * ``simulate`` / ``simulate_safe`` — one (spec, h) pair per call (the legacy
    per-candidate path; raises / returns ``None`` on invalid configs).
  * ``simulate_batch`` — the batched path behind
    ``repro_torch.core.engine.EvaluationEngine``: evaluates N (spec, h) candidates
    in one pass of numpy over candidates × layers (candidates are grouped by
    layer count so no padding is needed) and is bitwise-identical to calling
    ``simulate_safe`` per candidate. See ``docs/architecture.md`` for how the
    search drivers reach this through the engine.
"""
from __future__ import annotations

from typing import Optional

import numpy as np

from repro_torch.common import FifoDict
from repro_torch.core.has import AcceleratorConfig
from repro_torch.models.convnets import ConvNetSpec, block_rows, layer_ops

# ---- calibrated constants (see module docstring) --------------------------
_MAC_PJ = 1.30  # pJ per int8 MAC (incl. local data movement)
_DRAM_PJ_PER_BYTE = 70.0
_SRAM_PJ_PER_BYTE = 6.0
_LEAKAGE_W_PER_MM2 = 0.012
_OP_OVERHEAD_CYCLES = 600.0  # per-op config/drain
_PIPELINE_EFF = 0.5  # issue/drain/tiling inefficiency vs ideal ceil model
_AREA = {  # mm^2 per unit
    "pe_base": 0.08,
    "lane": 0.06,
    "simd_unit": 0.0035,  # per 4-way MAC unit
    "rf_per_kb": 0.004,
    "mem_per_mb": 0.9,
    "io_per_gbps": 0.05,
    "base": 2.0,
}


class InvalidConfig(Exception):
    pass


def area_mm2(h: AcceleratorConfig) -> float:
    lanes = h.num_pes * h.compute_lanes
    return (
        _AREA["base"]
        + h.num_pes * _AREA["pe_base"]
        + lanes * _AREA["lane"]
        + lanes * h.simd_units * _AREA["simd_unit"]
        + lanes * h.register_file_kb * _AREA["rf_per_kb"]
        + h.num_pes * h.local_memory_mb * _AREA["mem_per_mb"]
        + h.io_bandwidth_gbps * _AREA["io_per_gbps"]
    )


BASELINE_AREA_MM2 = area_mm2(AcceleratorConfig())


def _layer_arrays(spec: ConvNetSpec) -> dict[str, np.ndarray]:
    ops = layer_ops(spec)
    f = lambda attr: np.array([getattr(o, attr) for o in ops])
    out_h = np.ceil(f("h") / f("stride"))
    out_w = np.ceil(f("w") / f("stride"))
    return {
        "is_dw": np.array([o.op == "dwconv" for o in ops]),
        "h": f("h"), "w": f("w"), "cin": f("cin"), "cout": f("cout"),
        "k": f("kernel"), "groups": f("groups"),
        "out_hw": out_h * out_w,
    }


def validate(h: AcceleratorConfig, weight_bytes: float) -> Optional[str]:
    """Returns a reason string when the (model, accelerator) pair is invalid."""
    # rf must hold two SIMD rows of int8 operands + accumulators
    rf_needed_kb = h.simd_units * h.simd_width * 6 / 1024
    if h.register_file_kb < rf_needed_kb:
        return f"register file {h.register_file_kb}KB < {rf_needed_kb:.1f}KB working set"
    if h.total_local_memory_bytes < 128 * 1024:
        return "local memory below minimum tile"
    if weight_bytes > 8 * h.total_local_memory_bytes and h.io_bandwidth_gbps < 10:
        return "model too large to stream at this io bandwidth"
    # pathological aspect ratios the compiler rejects
    if max(h.pes_x, h.pes_y) / min(h.pes_x, h.pes_y) > 4:
        return "unsupported PE aspect ratio"
    return None


def simulate(
    spec: ConvNetSpec,
    h: AcceleratorConfig,
    batch: int = 1,
    strict: bool = True,
) -> dict:
    """Returns {latency_ms, energy_mj, power_w, area_mm2, utilization} for one
    inference of ``spec`` (int8) on accelerator ``h``."""
    a = _layer_arrays(spec)
    is_dw = a["is_dw"]
    macs = np.where(
        is_dw,
        a["out_hw"] * a["cout"] * a["k"] ** 2,
        a["out_hw"] * a["cout"] * a["k"] ** 2 * a["cin"] / a["groups"],
    ) * batch

    weight_bytes = np.where(
        is_dw, a["k"] ** 2 * a["cout"],
        a["k"] ** 2 * (a["cin"] // a["groups"]) * a["cout"],
    )
    act_in_bytes = a["h"] * a["w"] * a["cin"] * batch
    act_out_bytes = a["out_hw"] * a["cout"] * batch

    reason = validate(h, float(weight_bytes.sum()))
    if reason is not None:
        if strict:
            raise InvalidConfig(reason)
        return {"invalid": reason}

    lanes = h.num_pes * h.compute_lanes
    # --- compute cycles (ceil-tiled) ---
    # outputs (spatial x cout) parallelize across lanes; the k^2*cin reduction
    # fills the SIMD 4-way dot units
    out_elems = a["out_hw"] * a["cout"] * batch
    red = a["k"] ** 2 * np.where(is_dw, 1, a["cin"] / a["groups"])
    inner_conv = np.ceil(red / (h.simd_units * h.simd_width))
    # depthwise: no channel reduction -> the 4-way dot units idle; channels
    # spread across lanes*SIMD, k^2 taps are sequential. This is exactly why
    # regular convs use this class of hardware ~3x more efficiently (Sec 3.2.2)
    dw_cycles = np.ceil(out_elems / (lanes * h.simd_units)) * a["k"] ** 2
    compute_cycles = np.where(
        is_dw,
        dw_cycles,
        np.ceil(out_elems / lanes) * inner_conv,
    )

    # --- io cycles ---
    # weights persist in local memory across inferences when the whole model
    # fits (<=75% of capacity) — this is what makes local_memory a real search
    # knob: big models on small-memory configs go weight-streaming and turn
    # io-bound ("larger models require a higher memory-to-compute ratio").
    local = h.total_local_memory_bytes
    weights_resident = float(weight_bytes.sum()) <= 0.75 * local
    passes = np.maximum(1.0, weight_bytes / max(local, 1.0))
    act_resident = (act_in_bytes + act_out_bytes)
    act_spill = np.maximum(0.0, act_resident - 0.5 * local)
    w_stream = np.zeros_like(weight_bytes) if weights_resident \
        else weight_bytes * passes
    dram_bytes = w_stream + act_spill
    io_cycles = dram_bytes / h.io_bytes_per_cycle

    # network-level io starvation (single io-bound layers like the classifier
    # FC are normal; a whole network >20x io-bound is a config the compiler
    # team would reject)
    if float(io_cycles.sum()) > 20.0 * float(compute_cycles.sum()):
        if strict:
            raise InvalidConfig("io-starved configuration (>20x compute)")
        return {"invalid": "io-starved"}

    compute_cycles = compute_cycles / _PIPELINE_EFF
    layer_cycles = np.maximum(compute_cycles, io_cycles) + _OP_OVERHEAD_CYCLES
    total_cycles = float(layer_cycles.sum())
    latency_s = total_cycles / (h.frequency_ghz * 1e9)

    area = area_mm2(h)
    dyn_j = (
        float(macs.sum()) * _MAC_PJ * 1e-12
        + float(dram_bytes.sum()) * _DRAM_PJ_PER_BYTE * 1e-12
        + float((act_in_bytes + act_out_bytes).sum()) * _SRAM_PJ_PER_BYTE * 1e-12
    )
    leak_j = _LEAKAGE_W_PER_MM2 * area * latency_s
    energy_j = dyn_j + leak_j

    peak_macs = h.macs_per_cycle * total_cycles
    return {
        "latency_ms": latency_s * 1e3,
        "energy_mj": energy_j * 1e3,
        "power_w": energy_j / latency_s,
        "area_mm2": area,
        "utilization": float(macs.sum()) / max(peak_macs, 1.0),
        "macs": float(macs.sum()),
        "dram_bytes": float(dram_bytes.sum()),
    }


def simulate_safe(spec: ConvNetSpec, h: AcceleratorConfig, batch: int = 1):
    """None-on-invalid variant (the search reward path)."""
    try:
        return simulate(spec, h, batch=batch, strict=True)
    except InvalidConfig:
        return None


# ---------------------------------------------------------------------------
# Batched path (the EvaluationEngine backend)
# ---------------------------------------------------------------------------
# Per-spec layer matrix: one float64 (9, L) array — transposed so that each
# row (one quantity across layers) is contiguous after np.stack — with rows
#   [is_dw, h, w, cin, cout, k, stride, groups, out_hw]
# All values are exact small integers (or products thereof < 2^53), so doing
# the arithmetic in float64 is bitwise-identical to the int64 arrays the
# per-candidate path builds in ``_layer_arrays``.
_ROW = {"is_dw": 0, "h": 1, "w": 2, "cin": 3, "cout": 4, "k": 5,
        "stride": 6, "groups": 7, "out_hw": 8}
# FIFO-bounded memos (repro_torch.common.FifoDict): at the cap the oldest entry is
# shed instead of dumping the whole working set
_MATRIX_CACHE: FifoDict = FifoDict(65536)
_SEG_CACHE: FifoDict = FifoDict(262144)  # (block, cin, size) -> (9, k) segment


# ---------------------------------------------------------------------------
# Hardware columns (shared by every batched entry point)
# ---------------------------------------------------------------------------
# Per-candidate hardware columns
#   [pes_x, pes_y, simd_units, compute_lanes, simd_width,
#    register_file_kb, io_bandwidth_gbps, frequency_ghz, local_memory_mb]
# as one (N, 9) float64 matrix. The attribute→row conversion is memoized per
# (frozen, hashable) AcceleratorConfig, so the cost of lowering a config is
# paid once and shared across backends — e.g. the cascade's lower-bound pass
# and the analytic refine pass read the same rows.
_HW_ROW_CACHE: FifoDict = FifoDict(65536)


def hw_matrix(hs: list) -> np.ndarray:
    """(N, 9) float64 hardware-column matrix for ``hs`` (see above)."""
    rows = []
    for h in hs:
        r = _HW_ROW_CACHE.get(h)
        if r is None:
            r = (h.pes_x, h.pes_y, h.simd_units, h.compute_lanes,
                 h.simd_width, h.register_file_kb, h.io_bandwidth_gbps,
                 h.frequency_ghz, h.local_memory_mb)
            _HW_ROW_CACHE[h] = r
        rows.append(r)
    return np.array(rows, np.float64).reshape(len(hs), 9)


def _np_seg(flat: list) -> np.ndarray:
    m8 = np.fromiter(flat, np.float64, len(flat)).reshape(-1, 8)
    seg = np.empty((9, m8.shape[0]), np.float64)
    seg[:8] = m8.T
    seg[8] = np.ceil(seg[1] / seg[6]) * np.ceil(seg[2] / seg[6])
    return seg


def layer_matrix(spec: ConvNetSpec) -> np.ndarray:
    """(9, L) float64 per-layer matrix for ``spec`` (cached; read-only).
    Assembled from per-(block, cin, size) cached segments: the build cost
    amortizes across candidates that share block configurations even when
    the full (α, h) vectors are all distinct."""
    m = _MATRIX_CACHE.get(spec)
    if m is not None:
        return m
    segs = []
    size = spec.image_size
    key = ("stem", size, spec.stem_filters)
    s = _SEG_CACHE.get(key)
    if s is None:
        s = _np_seg([0, size, size, 3, spec.stem_filters, 3, 2, 1])
        _SEG_CACHE[key] = s
    segs.append(s)
    size = (size + 1) // 2
    cin = spec.stem_filters
    for b in spec.blocks:
        key = (b, cin, size)
        s = _SEG_CACHE.get(key)
        if s is None:
            flat, _ = block_rows(b, cin, size)
            s = _np_seg(flat)
            _SEG_CACHE[key] = s
        segs.append(s)
        size = (size + b.stride - 1) // b.stride
        cin = b.filters
    key = ("head", size, cin, spec.head_filters, spec.num_classes)
    s = _SEG_CACHE.get(key)
    if s is None:
        s = _np_seg([0, size, size, cin, spec.head_filters, 1, 1, 1,
                     0, 1, 1, spec.head_filters, spec.num_classes, 1, 1, 1])
        _SEG_CACHE[key] = s
    segs.append(s)
    m = np.concatenate(segs, axis=1)
    _MATRIX_CACHE[spec] = m
    return m


def model_weight_bytes(spec: ConvNetSpec) -> float:
    """Total int8 weight bytes of ``spec`` (used for cheap validity checks)."""
    m = layer_matrix(spec)
    is_dw = m[0] != 0.0
    cin, cout, k, groups = m[3], m[4], m[5], m[7]
    wb = np.where(is_dw, k**2 * cout, k**2 * np.floor_divide(cin, groups) * cout)
    return float(wb.sum())


# ---------------------------------------------------------------------------
# Cheap lower bounds (the cascade backend's prefilter stage)
# ---------------------------------------------------------------------------
# Per-spec scalars reduce the (9, L) layer matrix to four numbers, so a batch
# of N candidates is bounded with O(N) vector arithmetic instead of the full
# O(N·L) candidates × layers pass. Every bound is a TRUE lower bound of the
# corresponding ``simulate`` output (each term drops only nonnegative
# contributions: ceil-tiling slack, per-layer max vs sum-of-max, weight
# re-streaming passes, per-layer activation spill vs aggregate spill), so a
# candidate whose bound already violates a cap is guaranteed infeasible.
_BOUND_CACHE: FifoDict = FifoDict(65536)


def bound_scalars(spec: ConvNetSpec) -> tuple:
    """(macs@batch1, weight_bytes, act_bytes@batch1, num_layers) for ``spec``
    (cached; the aggregate inputs of ``lower_bounds``)."""
    s = _BOUND_CACHE.get(spec)
    if s is not None:
        return s
    m = layer_matrix(spec)
    is_dw = m[0] != 0.0
    h_, w_, cin, cout, k, grp, out_hw = m[1], m[2], m[3], m[4], m[5], m[7], m[8]
    k2 = k**2
    macs = float(np.where(is_dw, out_hw * cout * k2,
                          out_hw * cout * k2 * cin / grp).sum())
    wb = float(np.where(is_dw, k2 * cout,
                        k2 * np.floor_divide(cin, grp) * cout).sum())
    act = float((h_ * w_ * cin + out_hw * cout).sum())
    s = (macs, wb, act, m.shape[1])
    _BOUND_CACHE[spec] = s
    return s


# relative safety margin: the aggregate bounds above are exact in real
# arithmetic; this absorbs float reassociation so a bound can never exceed
# the simulator's value by rounding alone
_BOUND_SLACK = 1.0 - 1e-9


def lower_bounds(specs: list, hs: list, batch: int = 1) -> dict:
    """Vectorized per-candidate lower bounds + static validity.

    Returns ``{"invalid": bool (N,), "latency_ms": (N,), "energy_mj": (N,),
    "area_mm2": (N,)}``. ``invalid`` mirrors ``validate()`` exactly (the
    static rules; io starvation needs the full model and is not checked).
    ``area_mm2`` is exact; latency/energy are guaranteed lower bounds of the
    ``simulate`` outputs for every candidate, valid or not.
    """
    n = len(specs)
    hw = hw_matrix(hs)
    sb = np.array([bound_scalars(s) for s in specs], np.float64).reshape(n, 4)
    macs = sb[:, 0] * batch
    wsum = sb[:, 1]
    act = sb[:, 2] * batch
    layers = sb[:, 3]

    pes_x, pes_y = hw[:, 0], hw[:, 1]
    simd_units, lanes_per_pe, simd_width = hw[:, 2], hw[:, 3], hw[:, 4]
    rf_kb, io_gbps = hw[:, 5], hw[:, 6]
    freq, local_mb = hw[:, 7], hw[:, 8]
    num_pes = pes_x * pes_y
    lanes = num_pes * lanes_per_pe
    local = num_pes * local_mb * 2**20
    io_bpc = io_gbps / freq

    area = (
        _AREA["base"]
        + num_pes * _AREA["pe_base"]
        + lanes * _AREA["lane"]
        + lanes * simd_units * _AREA["simd_unit"]
        + lanes * rf_kb * _AREA["rf_per_kb"]
        + num_pes * local_mb * _AREA["mem_per_mb"]
        + io_gbps * _AREA["io_per_gbps"]
    )

    rf_needed_kb = simd_units * simd_width * 6 / 1024
    invalid = (
        (rf_kb < rf_needed_kb)
        | (local < 128 * 1024)
        | ((wsum > 8 * local) & (io_gbps < 10))
        | (np.maximum(pes_x, pes_y) / np.minimum(pes_x, pes_y) > 4)
    )

    # compute: ideal peak utilization (every ceil rounds down to its argument)
    compute_lb = macs / (lanes * simd_units * simd_width)
    # io: weights stream at least once when not resident; per-layer spill sums
    # to at least the aggregate spill
    w_stream_lb = np.where(wsum <= 0.75 * local, 0.0, wsum)
    act_spill_lb = np.maximum(0.0, act - 0.5 * local * layers)
    dram_lb = w_stream_lb + act_spill_lb
    io_lb = dram_lb / io_bpc
    cycles_lb = np.maximum(compute_lb / _PIPELINE_EFF, io_lb) \
        + layers * _OP_OVERHEAD_CYCLES
    lat_s_lb = cycles_lb / (freq * 1e9) * _BOUND_SLACK

    dyn_lb = (
        macs * _MAC_PJ * 1e-12
        + dram_lb * _DRAM_PJ_PER_BYTE * 1e-12
        + act * _SRAM_PJ_PER_BYTE * 1e-12
    )
    energy_lb = (dyn_lb + _LEAKAGE_W_PER_MM2 * area * lat_s_lb) * _BOUND_SLACK

    return {
        "invalid": invalid,
        "latency_ms": lat_s_lb * 1e3,
        "energy_mj": energy_lb * 1e3,
        "area_mm2": area,
    }


def simulate_batch(
    specs: list,
    hs: list,
    batch: int = 1,
) -> list:
    """Vectorized ``simulate_safe`` over N (spec, h) candidates.

    Returns a list of N entries, each either the same metrics dict ``simulate``
    produces or ``None`` for invalid candidates. Candidates are grouped by
    layer count and evaluated with one pass of numpy over candidates × layers;
    results are bitwise-identical to the per-candidate loop (same operations,
    same order, same reduction lengths).
    """
    n = len(specs)
    assert len(hs) == n
    if n == 0:
        return []
    results: list = [None] * n

    # per-candidate hardware columns (hw_matrix, memoized per config);
    # derived quantities are computed in numpy with the same expressions
    # (and order) as the AcceleratorConfig properties, so values are
    # bitwise-identical to the per-candidate path
    hw = hw_matrix(hs)
    pes_x, pes_y = hw[:, 0], hw[:, 1]
    simd_units, lanes_per_pe, simd_width = hw[:, 2], hw[:, 3], hw[:, 4]
    rf_kb, io_gbps = hw[:, 5], hw[:, 6]
    freq, local_mb = hw[:, 7], hw[:, 8]
    num_pes = pes_x * pes_y
    lanes = num_pes * lanes_per_pe
    local = num_pes * local_mb * 2**20  # total_local_memory_bytes
    io_bpc = io_gbps / freq             # io_bytes_per_cycle

    # area (mirrors area_mm2 term-for-term so results stay bitwise-equal)
    area = (
        _AREA["base"]
        + num_pes * _AREA["pe_base"]
        + lanes * _AREA["lane"]
        + lanes * simd_units * _AREA["simd_unit"]
        + lanes * rf_kb * _AREA["rf_per_kb"]
        + num_pes * local_mb * _AREA["mem_per_mb"]
        + io_gbps * _AREA["io_per_gbps"]
    )

    groups_by_len: dict[int, list[int]] = {}
    mats = [layer_matrix(s) for s in specs]
    for i, m in enumerate(mats):
        groups_by_len.setdefault(m.shape[1], []).append(i)

    for _, idxs in groups_by_len.items():
        ix = np.asarray(idxs)
        M = np.stack([mats[i] for i in idxs])  # (g, 9, L)
        is_dw = M[:, 0] != 0.0
        h_, w_ = M[:, 1], M[:, 2]
        cin, cout = M[:, 3], M[:, 4]
        k, grp = M[:, 5], M[:, 7]
        out_hw = M[:, 8]

        g_lanes = lanes[ix][:, None]
        g_simd_units = simd_units[ix][:, None]
        g_simd_cap = (simd_units[ix] * simd_width[ix])[:, None]
        g_local = local[ix][:, None]
        g_io_bpc = io_bpc[ix][:, None]

        # common subexpressions are hoisted verbatim (same ops on the same
        # inputs as the per-candidate path → bitwise-identical results)
        k2 = k**2
        ohw_cout_k2 = out_hw * cout * k2
        macs = np.where(
            is_dw,
            ohw_cout_k2,
            ohw_cout_k2 * cin / grp,
        ) * batch
        weight_bytes = np.where(
            is_dw, k2 * cout,
            k2 * np.floor_divide(cin, grp) * cout,
        )
        act_in_bytes = h_ * w_ * cin * batch
        act_out_bytes = out_hw * cout * batch
        wsum = weight_bytes.sum(axis=1)

        # --- validity (mirrors validate()) ---
        rf_needed_kb = simd_units[ix] * simd_width[ix] * 6 / 1024
        invalid = (
            (rf_kb[ix] < rf_needed_kb)
            | (local[ix] < 128 * 1024)
            | ((wsum > 8 * local[ix]) & (io_gbps[ix] < 10))
            | (np.maximum(pes_x[ix], pes_y[ix])
               / np.minimum(pes_x[ix], pes_y[ix]) > 4)
        )

        # --- compute cycles ---
        out_elems = act_out_bytes  # same expression: out_hw * cout * batch
        red = k2 * np.where(is_dw, 1, cin / grp)
        inner_conv = np.ceil(red / g_simd_cap)
        dw_cycles = np.ceil(out_elems / (g_lanes * g_simd_units)) * k2
        compute_cycles = np.where(
            is_dw, dw_cycles, np.ceil(out_elems / g_lanes) * inner_conv
        )

        # --- io cycles ---
        weights_resident = wsum <= 0.75 * local[ix]
        passes = np.maximum(1.0, weight_bytes / np.maximum(g_local, 1.0))
        act_resident = act_in_bytes + act_out_bytes
        act_spill = np.maximum(0.0, act_resident - 0.5 * g_local)
        w_stream = np.where(weights_resident[:, None], 0.0,
                            weight_bytes * passes)
        dram_bytes = w_stream + act_spill
        io_cycles = dram_bytes / g_io_bpc

        io_sum = io_cycles.sum(axis=1)
        compute_sum_raw = compute_cycles.sum(axis=1)
        starved = io_sum > 20.0 * compute_sum_raw
        invalid = invalid | starved

        compute_cycles = compute_cycles / _PIPELINE_EFF
        layer_cycles = np.maximum(compute_cycles, io_cycles) + \
            _OP_OVERHEAD_CYCLES
        total_cycles = layer_cycles.sum(axis=1)
        latency_s = total_cycles / (freq[ix] * 1e9)

        macs_sum = macs.sum(axis=1)
        dram_sum = dram_bytes.sum(axis=1)
        act_sum = act_resident.sum(axis=1)  # act_in_bytes + act_out_bytes
        dyn_j = (
            macs_sum * _MAC_PJ * 1e-12
            + dram_sum * _DRAM_PJ_PER_BYTE * 1e-12
            + act_sum * _SRAM_PJ_PER_BYTE * 1e-12
        )
        g_area = area[ix]
        leak_j = _LEAKAGE_W_PER_MM2 * g_area * latency_s
        energy_j = dyn_j + leak_j

        macs_per_cycle = num_pes[ix] * lanes_per_pe[ix] * simd_units[ix] \
            * simd_width[ix]
        peak_macs = macs_per_cycle * total_cycles
        util = macs_sum / np.maximum(peak_macs, 1.0)

        latency_ms = latency_s * 1e3
        energy_mj = energy_j * 1e3
        power_w = energy_j / latency_s
        for row, i in enumerate(idxs):
            if invalid[row]:
                continue
            results[i] = {
                "latency_ms": float(latency_ms[row]),
                "energy_mj": float(energy_mj[row]),
                "power_w": float(power_w[row]),
                "area_mm2": float(g_area[row]),
                "utilization": float(util[row]),
                "macs": float(macs_sum[row]),
                "dram_bytes": float(dram_sum[row]),
            }
    return results
