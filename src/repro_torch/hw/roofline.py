"""Pod-level roofline cost backend: the three-term (compute / HBM /
collective) analytical step-time model behind the ``CostBackend`` protocol.
The port's counterpart of ``repro/hw/roofline.py``, copied op for op, so its
records are bitwise-equal to the reference's.

It adapts the ``repro_torch.launch`` roofline machinery (``ChipSpec``
targets from ``launch.hwspecs``, parameter counting from
``launch.roofline``) for the pod mesh search (``repro_torch.core.meshsearch``):
the "hardware config" is a mesh/parallelism dict (data×model factorization,
microbatches, remat, FSDP, activation-collective style, gradient dtype) and
the "spec" is the (ModelConfig, ShapeConfig) workload — frozen into the
backend, like a has-mode engine's ``fixed_spec``. The analytical model is a
deliberately simple Megatron-style napkin model: it RANKS configurations.
It is host arithmetic over the parameter counts of a shape-only init: no
tensor is allocated and nothing runs on a device.

Records carry the roofline terms (``compute_s``/``memory_s``/
``collective_s``/``step_s``, HBM footprint, MFU) plus ``latency_ms``
(= step time) so they read uniformly with the edge-accelerator backends.
Identity is content-based (model/shape/chip/chips), so shared stores stay
sound across processes.
"""
from __future__ import annotations

import dataclasses
from typing import Optional, Sequence

from repro_torch.config import ModelConfig, ShapeConfig
from repro_torch.hw.backend import CostBackend, HwMetrics
from repro_torch.launch.hwspecs import V5E, ChipSpec


@dataclasses.dataclass
class PodRooflineBackend(CostBackend):
    """Three-term roofline over pod mesh configs (see module docstring)."""

    cfg: ModelConfig
    shape: ShapeConfig
    chip: ChipSpec = V5E
    chips: int = 256
    _counts: Optional[tuple] = dataclasses.field(default=None, init=False, repr=False,
                                                 compare=False)

    name = "pod-roofline"
    fidelity = "roofline"
    exact = False
    metrics = ("latency_ms",)

    def cache_key(self) -> str:
        return (
            f"pod-roofline({self.cfg.name}/{self.shape.mode}"
            f"@{self.chip.name}x{self.chips};{repr(self.shape)})"
        )

    def _param_count(self) -> tuple[float, float]:
        """(total params, active params), counted once per backend: a
        search evaluates one workload over and over, and each count is a
        shape-only init of the whole model."""
        if self._counts is None:
            self._counts = self._count()
        return self._counts

    def _count(self) -> tuple[float, float]:
        from repro_torch.launch.roofline import count_params

        c = count_params(self.cfg)
        total = c["total"]
        active = total
        if self.cfg.family == "moe" and self.cfg.num_experts:
            frac = self.cfg.num_experts_per_tok / self.cfg.num_experts
            active = total - c["expert"] + c["expert"] * frac
        return float(total), float(active)

    def evaluate(self, h: dict) -> Optional[dict]:
        """One mesh config → roofline terms dict (None when the config is
        infeasible: indivisible microbatching or HBM overflow)."""
        cfg, shape, chip = self.cfg, self.shape, self.chip
        dsz, msz = h["mesh"]
        k = h["microbatches"]
        tokens = shape.global_batch * shape.seq_len
        if shape.global_batch % (dsz * k) and shape.global_batch >= dsz * k:
            return None  # microbatch split must divide the per-data batch
        if shape.global_batch < dsz and shape.global_batch != 1:
            return None
        total_p, active_p = self._param_count()

        # ---- memory check (bytes/chip) ----
        p_local = total_p * 4 / min(self.chips, msz * (dsz if h["fsdp"] else 1))
        opt_local = 2 * p_local
        tok_local = tokens / max(dsz, 1) / k
        act_per_layer = tok_local * cfg.d_model * 2
        n_live = 1
        if shape.mode == "train":
            live = {"none": cfg.num_layers, "dots": cfg.num_layers / 2, "full": 1}
            n_live = live[h["remat"]]
        act_bytes = act_per_layer * max(n_live, 1) * 8
        hbm = p_local + opt_local + act_bytes + act_per_layer * cfg.num_layers
        if hbm > chip.hbm_bytes * 0.9:
            return None

        # ---- compute term ----
        mult = {"train": 6.0, "prefill": 2.0, "decode": 2.0}[shape.mode]
        if shape.mode == "train" and h["remat"] == "full":
            mult = 8.0
        elif shape.mode == "train" and h["remat"] == "dots":
            mult = 7.0
        eff_tokens = tokens if shape.mode != "decode" else shape.global_batch
        flops = mult * active_p * eff_tokens / self.chips
        compute_s = flops / chip.peak_bf16_flops

        # ---- memory term ----
        reads = 3.0 if shape.mode == "train" else 1.0
        mem_bytes = p_local * reads * (k if h["fsdp"] else 1) + act_bytes * 4
        memory_s = mem_bytes / chip.hbm_bw

        # ---- collective term (per chip wire bytes) ----
        act_msg = tok_local * cfg.d_model * 2  # bf16
        n_coll_layers = cfg.num_layers * (2 if shape.mode != "train" else 6)
        ar = 2 * (msz - 1) / msz if msz > 1 else 0.0
        if h["act_collective"] == "seqpar":
            ar *= 0.5  # reduce-scatter + all-gather instead of all-reduce
        wire = act_msg * n_coll_layers * ar * k
        if h["fsdp"] and dsz > 1:
            wire += total_p * 2 / msz * (dsz - 1) / dsz * k  # bf16 weight gathers
        if shape.mode == "train" and dsz > 1:
            gb = 4.0 if h["grad_dtype"] == "float32" else 2.0
            wire += total_p * gb / msz * 2 * (dsz - 1) / dsz  # grad all-reduce
        collective_s = wire / chip.ici_link_bw

        step = max(compute_s, memory_s, collective_s)
        mfu_mult = mult if shape.mode != "train" else 6.0
        useful = mfu_mult * active_p * eff_tokens / self.chips
        return {
            "compute_s": compute_s,
            "memory_s": memory_s,
            "collective_s": collective_s,
            "step_s": step,
            "latency_ms": step * 1e3,
            "hbm_bytes": hbm,
            "valid": True,
            "mfu": useful / max(step, 1e-12) / chip.peak_bf16_flops,
        }

    def estimate_batch(
        self,
        specs: Sequence,
        hs: Sequence,
        batch: int = 1,
        vecs=None,
        accs=None,
    ) -> HwMetrics:
        """Protocol entry point: ``hs`` are mesh-config dicts; ``specs``
        entries are ignored (the workload is frozen into the backend)."""
        records = [self.evaluate(h) for h in hs]
        return HwMetrics(records=records, fidelity=self.fidelity)
