"""The Hardware Accelerator Search space (paper Table 1) and the accelerator
configuration object.

Baseline (Sec. 3.3): 4×4 PEs, 2 MB local memory per PE, 4 compute lanes,
32 KB register file per lane, 64 4-way-SIMD units per lane ⇒ peak
4·4·4·64·4 = 16384 MACs/cycle × 0.8 GHz = 26.2 int8-TOPS — matching the
paper's "26 TOPS/s at 0.8 GHz".
"""
from __future__ import annotations

import dataclasses

import numpy as np

from repro_torch.core.space import Choice, Space


@dataclasses.dataclass(frozen=True)
class AcceleratorConfig:
    pes_x: int = 4
    pes_y: int = 4
    simd_units: int = 64
    compute_lanes: int = 4
    local_memory_mb: float = 2.0
    register_file_kb: int = 32
    io_bandwidth_gbps: float = 20.0
    frequency_ghz: float = 0.8
    simd_width: int = 4  # 4-way int8 dot product per SIMD unit

    @property
    def num_pes(self) -> int:
        return self.pes_x * self.pes_y

    @property
    def macs_per_cycle(self) -> int:
        return (self.num_pes * self.compute_lanes * self.simd_units
                * self.simd_width)

    @property
    def peak_tops(self) -> float:
        return 2 * self.macs_per_cycle * self.frequency_ghz / 1e3

    @property
    def total_local_memory_bytes(self) -> float:
        return self.num_pes * self.local_memory_mb * 2**20

    @property
    def io_bytes_per_cycle(self) -> float:
        # GB/s (DMA-class bandwidth, per the latency targets in Table 3)
        return self.io_bandwidth_gbps / self.frequency_ghz


BASELINE = AcceleratorConfig()

# Table 1, verbatim.
TABLE1 = {
    "pes_x": (1, 2, 4, 6, 8),
    "pes_y": (1, 2, 4, 6, 8),
    "simd_units": (16, 32, 64, 128),
    "compute_lanes": (1, 2, 4, 8),
    "local_memory_mb": (0.5, 1, 2, 3, 4),
    "register_file_kb": (8, 16, 32, 64, 128),
    "io_bandwidth_gbps": (5.0, 10.0, 15.0, 20.0, 25.0),
}


def has_space() -> Space:
    choices = [Choice(k, tuple(v)) for k, v in TABLE1.items()]
    space = Space(choices, decoder=lambda d: AcceleratorConfig(**d), name="has")
    # provenance makes the space picklable (rebuilt via this factory in the
    # receiving process — see space.Space.provenance)
    space.provenance = (f"{__name__}:has_space", {})
    return space


def baseline_vec(space: Space) -> np.ndarray:
    vals = dataclasses.asdict(BASELINE)
    return np.array(
        [c.options.index(vals[c.name]) for c in space.choices], np.int32
    )
