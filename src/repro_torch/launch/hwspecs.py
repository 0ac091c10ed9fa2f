"""The pod target of the reference's roofline: ``ChipSpec``, ``V5E`` and
``PODS``, copied field for field from ``repro/launch/hwspecs.py``.

These constants describe the chip the reference prices its pod meshes for,
not the card the port runs on. They stay the reference's, because the
scenario grid's latency targets (``core.scenarios.grid``) and the mesh
search's step times (``core.meshsearch``) are defined by them: both
implementations must name and price the same scenarios.
"""
from __future__ import annotations

import dataclasses


@dataclasses.dataclass(frozen=True)
class ChipSpec:
    name: str = "tpu-v5e"
    peak_bf16_flops: float = 197e12  # FLOP/s
    hbm_bw: float = 819e9  # bytes/s
    hbm_bytes: int = 16 * 1024**3
    ici_link_bw: float = 50e9  # bytes/s per link (one active link modelled)
    dcn_bw: float = 25e9  # bytes/s per host for cross-pod traffic


V5E = ChipSpec()

PODS = {"single": 256, "multi": 512}
