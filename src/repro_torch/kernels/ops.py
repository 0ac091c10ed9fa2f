"""Dispatch for the model code, which calls these and never a kernel
directly. A tensor on the CPU takes the plain version (``ref``); a CUDA
tensor launches the hand-written kernel, or raises when it cannot (no
``nvcc``, a failed build, a device below compute capability 9.0). Nothing
falls back from the kernel to the plain version. Counterpart of
``repro/kernels/ops.py``."""
from __future__ import annotations

from typing import Optional

import torch

from repro_torch.kernels import ibn_conv


def ibn_pointwise(x: torch.Tensor, w: torch.Tensor, b: Optional[torch.Tensor],
                  *, act: str = "relu") -> torch.Tensor:
    """``act(x @ w + b)`` with its gradient: x (N, Cin), w (Cin, Cout),
    b (Cout,) or None for no bias; act in {"relu", "silu", "none"}."""
    if x.device.type not in ("cpu", "cuda"):
        raise ValueError(f"ibn_pointwise runs on cpu or cuda, not {x.device}")
    return ibn_conv.ibn_pointwise(x, w, b, act=act)
