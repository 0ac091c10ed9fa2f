"""Plain PyTorch versions of the port's kernels: the ground truth each
hand-written kernel is held against on the card, and what the wrappers run
for tensors that lie on the CPU. Counterpart of ``repro/kernels/ref.py``."""
from __future__ import annotations

from typing import Optional

import torch
import torch.nn.functional as F


def ibn_pointwise_ref(x, w, b: Optional[torch.Tensor] = None,
                      act: str = "relu") -> torch.Tensor:
    """1x1 conv + bias + activation. x: (N, Cin), w: (Cin, Cout), b: (Cout,)
    or None for no bias. fp32 math, then a cast to ``x.dtype``."""
    y = x.float() @ w.float()
    if b is not None:
        y = y + b.float()
    if act == "relu":
        y = F.relu(y)
    elif act == "silu":
        y = F.silu(y)
    return y.to(x.dtype)
