"""Dispatch for the model code, which calls these and never a kernel
directly. A tensor on the CPU takes the plain version (``ref``); a CUDA
tensor launches the hand-written kernel, or raises when it cannot (no
``nvcc``, a failed build, a device below compute capability 9.0). Nothing
falls back from the kernel to the plain version. Counterpart of
``repro/kernels/ops.py``."""
from __future__ import annotations

from typing import Optional

import torch

from repro_torch.kernels import flash_attention as _flash
from repro_torch.kernels import gmm as _gmm
from repro_torch.kernels import ibn_conv
from repro_torch.kernels import ssd_scan as _ssd


def ibn_pointwise(x: torch.Tensor, w: torch.Tensor, b: Optional[torch.Tensor],
                  *, act: str = "relu") -> torch.Tensor:
    """``act(x @ w + b)`` with its gradient: x (N, Cin), w (Cin, Cout),
    b (Cout,) or None for no bias; act in {"relu", "silu", "none"}."""
    if x.device.type not in ("cpu", "cuda"):
        raise ValueError(f"ibn_pointwise runs on cpu or cuda, not {x.device}")
    return ibn_conv.ibn_pointwise(x, w, b, act=act)


def flash_attention(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, *,
                    causal: bool = True) -> torch.Tensor:
    """Attention in the model's layout: q (B, S, H, hd), k/v (B, T, KV, hd)
    -> (B, S, H, hd). The train/prefill shapes only: decode, with its
    ``q_offset``/``kv_len`` against a preallocated cache, goes to
    ``models.layers.chunked_attention``, as in the reference."""
    if q.device.type not in ("cpu", "cuda"):
        raise ValueError(f"flash_attention runs on cpu or cuda, not {q.device}")
    out = _flash.flash_attention(q.transpose(1, 2), k.transpose(1, 2), v.transpose(1, 2),
                                 causal=causal)
    return out.transpose(1, 2)


def ssd_scan(x: torch.Tensor, dt: torch.Tensor, A: torch.Tensor, B: torch.Tensor,
             C: torch.Tensor, *, chunk: int) -> tuple[torch.Tensor, torch.Tensor]:
    """The Mamba2 SSD chunk scan: x (B,S,H,P), dt (B,S,H) fp32, A (H,),
    B/C (B,S,G,N) -> (y (B,S,H,P) in x's dtype, final state (B,H,P,N) fp32),
    in chunks of ``min(chunk, S)`` positions as ``models.ssm`` takes them."""
    if x.device.type not in ("cpu", "cuda"):
        raise ValueError(f"ssd_scan runs on cpu or cuda, not {x.device}")
    return _ssd.ssd_scan(x, dt, A, B, C, chunk=chunk)


def gmm(x: torch.Tensor, w: torch.Tensor) -> torch.Tensor:
    """The grouped matmul ``y[e] = x[e] @ w[e]``: x (E,C,D), w (E,D,F) ->
    (E,C,F) in x's dtype, fp32 accumulation."""
    if x.device.type not in ("cpu", "cuda"):
        raise ValueError(f"gmm runs on cpu or cuda, not {x.device}")
    return _gmm.gmm(x, w)
