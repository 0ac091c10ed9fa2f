"""The least time, in ms, of each kernel's work: (bytes over the memory
rate, operations over the peak rate). ``ssd_bound_parts_ms`` and
``ssd_bwd_bound_parts_ms`` are frozen copies from ``chip_smoke.py`` at
commit cbce191; ``gmm_routed_parts_ms`` is its ``gmm_bound_parts_ms``
counted over the routed assignments instead of the full capacity buckets.
A launch's least time is the larger of its two parts."""
from __future__ import annotations

import torch

from bench.yardstick.peaks import HBM_BYTES_PER_S, PEAK_FLOP_PER_S


def ssd_bound_parts_ms(b, s, h, p, g, n, chunk, dtype) -> tuple[float, float]:
    """The two lower bounds of one chunk scan in ms: bytes (x, dt, A, B, C
    read once, y and the fp32 final state written once) over the memory
    rate; and the operations the chunked algorithm needs over the peak rate
    for the input type: per chunk of L positions, C·Bᵀ and its product with
    x·dt over the L(L+1)/2 pairs at or below the diagonal (2(N + P)
    operations each), C·stateᵀ and the state update (4PN per position)."""
    itemsize = torch.empty((), dtype=dtype).element_size()
    nbytes = (itemsize * (2 * b * s * h * p + 2 * b * s * g * n)
              + 4 * (b * s * h + h + b * h * p * n))
    q = min(chunk, s)
    ops = sum(2 * (n + p) * (ln * (ln + 1) // 2) + 4 * p * n * ln
              for ln in (min(q, s - r0) for r0 in range(0, s, q)))
    return (nbytes / HBM_BYTES_PER_S * 1e3,
            float(b * h * ops) / PEAK_FLOP_PER_S[dtype] * 1e3)


def ssd_bwd_bound_parts_ms(b, s, h, p, g, n, chunk, dtype) -> tuple[float, float]:
    """The two lower bounds of one chunk scan's backward in ms: bytes (x, dy,
    B, C, dt, A read once; dx, dB, dC, dt's and A's gradients written once)
    over the memory rate; and the operations the plain backward's products
    need under the causal mask over the peak rate for the input type: per
    chunk of L positions, its five Q·Q products over the L(L+1)/2 pairs at
    or below the diagonal (2(3N + 2P) operations each) and six state
    products (12PN per position)."""
    itemsize = torch.empty((), dtype=dtype).element_size()
    nbytes = itemsize * (3 * b * s * h * p + 4 * b * s * g * n) + 4 * (2 * b * s * h + 2 * h)
    q = min(chunk, s)
    ops = sum(2 * (3 * n + 2 * p) * (ln * (ln + 1) // 2) + 12 * p * n * ln
              for ln in (min(q, s - r0) for r0 in range(0, s, q)))
    return (nbytes / HBM_BYTES_PER_S * 1e3,
            float(b * h * ops) / PEAK_FLOP_PER_S[dtype] * 1e3)


def gmm_routed_parts_ms(a, e, d, f, dtype) -> tuple[float, float]:
    """The two lower bounds of one grouped product over ``a`` routed
    assignments in ms: bytes (the assignments' rows of x read once, the
    ``e`` experts' (d, f) weights read once, their rows of y written once)
    over the memory rate, and 2·a·d·f operations over the peak rate. The
    same count serves the backward's products (dx: dy and w read, dx
    written; dw: x and dy read, dw written)."""
    itemsize = torch.empty((), dtype=dtype).element_size()
    nbytes = itemsize * (a * d + e * d * f + a * f)
    return (nbytes / HBM_BYTES_PER_S * 1e3,
            2.0 * a * d * f / PEAK_FLOP_PER_S[dtype] * 1e3)


def least_ms(parts: tuple[float, float]) -> float:
    return max(parts)
