"""The planning of K3's backward on the Python side (``ssd_scan.bwd_plan``):
the slices of each group's heads that the chunk launch's items sum over,
and the workspace the launches take, against values worked out by hand.
No card and no build: the plan is arithmetic on shapes (the card test
``test_ssd_scan_bwd_plan_is_what_the_launcher_takes`` holds the workspace
against the kernels' own count)."""
from __future__ import annotations

import sys
from pathlib import Path

import pytest

sys.path.insert(0, str(Path(__file__).resolve().parents[1] / "src"))

from repro_torch.kernels import ssd_scan  # noqa: E402


def _workspace(b, s, h, g, n, q, slices):
    """The workspace by hand, region by region, each rounded up to 1 KiB."""
    nc, qp = -(-s // q), -(-q // 64) * 64
    nw = 64 if n <= 64 else 128
    regions = (b * h * nc * qp * 16,              # a float4 a position
               b * h * nc * 2 * 64 * nw * 4,      # h_in and dh_out slots
               3 * b * h * nc * qp * 8,           # the cumsum cotangent's parts and w
               b * h * nc * 4 * 8,                # <h_in, dh_out>'s warp partials
               2 * slices * b * s * g * n * 4 if slices > 1 else 0)
    return sum(-(-r // 1024) * 1024 for r in regions)


# (shape, slices, heads a slice, chunk items, workspace bytes), by hand:
# - mamba2-370m's training shape: 8 x 1 x 4 chunks x 4 tiles = 128 items of
#   one slice already fill 132 SMs in one wave, and every divisor of 32
#   heads ties at 32 heads' waves, so the fewest, 1 (no partials):
#   4,194,304 + 67,108,864 + 6,291,456 + 32,768 bytes;
# - zamba2-7b's scan: 2 x 1 x 2 x 4 = 16 base items; d slices of 112 heads
#   take ceil(16 d / 132) x 112 / d waves: 112, 56, 28, 16 (d 7), 14 (d 8),
#   16 (d 14), 14 (d 16), ... so 8 slices of 14 heads, 128 items, and dB's
#   and dC's fp32 partials (2 x 8 x 2 x 512 x 64 x 4 bytes);
# - a chunk of 4096 (64 tiles): 64 base items, 2 heads: 1 slice takes 2
#   waves of a head, 2 slices 1: 2 slices, 128 items.
PLANS = [((8, 1024, 32, 64, 1, 128, 256), 1, 32, 128, 77_627_392),
         ((2, 512, 112, 64, 1, 64, 256), 8, 14, 128, 23_476_224),
         ((1, 4096, 2, 64, 1, 128, 4096), 2, 1, 128, 8_848_384)]


@pytest.mark.parametrize("shape,slices,heads,items,workspace", PLANS)
def test_bwd_plan_matches_the_values_worked_out_by_hand(shape, slices, heads, items, workspace):
    b, s, h, p, g, n, chunk = shape
    pl = ssd_scan.bwd_plan(b, s, h, p, g, n, chunk)
    assert (pl.slices, pl.heads, pl.items, pl.workspace) == (slices, heads, items, workspace)
    assert pl.workspace == _workspace(b, s, h, g, n, min(chunk, s), slices)
    assert pl.tiles == -(-min(chunk, s) // 64) and pl.chunks == -(-s // min(chunk, s))


def test_bwd_workspace_is_at_most_forty_percent_of_the_five_launch_one():
    """At the training shape the five launches took 339 MB (per-chunk
    states, the cumsum's parts and dB and dC per head in fp32); the plan
    holds no (B, S, H, N) buffer and stays within 40% of that."""
    b, s, h, p, g, n, chunk = PLANS[0][0]
    nc = s // chunk
    five = 4 * (4 * b * h * nc * chunk + 2 * b * h * nc * p * n + 2 * b * s * h * n + b * nc * h)
    assert five == 339_742_720
    assert ssd_scan.bwd_plan(b, s, h, p, g, n, chunk).workspace <= 0.4 * five


def test_bwd_plan_slices_override_and_refusals():
    pl = ssd_scan.bwd_plan(8, 1024, 32, 64, 1, 128, 256, slices=4)
    assert (pl.slices, pl.heads, pl.items) == (4, 8, 512)
    assert pl.workspace == _workspace(8, 1024, 32, 1, 128, 256, 4)
    for bad in (dict(slices=0), dict(slices=33)):
        with pytest.raises(ValueError):
            ssd_scan.bwd_plan(8, 1024, 32, 64, 1, 128, 256, **bad)
    with pytest.raises(ValueError):  # 3 slices of 2 heads leave the third empty
        ssd_scan.bwd_plan(1, 64, 4, 16, 1, 16, 64, slices=3)
    with pytest.raises(ValueError):
        ssd_scan.bwd_plan(1, 64, 4, 65, 1, 16, 64)  # head_dim over 64
    with pytest.raises(ValueError):
        ssd_scan.bwd_plan(1, 64, 4, 16, 3, 16, 64)  # G does not divide H
    assert ssd_scan.BWD_LAUNCHES == 3
