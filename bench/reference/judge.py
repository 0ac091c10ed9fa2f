"""The numbers that decide ``correct``: each compares what the program
produced with what the reference works out from the same inputs.

Training (the first steps of the run, through the window's own call):
  loss_gap   the largest relative gap between the program's and the
             reference's loss, over the checked steps;
  grad_gap   over the slices (``tree.slices``), the worst gap between the
             program's and the reference's norm of the first clipped
             gradient, as a share of the reference's norm of that slice or
             of the median slice, whichever is larger;
  change_gap the same for the norm of each slice's change over the checked
             steps, leaving out the slices whose reference gradient is under
             a thousandth of the median slice's (they move by round-off
             alone under Adam);
  grad_gap_mean, change_gap_mean
             the mean of those gaps over the slices: steady from seed to
             seed where the worst slice is a small leaf whose norm sums
             terms that cancel (mamba2's A_log, dt_bias, conv_bc_b).
Prefill: served_gap, the widest gap by which a served first token's
reference logit lies below the reference's best logit at that position,
and served_gap_mean, the mean of those gaps over the served tokens
checked. A cell's limits file names the numbers it compares.
"""
from __future__ import annotations

import statistics

import torch

#: a slice whose reference gradient norm is under this share of the median
#: slice's moves by round-off alone: its change is not compared
STILL = 1e-3


def _gaps(prog: dict, ref: dict, names) -> list[float]:
    floor = statistics.median(ref.values())
    return [abs(prog[n] - ref[n]) / max(ref[n], floor, 1e-30) for n in names]


def worst(prog: dict, ref: dict, key: str, n: int = 3) -> list:
    """The ``n`` slices of the largest gaps in ``key`` ("grad" or
    "change"): [name, gap, program's norm, reference's norm]."""
    floor = statistics.median(ref[key].values())
    rows = [[k, abs(prog[key][k] - r) / max(r, floor, 1e-30), prog[key][k], r]
            for k, r in ref[key].items()]
    return sorted(rows, key=lambda row: -row[1])[:n]


def training(prog: dict, ref: dict) -> dict:
    loss_gap = max(abs(p - r) / abs(r) for p, r in zip(prog["loss"], ref["loss"]))
    if len(prog["loss"]) != len(ref["loss"]):
        loss_gap = float("nan")
    grad_floor = statistics.median(ref["grad"].values())
    moving = [n for n, g in ref["grad"].items() if g >= STILL * grad_floor]
    grad = _gaps(prog["grad"], ref["grad"], ref["grad"])
    change = _gaps(prog["change"], ref["change"], moving)
    return {"loss_gap": loss_gap, "grad_gap": max(grad), "change_gap": max(change),
            "grad_gap_mean": statistics.fmean(grad), "change_gap_mean": statistics.fmean(change)}


def served(gaps: torch.Tensor) -> dict:
    return {"served_gap": float(gaps.max()), "served_gap_mean": float(gaps.mean())}


def served_gaps(ref_logits: torch.Tensor, served: torch.Tensor) -> torch.Tensor:
    """ref_logits (N, V) at the served positions, served (N,) token ids ->
    (N,) gaps below the reference's best, each >= 0."""
    best = ref_logits.max(dim=-1).values
    return best - ref_logits.gather(-1, served.long()[:, None])[:, 0]
