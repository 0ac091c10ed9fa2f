"""GPipe-style pipeline parallelism over a mesh "stage" axis. Counterpart of
``repro/parallel/pipeline.py``.

The classic schedule: stage s runs microbatch m at tick t = s + m, and
activations hop stage -> stage+1 each tick (one ``batch_isend_irecv``
exchange). Bubble fraction = (S-1)/(S-1+M), so callers pick M >> S. Each
rank holds only its own stage's slice of the stacked parameters, as the
reference's ``shard_map`` body sees them.
"""
from __future__ import annotations

from typing import Callable

import torch
import torch.distributed as dist
from torch.distributed.tensor import DTensor

from repro_torch.common import tree_map


def pipeline_apply(
    stage_fn: Callable,  # (stage_params, x) -> y  (same shape)
    params_stacked,  # tree of this stage's slices (1, ...): DTensors sharded by stage, or local
    x: torch.Tensor,  # (M, mb, ...) microbatched input, the same on every rank
    mesh,
    stage_axis: str = "stage",
) -> torch.Tensor:
    """Runs x through all S stages; returns (M, mb, ...) outputs on every
    rank (broadcast from the last stage)."""
    group = mesh.get_group(stage_axis)
    n_stages = mesh.size(mesh.mesh_dim_names.index(stage_axis))
    sid = mesh.get_local_rank(stage_axis)
    ranks = dist.get_process_group_ranks(group)

    lp = tree_map(lambda p: (p.to_local() if isinstance(p, DTensor) else p)[0], params_stacked)
    m = x.shape[0]
    buf = torch.zeros_like(x[0])
    out = torch.zeros_like(x)
    for t in range(m + n_stages - 1):
        # stage 0 injects microbatch t; the others take what arrived
        x_in = x[min(t, m - 1)] if sid == 0 else buf
        y = stage_fn(lp, x_in)
        ops = []
        if sid < n_stages - 1:
            ops.append(dist.P2POp(dist.isend, y.contiguous(), ranks[sid + 1], group))
        if sid > 0:
            buf = torch.empty_like(y)
            ops.append(dist.P2POp(dist.irecv, buf, ranks[sid - 1], group))
        for req in dist.batch_isend_irecv(ops) if ops else []:
            req.wait()
        done = t - (n_stages - 1)  # tick t finishes microbatch t - (S-1)
        if sid == n_stages - 1 and done >= 0:
            out[done] = y
    dist.broadcast(out, src=ranks[n_stages - 1], group=group)
    return out
