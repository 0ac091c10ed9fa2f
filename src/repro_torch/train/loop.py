"""The training loop: checkpoint/restart, straggler watchdog, failure
injection, metrics logging. Counterpart of ``repro/train/loop.py``.

``run_training`` is what ``launch/train.py`` and the tests drive.
Fault-tolerance contract:
  * every ``ckpt_every`` steps the full state is checkpointed (atomic, async)
  * any crash (including injected ones) can be resumed with the same call —
    the loop restores the latest checkpoint and replays the data stream
    deterministically from that step
  * a watchdog flags steps slower than ``straggler_factor`` × the running
    median as straggler events (on a real fleet this feeds the reslicer;
    here it is surfaced in metrics and asserted on in tests)

A step's time is host time: the step is queued on the card and not waited
for, except where a metric is logged (``float`` of a 0-d tensor) or a
checkpoint's host snapshot is taken, so a slow device shows in the steps
that wait for it.
"""
from __future__ import annotations

import dataclasses
import json
import os
import tempfile
import time
from typing import Callable, Optional

import numpy as np
import torch

from repro_torch.common import tree_leaves
from repro_torch.train import checkpoint as ckpt


@dataclasses.dataclass
class LoopConfig:
    total_steps: int = 100
    ckpt_every: int = 20
    ckpt_dir: str = os.path.join(tempfile.gettempdir(), "repro_ckpt")
    keep: int = 3
    log_every: int = 10
    async_ckpt: bool = True
    straggler_factor: float = 3.0
    # test hook: raise RuntimeError after this step (simulated node failure)
    fail_at_step: Optional[int] = None


@dataclasses.dataclass
class LoopResult:
    final_step: int
    metrics_history: list
    straggler_events: list
    resumed_from: Optional[int]


def _block_until_ready(state) -> None:
    """Wait for the device that holds the state's first leaf."""
    leaf = tree_leaves(state)[0]
    if leaf.device.type == "cuda":
        torch.cuda.synchronize(leaf.device)


def run_training(
    step_fn: Callable,
    init_state,
    batch_at: Callable[[int], dict],
    loop_cfg: LoopConfig,
    state_shardings=None,
    log_fn: Callable[[str], None] = print,
) -> LoopResult:
    """step_fn(state, batch) -> (state, metrics)."""
    os.makedirs(loop_cfg.ckpt_dir, exist_ok=True)
    state = init_state
    start = 0
    resumed_from = None
    latest = ckpt.latest_step(loop_cfg.ckpt_dir)
    if latest is not None:
        state, start = ckpt.restore(
            loop_cfg.ckpt_dir, init_state, shardings=state_shardings
        )
        resumed_from = start
        log_fn(f"[loop] resumed from checkpoint step {start}")

    history = []
    stragglers = []
    durations: list[float] = []
    pending = None
    for step in range(start, loop_cfg.total_steps):
        t0 = time.monotonic()
        batch = batch_at(step)
        state, metrics = step_fn(state, batch)
        if loop_cfg.fail_at_step is not None and step == loop_cfg.fail_at_step:
            # flush the state so the failure is recoverable, then die like a
            # preempted node would
            _block_until_ready(state)
            raise RuntimeError(f"injected failure at step {step}")
        dt = time.monotonic() - t0
        durations.append(dt)
        med = float(np.median(durations[-50:]))
        if len(durations) > 5 and dt > loop_cfg.straggler_factor * med:
            stragglers.append({"step": step, "dt": dt, "median": med})
            log_fn(f"[watchdog] straggler step {step}: {dt:.3f}s vs median {med:.3f}s")
        if step % loop_cfg.log_every == 0 or step == loop_cfg.total_steps - 1:
            m = {k: float(v) for k, v in metrics.items()}
            m["step"] = step
            m["dt"] = dt
            history.append(m)
            log_fn(f"[train] {json.dumps(m)}")
        if (step + 1) % loop_cfg.ckpt_every == 0:
            if pending is not None:
                pending.join()
            pending = ckpt.save(
                loop_cfg.ckpt_dir, step + 1, state, keep=loop_cfg.keep,
                blocking=not loop_cfg.async_ckpt,
            )
    if pending is not None:
        pending.join()
    final = loop_cfg.total_steps
    ckpt.save(loop_cfg.ckpt_dir, final, state, keep=loop_cfg.keep, blocking=True)
    return LoopResult(final, history, stragglers, resumed_from)
