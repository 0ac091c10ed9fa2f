"""The general training loop: every traffic mix of kind ``train``.

Set-up draws the weights and a pool of ``pool_rows`` token rows of the
mix's length from the seed, builds the program's training step and its
AdamW state, and drives that same state through the first
``checked_steps`` steps through the window's own call and feed, on rows
that all differ; it keeps the program's losses, the norm of each slice's
first clipped gradient (AdamW's first moment after one step, over 1 - b1)
and each slice's change over those steps. The window then dispatches steps
back to back, batch i taking the pool's rows i*B .. i*B+B-1 (wrapping),
uploaded each step; each step's loss is read on the host after the next
step is dispatched, which keeps at most two steps in flight. After the
window the reference trains its own float32 copy of the same weights over
the same first batches and ``reference.judge.training`` compares.
"""
from __future__ import annotations

import time

import torch
from torch.profiler import record_function

from bench import program
from bench import tree as T
from bench import weights
from bench.reference import judge
from bench.reference import train as reftrain
from bench.reference.numerics import Numerics
from bench.traffic.lmstream import LMStream


class Loop:
    kind = "train"

    def __init__(self, ctx):
        self.ctx = ctx
        mix = ctx.mix
        self.batch, self.seq = mix["batch"], mix["seq_len"]
        self.checked = mix["checked_steps"]
        if mix["pool_rows"] % self.batch or mix["pool_rows"] < self.batch * self.checked:
            raise ValueError("pool_rows must be a multiple of the batch and hold the "
                             "checked steps' rows apart")
        self.layout = None
        self.steps_done = 0
        self.losses: list[float] = []

    # -- inputs, the same for the program and the reference -------------

    def _pool(self):
        ctx = self.ctx
        rows = LMStream(ctx.conf["vocab_size"], self.seq, ctx.mix["pool_rows"],
                        seed=ctx.seed).batch_at(0)
        pool = {k: torch.from_numpy(v) for k, v in rows.items()}
        if ctx.device != "cpu":
            pool = {k: v.pin_memory() for k, v in pool.items()}
        return pool

    def batch_at(self, i: int) -> dict:
        lo = (i * self.batch) % self.ctx.mix["pool_rows"]
        return {k: v[lo:lo + self.batch].to(self.ctx.device, non_blocking=True)
                for k, v in self.pool.items()}

    def draw(self, path):
        t = dict(T.leaves(self.layout))[path]
        return weights.draw(path, t.shape, t.dtype, self.ctx.seed, self.ctx.device)

    # -- the program ----------------------------------------------------

    def inputs(self):
        """The weights' layout and the token pool (no program state); the
        port's ModelConfig."""
        cfg = program.model_config(self.ctx.conf)
        self.layout = program.param_layout(cfg)
        self.pool = self._pool()
        return cfg

    def setup(self) -> None:
        ctx, mix = self.ctx, self.ctx.mix
        clock = _Stages(ctx.device)
        cfg = self.inputs()
        clock("inputs")
        self.run = program.train_run(ctx.conf, cfg, mix["run_shape"], self.batch, self.seq,
                                     mix["optimizer"])
        for key in ("microbatches", "remat"):
            if getattr(self.run.train, key) != mix[key]:
                raise ValueError(f"the program runs {key}={getattr(self.run.train, key)!r}, "
                                 f"the cell states {mix[key]!r}")
        self.step_fn, opt_init = program.train_step(self.run)
        params = weights.make(self.layout, ctx.seed, ctx.device)
        self.state = {"params": params, "opt": opt_init(params)}
        clock("weights and state")
        losses = []
        for i in range(self.checked):
            losses.append(self._step(i)["loss"])
            if i == 0:
                b1 = self.run.train.beta1
                grad = {n: float(torch.linalg.vector_norm(m)) / (1 - b1)
                        for n, m in T.slices(program.first_moments(self.state))}
        clock("checked steps")
        with torch.no_grad():
            change = {}
            for path, p in T.leaves(self.state["params"]):
                change.update(_norms(path, p.float() - self.draw(path).float()))
        self.prog = {"loss": [float(x) for x in losses], "grad": grad, "change": change}
        self.next = self.checked
        clock("changes")
        self.notes = {"setup stages s": clock.stages}

    def _step(self, i: int) -> dict:
        self.state, metrics = self.step_fn(self.state, self.batch_at(i))
        return metrics

    def window(self, seconds: float, clock) -> None:
        t0, pending = clock(), None
        while True:
            with record_function("bench.step"):
                metrics = self._step(self.next)
            self.next += 1
            self.steps_done += 1
            if pending is not None:
                with record_function("bench.loss"):
                    self.losses.append(float(pending))
            pending = metrics["loss"]
            if clock() - t0 >= seconds:
                break
        self.losses.append(float(pending))
        _sync(self.ctx.device)

    # -- what the metrics read ------------------------------------------

    def attempted(self) -> int:
        return self.steps_done

    def failed(self) -> int:
        return sum(1 for x in self.losses if not x == x or abs(x) == float("inf"))

    def tokens(self) -> int:
        return self.steps_done * self.batch * self.seq

    def passes(self) -> list[tuple[int, int, bool]]:
        """(rows, sequence length, with a backward) of every forward pass of
        the window: a step is ``microbatches`` passes."""
        k = self.ctx.mix["microbatches"]
        return [(self.batch // k, self.seq, True)] * (self.steps_done * k)

    # -- the check --------------------------------------------------------

    def release(self) -> None:
        self.state = self.step_fn = None

    def reference(self, precision: str = "fp32", fault: str = "") -> dict:
        mix = self.ctx.mix
        return reftrain.run(self.ctx.model, self.ctx.conf, [p for p, _ in T.leaves(self.layout)],
                            self.draw, [self.batch_at(i) for i in range(self.checked)],
                            mix["optimizer"], mix["microbatches"], mix["ref_rows"],
                            Numerics(precision), fault=fault)

    def judge(self) -> dict:
        ref = self.reference()
        self.notes.update({f"worst {key} slices": judge.worst(self.prog, ref, key)
                           for key in ("grad", "change")})
        self.notes["losses (program, reference)"] = [self.prog["loss"], ref["loss"]]
        return judge.training(self.prog, ref)


def _norms(path: tuple, t: torch.Tensor) -> dict:
    return {n: float(torch.linalg.vector_norm(v))
            for n, v in T.slices(T.build([(path, t)]))}


def _sync(device: str) -> None:
    if device != "cpu":
        torch.cuda.synchronize()


class _Stages:
    """Seconds of each stage of the set-up, each ended by a synchronize."""

    def __init__(self, device: str):
        self.device, self.stages, self.t = device, {}, time.perf_counter()

    def __call__(self, name: str) -> None:
        _sync(self.device)
        now = time.perf_counter()
        self.stages[name] = round(now - self.t, 3)
        self.t = now
