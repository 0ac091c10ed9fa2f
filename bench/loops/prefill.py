"""The general prefill loop: every traffic mix of kind ``prefill``.

The server takes ``requests_per_cycle`` requests at a time, groups them by
length, and runs each group as batches of at most ``batch_tokens`` prompt
tokens, one batch in flight. The lengths are the mix's ``lengths``
(buckets), each holding its share of a lognormal of median
``median_tokens`` and log-sd ``log_sigma`` (edges at the geometric
midpoints between neighbouring lengths, the tails folded into the ends),
rounded to whole requests by largest remainders. So every cycle, and every
seed, does the same batches; their order within each cycle is drawn from
``order_seed`` and the cycle, not from the run's seed, so every run serves
the same sequence of shapes. The seed draws the prompts: each batch's B
rows of a pool of ``pool_rows`` token rows, at an offset.

Set-up draws the weights, builds the program's prefill step and serves
the first cycle, which warms every shape; the window serves the batches
from the second cycle on, back to back: a batch completes when the first
token of each of its prompts (the argmax of its last position) is on the
host. After the window the reference computes the logits at the last
position of every prompt of ``sample_batches`` completed batches, drawn
from the seed with the longest in it, and ``reference.judge`` reads how far
each served first token lies below the reference's best.
"""
from __future__ import annotations

import math

import numpy as np
import torch
from torch.profiler import record_function

from bench import program
from bench import weights
from bench.reference import judge
from bench.loops.train import _Stages
from bench.reference.numerics import Numerics
from bench.traffic.lmstream import LMStream


def bucket_requests(mix: dict) -> list[int]:
    """Requests of each of ``mix["lengths"]`` in a cycle."""
    lengths, n = mix["lengths"], mix["requests_per_cycle"]
    edges = [math.sqrt(a * b) for a, b in zip(lengths, lengths[1:])]
    z = [math.log(e / mix["median_tokens"]) / mix["log_sigma"] for e in edges]
    cdf = [0.0] + [0.5 * (1.0 + math.erf(v / math.sqrt(2.0))) for v in z] + [1.0]
    raw = [n * (b - a) for a, b in zip(cdf, cdf[1:])]
    counts = [int(r) for r in raw]
    by_rest = sorted(range(len(raw)), key=lambda i: counts[i] - raw[i])
    for i in by_rest[:n - sum(counts)]:
        counts[i] += 1
    return counts


def cycle_batches(mix: dict) -> list[tuple[int, int]]:
    """The (B, S) of each batch of a cycle, by length."""
    out = []
    for s, c in zip(mix["lengths"], bucket_requests(mix)):
        most = max(1, mix["batch_tokens"] // s)
        out += [(most, s)] * (c // most) + ([(c % most, s)] if c % most else [])
    return out


class Loop:
    kind = "prefill"

    def __init__(self, ctx):
        self.ctx = ctx
        self.lengths = list(ctx.mix["lengths"])
        self.cycle = cycle_batches(ctx.mix)
        if max(b for b, _ in self.cycle) > ctx.mix["pool_rows"]:
            raise ValueError("pool_rows must hold the largest batch's prompts apart")
        self.done: list[tuple[int, int, np.ndarray]] = []  # (j, S, first tokens)

    def _rng(self, *keys) -> np.random.Generator:
        return np.random.default_rng(np.random.SeedSequence([*keys]))

    def shape_at(self, j: int) -> tuple[int, int, np.ndarray, int]:
        """(B, S, pool rows, offset) of batch j."""
        n = len(self.cycle)
        order = self._rng(self.ctx.mix["order_seed"], 1, j // n).permutation(n)
        b, s = self.cycle[order[j % n]]
        g = self._rng(self.ctx.seed, 2, j)
        rows = g.choice(self.ctx.mix["pool_rows"], size=b, replace=False)
        return b, s, rows, int(g.integers(0, max(self.lengths) - s + 1))

    def tokens_at(self, j: int) -> torch.Tensor:
        _, s, rows, off = self.shape_at(j)
        return self.pool[rows, off:off + s]

    def inputs(self):
        """The weights' layout and the token pool (no program state); the
        port's ModelConfig."""
        ctx = self.ctx
        self.pool = torch.from_numpy(
            LMStream(ctx.conf["vocab_size"], max(self.lengths), ctx.mix["pool_rows"],
                     seed=ctx.seed).batch_at(0)["tokens"])
        cfg = program.model_config(ctx.conf)
        self.layout = program.param_layout(cfg)
        return cfg

    def setup(self) -> None:
        ctx = self.ctx
        clock = _Stages(ctx.device)
        cfg = self.inputs()
        clock("inputs")
        self.params = weights.make(self.layout, ctx.seed, ctx.device)
        self.step = program.prefill_step(cfg, max(b for b, _ in self.cycle), max(self.lengths))
        clock("weights")
        for j in range(len(self.cycle)):  # every shape once
            self._serve(j)
        clock("warm-up")
        self.next = len(self.cycle)
        self.notes = {"setup stages s": clock.stages,
                      "batches a cycle (B, S)": sorted(set(self.cycle))}

    def _serve(self, j: int) -> tuple[int, np.ndarray]:
        toks = self.tokens_at(j)
        with record_function("bench.step"):
            logits = self.step(self.params, {"tokens": toks.to(self.ctx.device)})
        with record_function("bench.first_tokens"):
            return toks.shape[1], logits[:, -1].argmax(dim=-1).cpu().numpy()

    def window(self, seconds: float, clock) -> None:
        t0 = clock()
        while True:
            j = self.next
            self.next += 1
            self.done.append((j, *self._serve(j)))
            if clock() - t0 >= seconds:
                break

    def attempted(self) -> int:
        return sum(len(first) for _, _, first in self.done)

    def failed(self) -> int:
        return 0  # judged below; a closed loop leaves no request unanswered

    def tokens(self) -> int:
        return sum(s * len(first) for _, s, first in self.done)

    def passes(self) -> list[tuple[int, int, bool]]:
        return [(len(first), s, False) for _, s, first in self.done]

    # -- the check --------------------------------------------------------

    def release(self) -> None:
        self.params = self.step = None

    def sample(self) -> list[int]:
        """Indices into ``done``: a draw from the seed, the longest in it."""
        n = min(self.ctx.mix["sample_batches"], len(self.done))
        longest = max(range(len(self.done)), key=lambda i: self.done[i][1])
        rest = [i for i in range(len(self.done)) if i != longest]
        picked = (self._rng(self.ctx.seed, 3).choice(len(rest), size=n - 1, replace=False)
                  if n > 1 else [])
        return sorted([longest] + [rest[i] for i in picked])

    def last_logits(self, batches: list[int], precision: str = "fp32") -> list[torch.Tensor]:
        """The reference's logits (B, V) at the last position of each of the
        batches, from the weights drawn anew."""
        ctx = self.ctx
        num, model = Numerics(precision), ctx.model
        params = weights.make(self.layout, ctx.seed, ctx.device)
        out = []
        with torch.no_grad():
            for j in batches:
                toks = self.tokens_at(j).to(ctx.device)
                rows = ctx.mix["ref_rows"] if model.ROWS_INDEPENDENT else toks.shape[0]
                out.append(torch.cat([model.head(params, model.hidden(
                    params, toks[r:r + rows], ctx.conf, num)[0][:, -1], num)
                    for r in range(0, toks.shape[0], rows)]))
        return out

    def judge(self) -> dict:
        picked = [self.done[i] for i in self.sample()]
        refs = self.last_logits([j for j, _, _ in picked])
        gaps = torch.cat([judge.served_gaps(ref, torch.from_numpy(first).to(ref.device))
                          for ref, (_, _, first) in zip(refs, picked)])
        self.notes["served tokens checked"] = int(gaps.numel())
        return judge.served(gaps)
