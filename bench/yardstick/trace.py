"""The device trace of a run's window: torch's profiler (CPU and CUDA
activity) with kineto's raw events read directly, and what the per-layer
metrics read from them.

``RawProfile`` is a frozen copy of ``chip_smoke.py``'s ``_RawProfile`` at
commit cbce191, and ``Trace`` follows its ``_train_breakdown``: the device
time of a profiler range is the device work whose launch, a runtime call,
ran inside the range on its thread (the port's backward kernels launch
from their libraries, with no op of torch's to link them to). Nothing is
exported: a Chrome trace of the whole window would be hundreds of MB.
"""
from __future__ import annotations

import bisect
from collections import defaultdict

import torch

#: the harness's ranges inside the window, which label what the host was
#: doing during an idle gap of the device
HOST_RANGES = ("bench.step", "bench.loss", "bench.first_tokens")
#: the program's ranges whose device time is read
PROGRAM_RANGES = ("optimizer.step",)
#: the port's kernels by symbol (K1-K4, forward and backward)
KERNEL_SYMBOLS = {"k1": ("ibn_pw",), "k2": ("attn_fwd", "attn_bwd_"),
                  "k3": ("ssd_chunk_scan", "ssd_bwd_"), "k4": ("gmm_bf16", "gmm_f32")}


class RawProfile(torch.autograd.profiler.profile):
    """torch's profiler (CPU and CUDA activity) that keeps kineto's raw
    events and skips building its Python event tree, which takes minutes
    for a profile of ~10^5 ops."""

    def __init__(self):
        if not hasattr(torch.autograd.profiler.profile, "_parse_kineto_results"):
            raise AssertionError("torch's profiler has no _parse_kineto_results to override")
        super().__init__(use_device="cuda", use_kineto=True)

    def _parse_kineto_results(self, result, *args, **kwargs):
        return []


def _merge(intervals: list[tuple[int, int]]) -> list[tuple[int, int]]:
    out: list[list[int]] = []
    for s, e in sorted(intervals):
        if out and s <= out[-1][1]:
            out[-1][1] = max(out[-1][1], e)
        else:
            out.append([s, e])
    return [(s, e) for s, e in out]


class Trace:
    """The window's device activity: ``busy_ns`` (union of the device's
    intervals), ``window_ns``, device ns by name (``by_name``), by kernel
    (``kernel_ns``: K1-K4), in each program range (``range_ns``), and the
    idle gaps' ns by what the host was doing (``idle_by_host``)."""

    def __init__(self, prof: RawProfile):
        if getattr(prof, "kineto_results", None) is None:
            raise AssertionError("torch's profiler kept no kineto_results: its names have changed")
        device, by_corr, launches, ranges, host, marks = ([], defaultdict(int),
                                                          defaultdict(list), [], [], [])
        window = None
        for e in prof.kineto_results.events():
            if e.device_type() == torch.autograd.DeviceType.CUDA:
                if e.is_user_annotation():
                    continue
                device.append((e.start_ns(), e.end_ns(), e.name()))
                by_corr[e.correlation_id()] += e.duration_ns()
                continue
            name = e.name()
            if e.linked_correlation_id() != 0:  # a runtime call: a launch or a copy
                launches[e.start_thread_id()].append((e.start_ns(), e.correlation_id()))
                host.append((e.start_ns(), e.end_ns(), name, e.start_thread_id()))
            elif name in PROGRAM_RANGES:
                ranges.append((name, e.start_thread_id(), e.start_ns(), e.end_ns()))
            elif name == "bench.window":
                window = (e.start_ns(), e.end_ns(), e.start_thread_id())
            elif name in HOST_RANGES:
                marks.append((e.start_ns(), e.end_ns(), name))
            else:
                host.append((e.start_ns(), e.end_ns(), name, e.start_thread_id()))
        if window is None:
            raise AssertionError("the trace holds no bench.window range")
        t0, t1, main = window
        device = [(max(s, t0), min(e, t1), n) for s, e, n in device if e > t0 and s < t1]
        self.window_ns = t1 - t0
        busy = _merge([(s, e) for s, e, _ in device])
        self.busy_ns = sum(e - s for s, e in busy)
        self.device_ns = sum(e - s for s, e, _ in device)
        self.by_name: dict[str, int] = defaultdict(int)
        for s, e, n in device:
            self.by_name[n] += e - s
        self.kernel_ns = {k: sum(v for n, v in self.by_name.items() if any(x in n for x in keys))
                          for k, keys in KERNEL_SYMBOLS.items()}
        for calls in launches.values():
            calls.sort()
        self.range_ns = dict.fromkeys(PROGRAM_RANGES, 0)
        for name, thread, start, end in ranges:
            if end < t0 or start > t1:
                continue
            calls = launches.get(thread, [])
            lo = bisect.bisect_left(calls, (start, -1))
            hi = bisect.bisect_right(calls, (end, float("inf")))
            self.range_ns[name] += sum(by_corr.get(c, 0) for _, c in calls[lo:hi])
        self.idle_by_host = self._idle(busy, t0, t1,
                                       sorted(h for h in host if h[3] == main), marks)

    @staticmethod
    def _idle(busy, t0, t1, host, marks) -> dict:
        """Idle ns by label: the harness range and the innermost host event
        open when the gap began."""
        gaps, last = [], t0
        for s, e in busy:
            if s > last:
                gaps.append((last, s))
            last = max(last, e)
        if t1 > last:
            gaps.append((last, t1))
        starts = [h[0] for h in host]
        marks = sorted(marks)
        mstarts = [m[0] for m in marks]
        out: dict[str, int] = defaultdict(int)
        for gs, ge in gaps:
            i = bisect.bisect_right(starts, gs) - 1
            inner = next((host[j][2] for j in range(i, max(i - 4000, -1), -1)
                          if host[j][1] >= gs), "nothing")
            k = bisect.bisect_right(mstarts, gs) - 1
            outer = marks[k][2] if k >= 0 and marks[k][1] >= gs else "bench.window"
            out[f"{outer} > {inner}"] += ge - gs
        return dict(out)

    def top_ops(self, n: int = 10) -> list[list]:
        """The device operations that took most time, (name cut to 160
        characters, seconds)."""
        return [[k[:160], v / 1e9] for k, v in
                sorted(self.by_name.items(), key=lambda kv: -kv[1])[:n]]

    def top_idle(self, n: int = 10) -> list[list]:
        return [[k, v / 1e9] for k, v in
                sorted(self.idle_by_host.items(), key=lambda kv: -kv[1])[:n]]
