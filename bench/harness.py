"""The harness: finds a cell's configuration, traffic mix, limits and
metric readers by the names in ``BENCHMARK.json``, runs the cell once and
builds its result line.

Files by name:
  bench/configs/<config>.json   the configuration as it is run: its sizes,
                                the port's arch and overrides, and the
                                reference module (``bench/reference/<x>.py``)
  bench/traffic/<traffic>.json  a mix's parameters; its ``kind`` names the
                                general loop (``bench/loops/<kind>.py``)
  bench/cells/<cell>.json       the cell's parameters over the mix's
                                (``params``) and the limit of each number
                                that decides ``correct`` (``limits``)
  bench/metrics/<metric>.py     a metric's reader (see ``bench.metrics``)

A run: set-up (everything up to the window), the window (``--seconds``;
with ``--trace 1`` under the profiler), then, once the window has closed
and the memory peak is read, the program's state is freed and the
reference decides ``correct``.
"""
from __future__ import annotations

import dataclasses
import gc
import importlib
import importlib.util
import json
import math
import subprocess
import sys
import time
from pathlib import Path
from types import ModuleType
from typing import Optional

import torch

#: top-level modules that may not be loaded in a run: JAX and the JAX package
FORBIDDEN = ("jax", "jaxlib", "flax", "repro")
BENCH = Path(__file__).resolve().parent


def load_spec(root: Path) -> dict:
    return json.loads((root / "BENCHMARK.json").read_text())


def find_cell(spec: dict, name: str) -> dict:
    for cell in spec["workloads"]:
        if cell["name"] == name:
            return cell
    raise SystemExit(f"bench: no workload {name!r} in BENCHMARK.json")


def device_problem(chips: int) -> Optional[str]:
    if not torch.cuda.is_available():
        return "no CUDA device: the benchmark measures the port on the card"
    if torch.cuda.device_count() < chips:
        return f"the cell needs {chips} cards, {torch.cuda.device_count()} visible"
    return None


def forbidden_modules() -> list[str]:
    """Loaded modules whose top-level name, compared whole, is forbidden."""
    return sorted({m.split(".")[0] for m in sys.modules} & set(FORBIDDEN))


def metrics_for(spec: dict, cell: str, trace: bool) -> list[dict]:
    """The cell's end-to-end metrics, or with ``trace`` its per-layer
    ones: those that list the cell under ``workloads``, or that list none
    and move an end-to-end metric the cell reports."""
    e2e = [m for m in spec["end_to_end"] if cell in m.get("workloads", [cell])]
    if not trace:
        return e2e
    names = {m["name"] for m in e2e}
    return [m for m in spec["per_layer"]
            if cell in m.get("workloads", [cell] if m["moves"] in names else [])]


def _load(path: Path, name: str) -> ModuleType:
    spec = importlib.util.spec_from_file_location(name, path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def reader(name: str):
    """(read function, phase) of a metric ``<base>[.<phase>]``: the reader
    is ``bench/metrics/<base>.py``."""
    base, _, phase = name.partition(".")
    return _load(BENCH / "metrics" / f"{base}.py", f"bench.metrics.{base}").read, phase or None


@dataclasses.dataclass
class Context:
    """What a loop gets: the run's seed and device, the configuration file
    (``conf``), the mix's parameters with the cell's over them (``mix``),
    and the configuration's reference model module (``model``)."""
    seed: int
    device: str
    conf: dict
    mix: dict
    model: ModuleType


def context(spec: dict, cell: dict, seed: int, device: str = "cuda",
            conf_file: Optional[Path] = None,
            mix_override: Optional[dict] = None) -> tuple[Context, dict, ModuleType]:
    """(context, the cell's file, the loop module) of a cell."""
    root = BENCH.parent
    entry = next(c for c in spec["configs"] if c["name"] == cell["config"])
    conf = json.loads((conf_file or root / entry["file"]).read_text())
    mix = json.loads((BENCH / "traffic" / f"{cell['traffic']}.json").read_text())
    cell_file = json.loads((BENCH / "cells" / f"{cell['name']}.json").read_text())
    mix.update(cell_file.get("params", {}))
    mix.update(mix_override or {})
    model = importlib.import_module(f"bench.reference.{conf['reference']}")
    loop = importlib.import_module(f"bench.loops.{mix['kind']}")
    return Context(seed, device, conf, mix, model), cell_file, loop


@dataclasses.dataclass
class Record:
    """What the metric readers read."""
    kind: str
    conf: dict
    setup_s: float
    window_s: float
    tokens: int
    steps: int
    passes: list
    window_peak_bytes: int
    trace: object = None


def _sync(device: str) -> None:
    if device != "cpu":
        torch.cuda.synchronize()


def _power_limit() -> str:
    try:
        out = subprocess.run(["nvidia-smi", "--query-gpu=power.limit",
                              "--format=csv,noheader"], capture_output=True, text=True,
                             timeout=20).stdout.strip().splitlines()
        return out[0] if out else "unknown"
    except (OSError, subprocess.SubprocessError):
        return "unknown"


def run_cell(spec: dict, cell: dict, *, seed: int, seconds: float, trace: bool,
             t_start: float, device: str = "cuda", conf_file: Optional[Path] = None,
             mix_override: Optional[dict] = None) -> Optional[dict]:
    """Runs one cell once; returns its result (see ``emit``) or None after
    printing why there is none: a process that has loaded JAX or the JAX
    package by the time the result is complete gives none. The tests run it on the CPU at small sizes
    (``conf_file``, ``mix_override``)."""
    ctx, cell_file, loop_mod = context(spec, cell, seed, device, conf_file, mix_override)
    loop = loop_mod.Loop(ctx)
    loop.setup()
    _sync(device)
    cuda = device != "cpu"
    setup_peak = torch.cuda.max_memory_allocated() if cuda else 0
    if cuda:
        torch.cuda.reset_peak_memory_stats()
    setup_s = time.perf_counter() - t_start
    from bench import program

    launches0 = program.launches()
    prof = None
    if trace:
        from bench.yardstick.trace import RawProfile

        prof = RawProfile()
        prof.__enter__()
    t0 = time.perf_counter()
    with torch.profiler.record_function("bench.window"):
        loop.window(seconds, time.perf_counter)
        _sync(device)
    window_s = time.perf_counter() - t0
    if prof is not None:
        prof.__exit__(None, None, None)
    window_peak = torch.cuda.max_memory_allocated() if cuda else 0
    launches = {k: v - launches0[k] for k, v in program.launches().items()}

    tr = None
    if prof is not None:
        from bench.yardstick.trace import Trace

        tr = Trace(prof)
        prof = None
    record = Record(loop.kind, ctx.conf, setup_s, window_s, loop.tokens(),
                    getattr(loop, "steps_done", 0), loop.passes(), window_peak, tr)
    metrics = {}
    for m in metrics_for(spec, cell["name"], trace):
        read, phase = reader(m["name"])
        value = read(record, phase)
        if value is not None:
            metrics[m["name"]] = {"value": value, "unit": m["unit"]}

    # the check: the program's state freed, the reference in its place
    from bench.reference.numerics import fp32_only

    loop.release()
    gc.collect()
    if cuda:
        torch.cuda.empty_cache()
    fp32_only()
    t_ref = time.perf_counter()
    numbers = loop.judge()
    print(f"bench: setup {setup_s:.1f} s, window {window_s:.1f} s, reference "
          f"{time.perf_counter() - t_ref:.1f} s", file=sys.stderr)
    limits = cell_file["limits"]
    checks = {k: {"value": numbers.get(k, float("nan")), "limit": v} for k, v in limits.items()}
    correct = all(math.isfinite(c["value"]) and c["value"] <= c["limit"]
                  for c in checks.values())
    notes = dict(getattr(loop, "notes", {}))
    notes.update({f"{k} (not compared)": v for k, v in numbers.items() if k not in limits})
    failed = loop.failed() + (0 if correct else 1)

    dev = {"platform": "gpu" if cuda else "cpu",
           "kind": torch.cuda.get_device_name(0) if cuda else "cpu",
           "count": cell["chips"], "memory_peak_bytes": max(setup_peak, window_peak)}
    if tr is not None:
        dev["busy_s"] = tr.busy_ns / 1e9
        dev["window_s"] = tr.window_ns / 1e9
    if cuda:
        dev["power_limit"] = _power_limit()
    result = {"correct": correct, "attempted": loop.attempted(), "failed": failed,
              "metrics": metrics, "device": dev}
    if tr is not None:
        result["breakdown"] = {"device_ops": tr.top_ops(), "idle_gaps": tr.top_idle()}
    result["launches"] = launches
    result["notes"] = notes
    result["checks"] = checks
    # last, once the metric readers and the reference have run too
    found = forbidden_modules()
    if found:
        print(f"bench: the run loaded {', '.join(found)}; the benchmark measures the "
              "port alone", file=sys.stderr)
        return None
    return result


def emit(result: dict) -> None:
    """The compared numbers beside their limits as the last lines of
    standard error, then the result as the last line of standard output."""
    print(f"bench: device {json.dumps(result['device'])}", file=sys.stderr)
    print(f"bench: kernel launches in the window {json.dumps(result['launches'])}",
          file=sys.stderr)
    for name, note in result["notes"].items():
        print(f"bench: {name} {json.dumps(note)}", file=sys.stderr)
    for name, c in result["checks"].items():
        print(f"check {name} {c['value']!r} limit {c['limit']!r}", file=sys.stderr)
    sys.stderr.flush()
    print(json.dumps(result), flush=True)
