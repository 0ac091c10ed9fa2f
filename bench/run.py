"""Runs one cell of the benchmark of ``repro_torch`` (the PyTorch and CUDA
port) once, on the card, and prints its result as the last line of
standard output:

    python3 bench/run.py --workload <cell> --seed <n> --seconds <s> --trace <0|1>

The cell, its configuration, its traffic mix and its metrics are found by
name from ``BENCHMARK.json`` at the root of the checkout (see
``bench/harness.py``). It exits with 1, and prints no result, without a
CUDA card, with fewer cards than the cell asks for, or when the process has
loaded JAX or the JAX package.
"""
from __future__ import annotations

import time

T0 = time.perf_counter()  # set-up counts from the start of the process

import argparse  # noqa: E402
import os  # noqa: E402
import sys  # noqa: E402
from pathlib import Path  # noqa: E402

ROOT = Path(__file__).resolve().parents[1]
# every build and kernel cache of the program at a fixed path inside the
# checkout, set before torch is imported
for var, sub in (("TORCH_EXTENSIONS_DIR", "torch_extensions"), ("TRITON_CACHE_DIR", "triton")):
    os.environ[var] = str(ROOT / "build" / sub)
os.environ["USE_FLAX"] = "0"
# the checkout's root and its src/ first; not bench/ itself, whose module
# names (tree, weights, program) would shadow others
sys.path[:] = [p for p in sys.path if Path(p or ".").resolve() != ROOT / "bench"]
for p in (str(ROOT / "src"), str(ROOT)):
    if p not in sys.path:
        sys.path.insert(0, p)


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seed", type=int, required=True)
    ap.add_argument("--seconds", type=float, required=True)
    ap.add_argument("--trace", type=int, choices=(0, 1), default=0)
    args = ap.parse_args(argv)

    from bench import harness

    spec = harness.load_spec(ROOT)
    cell = harness.find_cell(spec, args.workload)
    err = harness.device_problem(cell["chips"])
    if err:
        print(f"bench: {err}", file=sys.stderr)
        return 1
    result = harness.run_cell(spec, cell, seed=args.seed, seconds=args.seconds,
                              trace=bool(args.trace), t_start=T0)
    if result is None:
        return 1
    harness.emit(result)
    return 0


if __name__ == "__main__":
    sys.exit(main())
