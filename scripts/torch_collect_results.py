"""Render the §Dry-run / §Roofline markdown tables from the port's dry-run
records (``results/dryrun/*.json``, written by ``repro_torch.launch.dryrun``).
Counterpart of ``scripts/collect_results.py``: the same two tables, rows in
the same order (``configs.ARCHS`` x ``config.SHAPES``), every cell rendered
as the reference renders the same record, but one.

The first table's "compile s" column is "trace s" here, read from the
record's ``lower_s``. The port's dry run compiles nothing: it traces the
sharded step under a fake tensor mode, and a record carries no
``compile_s`` (``repro_torch/launch/dryrun.py``'s docstring), so the
reference's column would read 0 on every row; ``lower_s`` is that trace's
wall time.

  PYTHONPATH=src python -m repro_torch.launch.dryrun --arch mamba2_370m \\
      --shape decode_32k --device cpu --out /tmp/dry
  PYTHONPATH=src python scripts/torch_collect_results.py --dir /tmp/dry
  PYTHONPATH=src python scripts/torch_collect_results.py [--dir results/dryrun]
"""
from __future__ import annotations

import argparse
import glob
import json
import os
import sys
from pathlib import Path

sys.path.insert(0, str(Path(__file__).parent.parent / "src"))

from repro_torch import configs
from repro_torch.config import SHAPES


def fmt_bytes(n):
    return f"{n/2**30:.2f}"


def main(argv=None) -> None:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--dir", default="results/dryrun")
    args = ap.parse_args(argv)

    recs = {}
    for path in glob.glob(os.path.join(args.dir, "*.json")):
        base = os.path.basename(path)[:-5]
        with open(path) as f:
            recs[base] = json.load(f)

    print("### §Dry-run (per-device bytes, both meshes)\n")
    print("| arch | shape | mesh | status | args GiB | temp GiB | trace s |"
          " collectives (count) |")
    print("|---|---|---|---|---|---|---|---|")
    for arch in configs.ARCHS:
        for shape in SHAPES:
            for mesh in ("single", "multi"):
                r = recs.get(f"{arch}_{shape}_{mesh}")
                if r is None:
                    continue
                if r.get("status") != "ok":
                    print(f"| {arch} | {shape} | {r.get('mesh','?')} | "
                          f"{r['status']} | | | | |")
                    continue
                mm = r["memory_analysis"]
                coll = r.get("raw_collectives", r.get("collectives", {}))
                cc = coll.get("counts", {})
                cstr = " ".join(f"{k.split('-')[-1]}:{v}" for k, v in
                                sorted(cc.items()))
                print(f"| {arch} | {shape} | {r['mesh']} | ok | "
                      f"{fmt_bytes(mm.get('argument_size_in_bytes',0))} | "
                      f"{fmt_bytes(mm.get('temp_size_in_bytes',0))} | "
                      f"{r.get('lower_s',0):.0f} | {cstr} |")

    print("\n### §Roofline (single-pod, loop-calibrated)\n")
    print("| arch | shape | compute ms | memory ms | collective ms | dominant"
          " | useful-FLOPs ratio | roofline frac |")
    print("|---|---|---|---|---|---|---|---|")
    for arch in configs.ARCHS:
        for shape in SHAPES:
            r = recs.get(f"{arch}_{shape}_single")
            if r is None:
                continue
            if r.get("status") != "ok":
                print(f"| {arch} | {shape} | {r['status']} | | | | | |")
                continue
            rl = r.get("roofline")
            if not rl:
                continue
            print(f"| {arch} | {shape} | {rl['compute_s']*1e3:.1f} | "
                  f"{rl['memory_s']*1e3:.1f} | {rl['collective_s']*1e3:.1f} | "
                  f"{rl['dominant'].replace('_s','')} | "
                  f"{rl['useful_flops_ratio']:.2f} | "
                  f"{rl['roofline_fraction']:.3f} |")


if __name__ == "__main__":
    main()
