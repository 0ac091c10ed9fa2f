"""Build a serve-stack fixture store with the PyTorch port. Counterpart of
``scripts/make_serve_fixture.py``, with its recipe: a 6-scenario sweep over
the tiny space with the calibrated ``SurrogateAccuracy`` signal and the
analytic simulator (192 samples a scenario, batch 16, seed 0 end to end),
its PPO controller on ``--device``, compacted so the log holds exactly one
line per unique (namespace ++ vec) key.

The records by decision vector are the reference fixture's
(``tests/data/serve_fixture.jsonl``); the keys carry the port's own engine
namespace digest, not the reference's. So ``--out`` is required: the
reference's committed fixture is not this script's to overwrite.

``--device`` defaults to ``cuda``; without a GPU the script raises unless
given ``--device cpu``.

  PYTHONPATH=src python scripts/torch_make_serve_fixture.py --out /tmp/fixture.jsonl
  PYTHONPATH=src python scripts/torch_make_serve_fixture.py --out /tmp/fixture.jsonl \\
      --device cpu
  PYTHONPATH=src python scripts/torch_runtime_serve.py --store /tmp/fixture.jsonl --all
"""
from __future__ import annotations

import argparse
import sys
from pathlib import Path

import torch

sys.path.insert(0, str(Path(__file__).parent.parent / "src"))

from repro_torch.core import nas, proxy, sweep
from repro_torch.core.search import SearchConfig
from repro_torch.runtime import DurableRecordStore, SearchRuntime

# Two latency-, one energy- and one area-bounded use case: enough objective
# diversity that the persisted frontier has distinct per-scenario winners.
SCENARIOS = (
    "lat-0.3ms",
    "lat-0.8ms",
    "lat-1.3ms",
    "energy-0.7mJ",
    "edge-sku-small",
    "lat-0.5ms-soft",
)
SAMPLES = 192
BATCH = 16
SEED = 0


def build(out: Path, device: str = "cuda") -> DurableRecordStore:
    if torch.device(device).type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError("device 'cuda' was asked for, and this host has no GPU")
    out = Path(out)
    out.parent.mkdir(parents=True, exist_ok=True)
    if out.exists():
        out.unlink()
    store = DurableRecordStore(out)
    runner = sweep.SweepRunner(
        list(SCENARIOS),
        nas.tiny_space(),
        proxy.SurrogateAccuracy(),
        sweep.SweepConfig(search=SearchConfig(samples=SAMPLES, batch=BATCH, seed=SEED,
                                              device=device)),
    )
    result = runner.run(runtime=SearchRuntime(store=store))
    dropped = store.compact()  # one line per key: deterministic, diff-friendly
    store.close()
    print(
        f"{out}: {len(store)} records "
        f"({store.stats.puts} puts, {dropped} stale lines compacted away), "
        f"frontier {len(result.frontier)}"
    )
    return store


def main(argv=None) -> None:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--out", type=Path, required=True)
    ap.add_argument("--device", default="cuda",
                    help="where the PPO controller runs (default: the card)")
    args = ap.parse_args(argv)
    build(args.out, args.device)


if __name__ == "__main__":
    main()
