"""Readings that set the limits of ``correct``: the control (the reference
in the program's place, every product in fp8) and the faults planted in
it, against the float32 reference, at a cell's own size on the card, for
each seed given. The benchmark's runs never run this.

    python3 bench/control.py --workload <cell> --seeds 11 12 13 [--out FILE]

Training cells: the control's numbers, and those of the float32
reference with half of every batch left out (the mean over the rest). A
step that returns its state unchanged reads 1 in ``change_gap`` by the
measure and needs no run. Prefill cells: the control's numbers over
the batches a run's window starts with (as many as a run samples), and
that of each served token altered to the next token id.
"""
from __future__ import annotations

import argparse
import json
import sys
from pathlib import Path

ROOT = Path(__file__).resolve().parents[1]
for p in (str(ROOT / "src"), str(ROOT)):
    if p not in sys.path:
        sys.path.insert(0, p)


def train_readings(loop, dump: dict | None = None) -> dict:
    import gc

    import torch

    from bench.reference import judge

    if dump is not None:  # the program's checked steps first, then freed
        loop.setup()
        dump["program"] = loop.prog
        loop.release()
        gc.collect()
        torch.cuda.empty_cache()
    ref = loop.reference("fp32")
    out = {}
    for name, got in (("control", loop.reference("fp8")),
                      ("half_batch", loop.reference("fp32", fault="half_batch"))):
        out[name] = judge.training(got, ref)
        out[name]["worst"] = {k: judge.worst(got, ref, k) for k in ("grad", "change")}
        if dump is not None:
            dump[name] = got
    if dump is not None:
        dump["reference"] = ref
        out["program"] = judge.training(dump["program"], ref)
    return out


def prefill_readings(loop) -> dict:
    import torch

    from bench.reference import judge

    first = len(loop.cycle)  # the window starts after the warm-up cycle
    batches = list(range(first, first + loop.ctx.mix["sample_batches"]))
    ref = torch.cat(loop.last_logits(batches, "fp32"))
    low = torch.cat(loop.last_logits(batches, "fp8"))
    altered = (ref.argmax(-1) + 1) % ref.shape[-1]
    return {"control": judge.served(judge.served_gaps(ref, low.argmax(-1))),
            "token_altered": judge.served(judge.served_gaps(ref, altered))}


def readings(cell_name: str, seed: int, device: str = "cuda", dump: dict | None = None,
             **kw) -> dict:
    from bench import harness
    from bench.reference.numerics import fp32_only

    spec = harness.load_spec(ROOT)
    ctx, _, loop_mod = harness.context(spec, harness.find_cell(spec, cell_name), seed,
                                       device, **kw)
    fp32_only()
    loop = loop_mod.Loop(ctx)
    loop.inputs()
    if loop.kind == "train":
        return train_readings(loop, dump)
    return prefill_readings(loop)


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seeds", type=int, nargs="+", required=True)
    ap.add_argument("--out", type=Path)
    ap.add_argument("--dump", type=Path, help="training cells: also run the program's "
                    "checked steps, and write every slice's readings here")
    args = ap.parse_args(argv)
    out, dumps = {}, {}
    for seed in args.seeds:
        dumps[seed] = {} if args.dump else None
        out[seed] = readings(args.workload, seed, dump=dumps[seed])
        if args.dump:
            args.dump.parent.mkdir(parents=True, exist_ok=True)
            args.dump.write_text(json.dumps(dumps))
        print(json.dumps({"workload": args.workload, "seed": seed, **out[seed]}), flush=True)
    if args.out:
        args.out.parent.mkdir(parents=True, exist_ok=True)
        args.out.write_text(json.dumps(out, indent=1))
    return 0


if __name__ == "__main__":
    sys.exit(main())
