"""Is a candidate's proxy accuracy on the card a pure function of its spec?

    PYTHONPATH=src python scripts/torch_determinism.py [--specs 6] [--steps 40]

The process sweep (``repro_torch.core.sweep``, ``processes=True``) is
bitwise-equal to the serial one only if ``TrainedAccuracy`` gives a spec the
same accuracy in every process. This script trains the same candidates of the
``s1_mbv2`` space (``TrainedAccuracy(steps, batch=64)`` at the proxy's 32 px,
as chip_smoke's search sets it) in two spawned processes under each cuDNN
setting, and prints, per setting, whether the two processes agree on every
accuracy and on every final parameter (a sha256 of their bytes), and the
seconds per candidate in each process (after one warm-up candidate):

* ``process``: the fresh process's own settings (cuDNN TF32 on);
* ``tf32_off``: TF32 off, cuDNN free to pick nondeterministic algorithms;
* ``deterministic``: ``proxy.CUDNN_FLAGS``, what ``TrainedAccuracy`` uses.

It needs a card (it exits 1 without one) and imports only ``repro_torch``.
"""
from __future__ import annotations

import argparse
import hashlib
import json
import multiprocessing
import subprocess
import sys
import time
from pathlib import Path

sys.path.insert(0, str(Path(__file__).resolve().parent.parent / "src"))

import numpy as np
import torch

from repro_torch.common import tree_leaves
from repro_torch.core import nas, proxy
from repro_torch.kernels import ibn_conv

MODES = {
    "process": None,
    "tf32_off": {"enabled": True, "benchmark": False, "deterministic": False,
                 "allow_tf32": False},
    "deterministic": proxy.CUDNN_FLAGS,
}


def _specs(n: int) -> list:
    space = nas.s1_mobilenetv2()
    rng = np.random.default_rng(0)
    return [space.decode(space.sample(rng)) for _ in range(n)]


def _child(mode: str, n: int, steps: int, out) -> None:
    proxy.CUDNN_FLAGS = MODES[mode]
    finals = []
    real_step = proxy.train_step

    def recording_step(*args):
        params, loss = real_step(*args)
        finals[-1] = params
        return params, loss

    proxy.train_step = recording_step
    acc = proxy.TrainedAccuracy(steps=steps, batch=64, device="cuda")
    rows = []
    for spec in _specs(n + 1):
        finals.append(None)
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        a = acc(spec)
        torch.cuda.synchronize()
        h = hashlib.sha256()
        for leaf in tree_leaves(finals[-1]):
            h.update(leaf.detach().cpu().numpy().tobytes())
        rows.append((a, h.hexdigest(), time.perf_counter() - t0))
    out.send({"rows": rows[1:], "launches": ibn_conv.LAUNCHES})


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--specs", type=int, default=6)
    ap.add_argument("--steps", type=int, default=40)
    args = ap.parse_args(argv)
    if not torch.cuda.is_available():
        print("torch_determinism: no CUDA device", file=sys.stderr)
        return 1
    card = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, check=True).stdout.strip().splitlines()[0]
    ibn_conv.build()
    ctx = multiprocessing.get_context("spawn")
    summary = {}
    for mode in MODES:
        got = []
        for _ in range(2):
            r, w = ctx.Pipe(duplex=False)
            p = ctx.Process(target=_child, args=(mode, args.specs, args.steps, w))
            p.start()
            w.close()
            got.append(r.recv())
            p.join()
            if p.exitcode != 0:
                raise RuntimeError(f"{mode}: child exited {p.exitcode}")
        (a, b) = got
        same_acc = [x[0] == y[0] for x, y in zip(a["rows"], b["rows"])]
        same_params = [x[1] == y[1] for x, y in zip(a["rows"], b["rows"])]
        s_per = [float(np.mean([row[2] for row in g["rows"]])) for g in got]
        summary[mode] = {"accuracies_equal": all(same_acc),
                         "params_equal": sum(same_params),
                         "specs": len(same_params), "s_per_candidate": s_per,
                         "launches": [g["launches"] for g in got],
                         "accuracies": [[row[0] for row in g["rows"]] for g in got]}
        print(f"determinism: {mode}: accuracies equal in both processes "
              f"{all(same_acc)}, final params equal {sum(same_params)}/"
              f"{len(same_params)}, s per candidate {s_per[0]:.3f} / {s_per[1]:.3f}, "
              f"K1 launches {a['launches']} / {b['launches']}  [{card}]", flush=True)
    print(json.dumps(summary))
    return 0


if __name__ == "__main__":
    sys.exit(main())
