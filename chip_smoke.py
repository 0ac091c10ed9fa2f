#!/usr/bin/env python3
"""Chip smoke test of the PyTorch / CUDA port (``src/repro_torch``).

    python3 chip_smoke.py [--json PATH]

On one NVIDIA H100 (compute capability 9.0, ``nvcc`` on PATH or in
/usr/local/cuda) it:

1. build   — compiles the ``ibn_pointwise`` kernel from the repository's
             sources and prints ptxas's report;
2. kernel  — at every distinct 1×1 shape of full-width MobileNetV2,
             EfficientNet-B0 (SE, swish) and the manual EdgeTPU model at
             224 px, batch 8, and of the search's MobileNetV2 space at the
             proxy's 32 px, batch 64, holds the kernel's forward and backward
             (dx, dw, db) against the plain PyTorch version on the card, and
             times kernel, plain version and ``torch.addmm`` + act;
3. model   — the same three models at full width, 1000 classes, 224 px: the
             card's logits against the port's CPU forward on the same params,
             then 5 SGD steps of ``proxy.train_step`` at batch 16;
4. search  — the main path: ``SearchSession.joint`` over the full-width
             MobileNetV2 space with ``TrainedAccuracy`` and the PPO
             controller on the card, with the kernel's launch count reset
             just before and read just after;
5. profile — one training step of a search candidate under torch.profiler:
             wall time, device time, and the kernel's share of it;
6. prints one ``kernels`` JSON line, then ``{"ok": true, "device": ...}``.

Any failure raises and exits non-zero; nothing falls back to the CPU.
TF32 is off for matmuls and cuDNN convolutions (the model is fp32).
``--json PATH`` also writes every per-shape measurement to PATH.
"""
from __future__ import annotations

import argparse
import dataclasses
import json
import math
import subprocess
import sys
import time
from pathlib import Path

import numpy as np
import torch

sys.path.insert(0, str(Path(__file__).resolve().parent / "src"))

from repro_torch.common import tree_map  # noqa: E402
from repro_torch.core import nas, scenarios  # noqa: E402
from repro_torch.core.proxy import TrainedAccuracy, train_step  # noqa: E402
from repro_torch.core.search import SearchConfig  # noqa: E402
from repro_torch.core.session import SearchSession  # noqa: E402
from repro_torch.kernels import ibn_conv  # noqa: E402
from repro_torch.kernels.ref import ibn_pointwise_ref  # noqa: E402
from repro_torch.models import convnets as C  # noqa: E402

# H100 SXM, NVIDIA's data sheet: HBM3 rate, and the peak rate of each input
# type (fp32 outside the tensor cores, bf16 dense on them)
HBM_BYTES_PER_S = 3.35e12
PEAK_FLOP_PER_S = {torch.float32: 67e12, torch.bfloat16: 989e12}
# forward and backward tolerances, relative to the largest |plain value|:
# fp32 sums in another order (K up to 200k pixels for dw); bf16 rounds the
# output to 8 bits of mantissa
TOL = {torch.float32: 1e-4, torch.bfloat16: 2e-2}
LOGIT_TOL = 1e-3  # card vs CPU logits, absolute (cuDNN vs CPU conv sum order)
MAIN_PATH_SCENARIO = "lat-0.5ms"


def card_line() -> str:
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, check=True, timeout=60)
    return out.stdout.strip().splitlines()[0]


def time_ms(fn, iters: int = 20, warmup: int = 3) -> float:
    """Mean device time of ``fn`` over ``iters`` back-to-back calls (CUDA
    events; L2 stays warm between calls)."""
    for _ in range(warmup):
        fn()
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(iters):
        fn()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / iters


def bound_parts_ms(n: int, cin: int, cout: int, dtype=torch.float32) -> tuple[float, float]:
    """The two lower bounds of act(x @ w + b) in ms: bytes (each input read
    once, y written once) over the memory rate, and 2·N·Cin·Cout operations
    over the peak rate for the input type. The bound is the larger."""
    itemsize = torch.empty((), dtype=dtype).element_size()
    nbytes = itemsize * (n * cin + cin * cout + cout + n * cout)
    return (nbytes / HBM_BYTES_PER_S * 1e3,
            2.0 * n * cin * cout / PEAK_FLOP_PER_S[dtype] * 1e3)


def pointwise_shapes(spec: C.ConvNetSpec, batch: int) -> list[tuple[int, int, int]]:
    """(N, Cin, Cout) of every 1×1 conv of ``spec``, in order, repeats kept."""
    return [(batch * op.h * op.w, op.cin, op.cout) for op in C.layer_ops(spec)
            if op.op == "conv" and op.kernel == 1]


def search_space_shapes(batch: int, image_size: int) -> list[tuple[int, int, int]]:
    """Every 1×1 shape the search's MobileNetV2 space can give at the
    proxy's size: block shapes depend only on the block's expansion."""
    base = C.mobilenet_v2(10, image_size)
    shapes = []
    for e in (3, 6):
        blocks = tuple(dataclasses.replace(b, expansion=1 if i == 0 else e)
                       for i, b in enumerate(base.blocks))
        shapes += pointwise_shapes(dataclasses.replace(base, blocks=blocks), batch)
    return sorted(set(shapes))


def rel_err(got: torch.Tensor, want: torch.Tensor) -> tuple[float, float]:
    """(max |got - want|, that over max(1, max |want|))."""
    err = (got.float() - want.float()).abs().max().item()
    return err, err / max(1.0, want.float().abs().max().item())


def check_shape(n, cin, cout, act, dtype, gen, timed: bool) -> dict:
    """Forward and backward of the kernel against the plain version."""
    dev = "cuda"
    x = torch.randn((n, cin), generator=gen, device=dev).to(dtype)
    w = (torch.randn((cin, cout), generator=gen, device=dev) / math.sqrt(cin)).to(dtype)
    b = (torch.randn((cout,), generator=gen, device=dev) * 0.1).to(dtype)
    dy = torch.randn((n, cout), generator=gen, device=dev).to(dtype)
    tol = TOL[dtype]

    y = ibn_conv.launch(x, w, b, act)
    y_ref = ibn_pointwise_ref(x, w, b, act)
    torch.cuda.synchronize()
    fwd_abs, fwd_rel = rel_err(y, y_ref)

    leaves = [t.clone().requires_grad_(True) for t in (x, w, b)]
    ibn_conv.ibn_pointwise(*leaves, act=act).backward(dy)
    plain = [t.clone().requires_grad_(True) for t in (x, w, b)]
    ibn_pointwise_ref(*plain, act).backward(dy)
    torch.cuda.synchronize()
    bwd = [rel_err(a.grad, p.grad)[1] for a, p in zip(leaves, plain)]
    rec = {"n": n, "cin": cin, "cout": cout, "act": act, "dtype": str(dtype)[6:],
           "fwd_max_abs_err": fwd_abs, "fwd_rel_err": fwd_rel,
           "dx_rel_err": bwd[0], "dw_rel_err": bwd[1], "db_rel_err": bwd[2],
           "tol": tol}
    if max(fwd_rel, *bwd) > tol:
        raise AssertionError(f"ibn_pointwise disagrees with its plain version: {rec}")
    if timed:
        lib_act = {"none": lambda t: t, "relu": torch.relu, "silu": torch.nn.functional.silu}[act]
        rec["ms"] = time_ms(lambda: ibn_conv.launch(x, w, b, act))
        rec["plain_ms"] = time_ms(lambda: ibn_pointwise_ref(x, w, b, act))
        rec["library_ms"] = time_ms(lambda: lib_act(torch.addmm(b, x, w)))
        rec["bound_bytes_ms"], rec["bound_ops_ms"] = bound_parts_ms(n, cin, cout, dtype)
        rec["bound_ms"] = max(rec["bound_bytes_ms"], rec["bound_ops_ms"])
        rec["bound_by"] = ("bytes" if rec["bound_bytes_ms"] >= rec["bound_ops_ms"]
                           else "operations")
    return rec


def kernel_phase(card: str) -> dict:
    gen = torch.Generator(device="cuda").manual_seed(0)
    models = {"mobilenet_v2": C.mobilenet_v2(), "efficientnet_b0": C.efficientnet_b0(),
              "manual_edgetpu_s": C.manual_edgetpu(size="s")}
    per_model = {name: pointwise_shapes(spec, 8) for name, spec in models.items()}
    full = sorted({s for shapes in per_model.values() for s in shapes})
    search = search_space_shapes(64, 32)
    records = {}
    for shape in sorted(set(full) | set(search)):
        for act in ("none", "relu"):
            records[(shape, act, "fp32")] = check_shape(
                *shape, act, torch.float32, gen, timed=(act == "none"))
    # a few shapes in bf16 and with silu: first expand, a project, the head
    for shape in (per_model["mobilenet_v2"][0], per_model["efficientnet_b0"][1],
                  per_model["mobilenet_v2"][-1], search[0]):
        records[(shape, "silu", "fp32")] = check_shape(*shape, "silu", torch.float32,
                                                       gen, timed=False)
        for act in ("none", "silu"):
            records[(shape, act, "bf16")] = check_shape(*shape, act, torch.bfloat16,
                                                        gen, timed=(act == "none"))
    worst = max(max(r["fwd_rel_err"], r["dx_rel_err"], r["dw_rel_err"], r["db_rel_err"])
                / r["tol"] for r in records.values())
    print(f"kernel: {len(records)} checks at {len(full)} full-width shapes (224 px, "
          f"batch 8) and {len(search)} search shapes (32 px, batch 64), forward and "
          f"backward; worst error {worst:.3g} of its tolerance  [{card}]")

    def totals(shapes):
        rs = [records[(s, "none", "fp32")] for s in shapes]
        t = {k: sum(r[k] for r in rs) for k in ("ms", "plain_ms", "library_ms", "bound_ms",
                                                 "bound_bytes_ms", "bound_ops_ms")}
        t["bound_by"] = ("bytes" if t["bound_bytes_ms"] >= t["bound_ops_ms"]
                         else "operations")
        return t

    summary = {}
    for name, shapes in per_model.items():
        t = totals(shapes)
        summary[name] = t
        print(f"kernel: {name} 224 px batch 8, {len(shapes)} 1x1 convs per forward: "
              f"kernel {t['ms']:.4f} ms, plain {t['plain_ms']:.4f} ms, addmm "
              f"{t['library_ms']:.4f} ms, bound {t['bound_ms']:.4f} ms  [{card}]")
    largest = sorted(full, key=lambda s: -s[0] * s[1] * s[2])[:6]
    for shape in largest + [s for s in per_model["mobilenet_v2"][:1] if s not in largest]:
        r = records[(shape, "none", "fp32")]
        print(f"kernel: (N, Cin, Cout) = {shape} fp32: kernel {r['ms']:.4f} ms, plain "
              f"{r['plain_ms']:.4f} ms, addmm {r['library_ms']:.4f} ms, bound "
              f"{r['bound_ms']:.4f} ms ({r['bound_by']})  [{card}]")
    t = totals(search)
    summary["search_shapes"] = t
    print(f"kernel: the {len(search)} search shapes, one forward each: kernel "
          f"{t['ms']:.4f} ms, plain {t['plain_ms']:.4f} ms, addmm {t['library_ms']:.4f}"
          f" ms, bound {t['bound_ms']:.4f} ms  [{card}]")
    fp32_main = [records[(s, a, "fp32")] for s in search for a in ("none", "relu")]
    return {"records": list(records.values()), "summary": summary,
            "search_totals": t,
            "max_abs_err": max(r["fwd_max_abs_err"] for r in fp32_main),
            "max_rel_err_fwd": max(r["fwd_rel_err"] for r in records.values()),
            "max_rel_err_bwd": max(max(r["dx_rel_err"], r["dw_rel_err"], r["db_rel_err"])
                                   for r in records.values())}


def model_phase(card: str) -> dict:
    out = {}
    rng = np.random.default_rng(0)
    for name, spec in (("mobilenet_v2", C.mobilenet_v2()),
                       ("efficientnet_b0", C.efficientnet_b0()),
                       ("manual_edgetpu_s", C.manual_edgetpu(size="s"))):
        params = C.init(0, spec, device="cuda")
        cpu_params = tree_map(lambda t: t.cpu(), params)
        images = torch.from_numpy(rng.normal(size=(2, 224, 224, 3)).astype(np.float32))
        before = ibn_conv.LAUNCHES
        with torch.no_grad():
            logits = C.forward(params, images.cuda(), spec)
            torch.cuda.synchronize()
            fwd_launches = ibn_conv.LAUNCHES - before
            want = C.forward(cpu_params, images, spec)
        err = (logits.cpu() - want).abs().max().item()
        if not (torch.isfinite(logits).all() and logits.shape == (2, 1000)):
            raise AssertionError(f"{name}: bad logits {tuple(logits.shape)}")
        if err > LOGIT_TOL or fwd_launches == 0:
            raise AssertionError(f"{name}: card vs CPU logits differ by {err} "
                                 f"(tolerance {LOGIT_TOL}), {fwd_launches} launches")
        batch = torch.from_numpy(rng.normal(size=(16, 224, 224, 3)).astype(np.float32)).cuda()
        labels = torch.from_numpy(rng.integers(0, 1000, size=16)).cuda()
        losses, step_ms = [], []
        for i in range(5):
            before = ibn_conv.LAUNCHES
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            params, loss = train_step(params, batch, labels, spec, 0.05)
            losses.append(float(loss))
            step_ms.append((time.perf_counter() - t0) * 1e3)
            step_launches = ibn_conv.LAUNCHES - before
        if not all(math.isfinite(v) for v in losses):
            raise AssertionError(f"{name}: non-finite losses {losses}")
        print(f"model: {name} 224 px: card vs CPU logits max |diff| {err:.3g} (tolerance "
              f"{LOGIT_TOL}, max |logit| {want.abs().max().item():.3g}), {fwd_launches} "
              f"kernel launches per forward; train_step batch 16: losses "
              f"{[round(v, 4) for v in losses]}, {step_launches} launches per step, "
              f"{min(step_ms[1:]):.1f} ms per step  [{card}]")
        out[name] = {"logit_err": err, "fwd_launches": fwd_launches, "losses": losses,
                     "step_launches": step_launches, "step_ms": step_ms}
    return out


def search_phase(card: str) -> dict:
    session = SearchSession(
        nas.s1_mobilenetv2(),
        TrainedAccuracy(steps=40, batch=64, device="cuda"),
        cfg=SearchConfig(samples=16, batch=8, seed=0),
    )
    rcfg = scenarios.get(MAIN_PATH_SCENARIO).reward_config()
    torch.cuda.synchronize()
    ibn_conv.LAUNCHES = 0
    t0 = time.perf_counter()
    res = session.joint(rcfg=rcfg)
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    launches = ibn_conv.LAUNCHES
    trained = [h for h in res.history if h["valid"]]
    if not trained or res.best_record is None:
        raise AssertionError("the search produced no record with an accuracy")
    if launches == 0:
        raise AssertionError("the search never launched the ibn_pointwise kernel")
    evaluated = res.engine_stats["evaluated"]
    best = res.best_record
    print(f"search: s1_mbv2 x has, PPO on cuda, TrainedAccuracy(steps=40, batch=64) on "
          f"cuda, {len(res.history)} samples, {evaluated} evaluated, {len(trained)} "
          f"trained: wall {wall:.2f} s, {wall / max(evaluated, 1):.3f} s per candidate, "
          f"{launches} kernel launches  [{card}]")
    print(f"search: best record acc={best['accuracy']:.4f} lat={best['latency_ms']:.4f} ms "
          f"energy={best['energy_mj']:.4f} mJ area={best['area_mm2']:.2f} mm^2 "
          f"reward={best['reward']:.4f} meets={best.get('meets_constraints')}  [{card}]")
    return {"wall_s": wall, "evaluated": evaluated, "trained": len(trained),
            "launches": launches, "best": best}


def profile_phase(card: str) -> dict:
    """Where one search candidate's training step spends its time: the S1
    space's seed architecture (MobileNetV2) at the proxy's 32 px, batch 64.
    Wall time per step without the profiler, device time per step by kernel
    from ``torch.profiler`` over 3 steps."""
    from torch.profiler import ProfilerActivity, profile

    spec = C.mobilenet_v2(10, 32)
    params = C.init(0, spec, device="cuda")
    rng = np.random.default_rng(1)
    images = torch.from_numpy(rng.normal(size=(64, 32, 32, 3)).astype(np.float32)).cuda()
    labels = torch.from_numpy(rng.integers(0, 10, size=64)).cuda()
    steps = 3

    def run():
        nonlocal params
        for _ in range(steps):
            params, _ = train_step(params, images, labels, spec, 0.05)
        torch.cuda.synchronize()

    run()  # warm-up
    t0 = time.perf_counter()
    run()
    wall_ms = (time.perf_counter() - t0) * 1e3 / steps
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        run()
    per_kernel = {}
    for e in prof.key_averages():
        if e.device_type == torch.autograd.DeviceType.CUDA:
            us = getattr(e, "self_device_time_total", None)
            if us is None:
                us = e.self_cuda_time_total
            per_kernel[e.key] = us / 1e3 / steps
    device_ms = sum(per_kernel.values())
    ibn_ms = sum(v for k, v in per_kernel.items() if "pw_gemm" in k or "splitk_epilogue" in k)
    top = sorted(per_kernel.items(), key=lambda kv: -kv[1])[:6]
    if device_ms == 0.0:
        print(f"profile: train_step {wall_ms:.2f} ms; device time not measured (the "
              f"profiler saw no CUDA activity)  [{card}]")
    else:
        print(f"profile: train_step (mobilenet_v2, 32 px, batch 64) {wall_ms:.2f} ms wall, "
              f"{device_ms:.3f} ms on the device ({device_ms / wall_ms:.1%} busy), "
              f"ibn_pointwise {ibn_ms:.3f} ms ({ibn_ms / device_ms:.1%} of device time), "
              f"{len(per_kernel)} kernel names  [{card}]")
        for name, ms in top:
            print(f"profile:   {ms:.4f} ms/step  {name[:90]}")
    return {"wall_ms": wall_ms, "device_ms": device_ms, "ibn_ms": ibn_ms,
            "per_kernel_ms": per_kernel}


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--json", help="also write every measurement to this file")
    args = ap.parse_args()
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device; the port's kernels need an NVIDIA GPU",
              file=sys.stderr)
        return 1
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    card = card_line()
    print(card)
    print(f"torch {torch.__version__} cuda {torch.version.cuda}, "
          f"{torch.cuda.get_device_name(0)} x{torch.cuda.device_count()}, "
          f"matmul.allow_tf32={torch.backends.cuda.matmul.allow_tf32} "
          f"cudnn.allow_tf32={torch.backends.cudnn.allow_tf32}")

    t0 = time.perf_counter()
    lib = ibn_conv.build()
    print(f"build: {lib.name} in {time.perf_counter() - t0:.1f} s  [{card}]")
    print(ibn_conv.BUILD_LOG.strip())

    kern = kernel_phase(card)
    model = model_phase(card)
    search = search_phase(card)
    prof = profile_phase(card)

    t = kern["search_totals"]
    kernels = {"kernels": [{
        "name": "ibn_pointwise",
        "route": "cuda",
        "source": "src/repro_torch/kernels/csrc/ibn_pointwise.cu",
        "replaces": "src/repro/kernels/ibn_conv.py:49",
        "launches": search["launches"],
        "max_abs_err": kern["max_abs_err"],
        "ms": t["ms"],
        "plain_ms": t["plain_ms"],
        "bound_ms": t["bound_ms"],
        "bound_by": t["bound_by"],
        "library_ms": t["library_ms"],
        "max_rel_err_fwd": kern["max_rel_err_fwd"],
        "max_rel_err_bwd": kern["max_rel_err_bwd"],
    }]}
    if args.json:
        Path(args.json).parent.mkdir(parents=True, exist_ok=True)
        Path(args.json).write_text(json.dumps(
            {"card": card, "kernel": kern, "model": model, "search": search,
             "profile": prof, "kernels": kernels}, indent=1, default=str))
    print(json.dumps(kernels))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
