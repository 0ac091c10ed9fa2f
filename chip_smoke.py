#!/usr/bin/env python3
"""Chip smoke test of the PyTorch / CUDA port (``src/repro_torch``).

    python3 chip_smoke.py [--json PATH]

On one NVIDIA H100 (compute capability 9.0, ``nvcc`` on PATH or in
/usr/local/cuda) it:

1. build   — compiles the ``ibn_pointwise`` and ``flash_attention`` kernels
             from the repository's sources (one ``nvcc`` each, started
             together) and prints ptxas's report;
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
6. attention — holds ``flash_attention`` against its plain version on the
             card at tests/test_kernels.py's shapes (fp32 and bf16), causal
             with sq != skv, and the served model's prefill shape (B 8, H 16,
             KV 8, hd 128, bf16, causal, S 1024 and a ragged 1025); times the
             kernel, the plain version and ``scaled_dot_product_attention``;
7. serve   — the second main path: qwen3-1.7B at full width with
             ``attn_impl="flash_pallas"``, random weights from a seed on the
             card, 8 prompts of 1024 tokens through ``make_prefill_step``
             (exactly 28 kernel launches) and the ``return_cache`` forward,
             the k/v written into a preallocated 2048-position bf16 cache,
             32 greedy steps of ``make_decode_step``, the first step held
             against a forward over the prompt plus its token, 4 steps over
             int8 caches; ms per prefill and per decode step, tokens/s, and
             where the device time goes (torch.profiler);
8. llm     — the same model cut to 4 layers, batch 1, 64 tokens: the card's
             logits (kernel) against the port's CPU forward (plain version);
9. prints one ``kernels`` JSON line, then ``{"ok": true, "device": ...}``.

Each main path (search for ibn_pointwise, serve for flash_attention) runs
with every kernel's launch count set to 0 just before it and read just
after. Any failure raises and exits non-zero; nothing falls back to the CPU.
TF32 is off for matmuls and cuDNN convolutions.
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

from repro_torch import configs  # noqa: E402
from repro_torch.common import tree_leaves, tree_map  # noqa: E402
from repro_torch.core import nas, scenarios  # noqa: E402
from repro_torch.core.proxy import TrainedAccuracy, train_step  # noqa: E402
from repro_torch.core.search import SearchConfig  # noqa: E402
from repro_torch.core.session import SearchSession  # noqa: E402
from repro_torch.kernels import build as kbuild  # noqa: E402
from repro_torch.kernels import flash_attention, ibn_conv  # noqa: E402
from repro_torch.kernels.ref import flash_attention_ref, ibn_pointwise_ref  # noqa: E402
from repro_torch.models import api, transformer  # noqa: E402
from repro_torch.models import convnets as C  # noqa: E402
from repro_torch.serving import kvcache  # noqa: E402
from repro_torch.train import steps  # noqa: E402

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
# flash_attention against its plain version, absolute, inputs N(0, 1):
# tests/test_kernels.py's tolerances (fp32 sums in another order; bf16 rounds
# p and the output to 8 bits of mantissa)
ATTN_TOL = {torch.float32: 2e-5, torch.bfloat16: 2e-2}
DEV = "cuda"  # every tensor of the attention, serve and llm phases
# the served model's prefill attention: B, H, KV, S, hd (qwen3-1.7B, 8 x 1024)
SERVE_ATTN = (8, 16, 8, 1024, 128)
SERVE_ARCH = "qwen3_1_7b"
SERVE_BATCH, PROMPT, CACHE_LEN, DECODE_STEPS, INT8_STEPS = 8, 1024, 2048, 32, 4
# LLM logits relative to max |logit|. fp32: the card and the CPU sum in
# another order. bf16: every product and norm rounds to 8 bits of mantissa at
# other places (the card's against the CPU's products, decode's chunked
# attention against the prefill's kernel, one-row against many-row products),
# through up to 28 layers; a wrong mask or position moves logits by O(1).
LLM_TOL = {"float32": 1e-4, "bfloat16": 5e-2}
# int8 cache against the bf16 cache: every cached k/v moves by up to 1/254 of
# its row's largest value, in all 28 layers
INT8_TOL = 0.1


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
    flash_attention.LAUNCHES = 0
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


def attention_bound_parts_ms(b, h, kv, sq, skv, hd, causal, dtype) -> tuple[float, float]:
    """The two lower bounds of one attention call in ms: bytes (q, k, v read
    once, o written once) over the memory rate, and 4·hd operations per
    unmasked (q, k) pair over the peak rate for the input type."""
    itemsize = torch.empty((), dtype=dtype).element_size()
    nbytes = itemsize * (2 * b * h * sq * hd + 2 * b * kv * skv * hd)
    pairs = sum(min(i + 1, skv) for i in range(sq)) if causal else sq * skv
    return (nbytes / HBM_BYTES_PER_S * 1e3,
            4.0 * hd * pairs * b * h / PEAK_FLOP_PER_S[dtype] * 1e3)


def check_attention(b, h, kv, sq, skv, hd, causal, dtype, gen, timed: bool) -> dict:
    """flash_attention against its plain version on the card."""
    q = torch.randn((b, h, sq, hd), generator=gen, device=DEV).to(dtype)
    k = torch.randn((b, kv, skv, hd), generator=gen, device=DEV).to(dtype)
    v = torch.randn((b, kv, skv, hd), generator=gen, device=DEV).to(dtype)
    out = flash_attention.launch(q, k, v, causal=causal)
    want = flash_attention_ref(q, k, v, causal=causal)
    torch.cuda.synchronize()
    err = (out.float() - want.float()).abs().max().item()
    rec = {"shape": (b, h, kv, sq, skv, hd), "causal": causal, "dtype": str(dtype)[6:],
           "max_abs_err": err, "tol": ATTN_TOL[dtype]}
    if not err <= ATTN_TOL[dtype]:
        raise AssertionError(f"flash_attention disagrees with its plain version: {rec}")
    if timed:
        sdpa = torch.nn.functional.scaled_dot_product_attention
        lib = sdpa(q, k, v, is_causal=causal, enable_gqa=True)
        rec["library_err"] = (lib.float() - want.float()).abs().max().item()
        rec["ms"] = time_ms(lambda: flash_attention.launch(q, k, v, causal=causal))
        rec["plain_ms"] = time_ms(lambda: flash_attention_ref(q, k, v, causal=causal))
        rec["library_ms"] = time_ms(lambda: sdpa(q, k, v, is_causal=causal, enable_gqa=True))
        rec["bound_bytes_ms"], rec["bound_ops_ms"] = attention_bound_parts_ms(
            b, h, kv, sq, skv, hd, causal, dtype)
        rec["bound_ms"] = max(rec["bound_bytes_ms"], rec["bound_ops_ms"])
        rec["bound_by"] = ("bytes" if rec["bound_bytes_ms"] >= rec["bound_ops_ms"]
                           else "operations")
    return rec


def attention_phase(card: str) -> dict:
    gen = torch.Generator(device=DEV).manual_seed(1)
    records = []
    # tests/test_kernels.py's shapes, then causal with sq != skv
    for shape in ((1, 4, 4, 64, 64, 32, True), (2, 4, 2, 64, 64, 32, True),
                  (1, 8, 1, 128, 128, 64, True), (2, 4, 1, 96, 160, 32, False),
                  (1, 2, 2, 200, 200, 16, True), (1, 4, 2, 96, 160, 32, True),
                  (2, 4, 1, 160, 96, 16, True)):
        for dtype in (torch.float32, torch.bfloat16):
            records.append(check_attention(*shape, dtype, gen, timed=False))
    b, h, kv, s, hd = SERVE_ATTN
    ragged = check_attention(b, h, kv, s + 1, s + 1, hd, True, torch.bfloat16, gen, timed=False)
    main = check_attention(b, h, kv, s, s, hd, True, torch.bfloat16, gen, timed=True)
    records += [ragged, main]
    worst = max(r["max_abs_err"] / r["tol"] for r in records)
    print(f"attention: {len(records)} checks against the plain version (fp32 and bf16, "
          f"causal sq != skv, S {s} and {s + 1}); worst error {worst:.3g} of its "
          f"tolerance  [{card}]")
    print(f"attention: B {b} H {h} KV {kv} S {s} hd {hd} bf16 causal: kernel "
          f"{main['ms']:.4f} ms, plain {main['plain_ms']:.4f} ms, sdpa "
          f"{main['library_ms']:.4f} ms, bound {main['bound_ms']:.4f} ms ({main['bound_by']}; "
          f"bytes {main['bound_bytes_ms']:.4f}, operations {main['bound_ops_ms']:.4f}); "
          f"max |err| {main['max_abs_err']:.3g} (ragged S {s + 1}: "
          f"{ragged['max_abs_err']:.3g}), sdpa vs plain {main['library_err']:.3g}  [{card}]")
    return {"records": records, "main": main}


def _device_times(prof, steps_run: int) -> dict:
    """Device ms per run by kernel name from a finished torch.profiler."""
    out = {}
    for e in prof.key_averages():
        if e.device_type == torch.autograd.DeviceType.CUDA:
            us = getattr(e, "self_device_time_total", None)
            if us is None:
                us = e.self_cuda_time_total
            out[e.key] = us / 1e3 / steps_run
    return out


def _print_breakdown(label: str, wall_ms: float, per_kernel: dict, card: str) -> float:
    device_ms = sum(per_kernel.values())
    attn_ms = sum(v for k, v in per_kernel.items() if "attn_fwd" in k)
    if device_ms == 0.0:
        print(f"serve: {label} device time not measured (the profiler saw no CUDA "
              f"activity)  [{card}]")
        return 0.0
    print(f"serve: {label} {wall_ms:.2f} ms wall, {device_ms:.3f} ms on the device "
          f"({device_ms / wall_ms:.1%} busy), flash_attention {attn_ms:.3f} ms "
          f"({attn_ms / device_ms:.1%} of device time), {len(per_kernel)} kernel names  "
          f"[{card}]")
    for name, ms in sorted(per_kernel.items(), key=lambda kv: -kv[1])[:6]:
        print(f"serve:   {ms:.4f} ms  {name[:90]}")
    return attn_ms


def _rel(got: torch.Tensor, want: torch.Tensor) -> float:
    return ((got.float() - want.float()).abs().max() / want.float().abs().max()).item()


def serve_phase(card: str) -> dict:
    from torch.profiler import ProfilerActivity, profile

    run = configs.make_run(SERVE_ARCH, "decode_32k", model_attn_impl="flash_pallas")
    cfg = run.model
    prefill, _, _ = steps.make_prefill_step(run)
    decode, _, _, _ = steps.make_decode_step(run)
    t0 = time.perf_counter()
    params = api.init(0, cfg, device=DEV)
    torch.cuda.synchronize()
    init_s = time.perf_counter() - t0
    n_params = sum(t.numel() for t in tree_leaves(params))
    rng = np.random.default_rng(2)
    prompt = torch.from_numpy(rng.integers(0, cfg.vocab_size, size=(SERVE_BATCH, PROMPT))).to(DEV)
    prefill(params, {"tokens": prompt})  # warm-up: cuBLAS plans, the kernel's first launch
    torch.cuda.synchronize()

    # --- the main path: counts at 0 just before, read just after
    ibn_conv.LAUNCHES = 0
    flash_attention.LAUNCHES = 0
    t0 = time.perf_counter()
    logits = prefill(params, {"tokens": prompt})
    torch.cuda.synchronize()
    prefill_ms = (time.perf_counter() - t0) * 1e3
    prefill_launches = flash_attention.LAUNCHES
    if prefill_launches != cfg.num_layers:
        raise AssertionError(f"prefill launched flash_attention {prefill_launches} times, "
                             f"not once per layer ({cfg.num_layers})")
    if logits.shape != (SERVE_BATCH, PROMPT, cfg.vocab_size) or not torch.isfinite(logits).all():
        raise AssertionError(f"bad prefill logits {tuple(logits.shape)}")
    first = logits[:, -1:].argmax(dim=-1).to(torch.int32)
    del logits
    with torch.no_grad():
        _, pre = transformer.forward(params, {"tokens": prompt}, cfg, return_cache=True)
    cache = kvcache.cache_update(api.init_cache(cfg, SERVE_BATCH, CACHE_LEN, "bfloat16", DEV),
                                 pre["k"].transpose(-3, -2), pre["v"].transpose(-3, -2), 0)
    tok, tokens, step_ms = first, [first], []
    for i in range(DECODE_STEPS):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        tok, lg, cache = decode(params, cache, tok, PROMPT + i)
        torch.cuda.synchronize()
        step_ms.append((time.perf_counter() - t0) * 1e3)
        if i == 0:
            first_step = lg[:, 0].float()
        if not torch.isfinite(lg).all():
            raise AssertionError(f"decode step {i}: non-finite logits")
        tokens.append(tok)
    path = {"flash_attention": flash_attention.LAUNCHES, "ibn_pointwise": ibn_conv.LAUNCHES}
    if path["flash_attention"] != 2 * cfg.num_layers:
        raise AssertionError(f"the serve path launched flash_attention "
                             f"{path['flash_attention']} times, not {2 * cfg.num_layers}")
    tokens = torch.cat(tokens, dim=1)
    if tokens.min() < 0 or tokens.max() >= cfg.vocab_size:
        raise AssertionError("decode produced token ids outside the vocabulary")

    # --- decode against a forward over the prompt plus the first token (S 1025)
    with torch.no_grad():
        full = transformer.forward(params, {"tokens": torch.cat([prompt, first], dim=1)}, cfg)
    want = full[:, PROMPT].float()
    del full
    decode_err = _rel(first_step, want)
    agree = (first_step.argmax(-1) == want.argmax(-1)).float().mean().item()
    if not decode_err <= LLM_TOL["bfloat16"]:
        raise AssertionError(f"first decode step vs forward: {decode_err} relative to max "
                             f"|logit| (tolerance {LLM_TOL['bfloat16']})")

    # --- a few steps over int8 caches (eager and lazy dequantization)
    int8 = {}
    for lazy in (False, True):
        qrun = run.replace(model=cfg.scaled(lazy_kv_dequant=lazy))
        qdecode, _, _, _ = steps.make_decode_step(qrun)
        qcache = kvcache.cache_update(api.init_cache(cfg, SERVE_BATCH, CACHE_LEN, "int8", DEV),
                                      pre["k"].transpose(-3, -2), pre["v"].transpose(-3, -2), 0)
        qtoks = []
        for i in range(INT8_STEPS):
            qtok, qlg, qcache = qdecode(params, qcache, tokens[:, i:i + 1], PROMPT + i)
            if i == 0:
                qerr = _rel(qlg[:, 0], first_step)
            if not torch.isfinite(qlg).all():
                raise AssertionError(f"int8 decode step {i}: non-finite logits")
            qtoks.append(qtok)
        qagree = (torch.cat(qtoks, 1) == tokens[:, 1:INT8_STEPS + 1]).float().mean().item()
        if not qerr <= INT8_TOL:
            raise AssertionError(f"int8 (lazy={lazy}) first step vs bf16 cache: {qerr} "
                                 f"(tolerance {INT8_TOL})")
        int8["lazy" if lazy else "eager"] = {"first_step_rel_err": qerr, "token_agreement": qagree}
        del qcache
    del pre

    # --- steady-state timing and where the device time goes
    times = []
    for _ in range(3):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        prefill(params, {"tokens": prompt})
        torch.cuda.synchronize()
        times.append((time.perf_counter() - t0) * 1e3)
    prefill_ms_steady = min(times)
    decode_ms = float(np.median(step_ms[1:]))
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        prefill(params, {"tokens": prompt})
        torch.cuda.synchronize()
    prefill_kernels = _device_times(prof, 1)
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        decode(params, cache, tokens[:, -1:], PROMPT + DECODE_STEPS)
        torch.cuda.synchronize()
    decode_kernels = _device_times(prof, 1)

    print(f"serve: {SERVE_ARCH} full width ({n_params / 1e9:.3f} B params, fp32 weights, bf16 "
          f"compute, attn_impl=flash_pallas), init on the card {init_s:.1f} s  [{card}]")
    print(f"serve: prefill {SERVE_BATCH} x {PROMPT} tokens: {prefill_ms:.2f} ms on the main "
          f"path, {prefill_ms_steady:.2f} ms steady ({SERVE_BATCH * PROMPT / prefill_ms_steady * 1e3:.0f} "
          f"tokens/s), {prefill_launches} flash_attention launches  [{card}]")
    print(f"serve: decode {DECODE_STEPS} greedy steps over a {CACHE_LEN}-position bf16 cache: "
          f"{decode_ms:.2f} ms per step (median; first {step_ms[0]:.2f} ms), "
          f"{SERVE_BATCH / decode_ms * 1e3:.1f} tokens/s; main path launches {path}  [{card}]")
    print(f"serve: first decode step vs forward over prompt + token at position {PROMPT}: "
          f"{decode_err:.3g} of max |logit| (tolerance {LLM_TOL['bfloat16']}), argmax agreement "
          f"{agree:.3f}  [{card}]")
    for name, r in int8.items():
        print(f"serve: int8 cache ({name} dequantization), {INT8_STEPS} steps: first step "
              f"{r['first_step_rel_err']:.3g} of max |logit| from the bf16 cache's (tolerance "
              f"{INT8_TOL}), greedy tokens agree {r['token_agreement']:.3f}  [{card}]")
    attn_ms = _print_breakdown(f"prefill ({SERVE_BATCH} x {PROMPT})", prefill_ms_steady,
                               prefill_kernels, card)
    _print_breakdown("decode step", decode_ms, decode_kernels, card)
    return {"n_params": n_params, "init_s": init_s, "prefill_ms": prefill_ms,
            "prefill_ms_steady": prefill_ms_steady, "prefill_times_ms": times,
            "prefill_launches": prefill_launches, "path_launches": path,
            "decode_step_ms": step_ms, "decode_ms": decode_ms,
            "decode_vs_forward_rel_err": decode_err, "decode_vs_forward_argmax_agreement": agree,
            "int8": int8, "prefill_attention_device_ms": attn_ms,
            "prefill_device_ms": sum(prefill_kernels.values()),
            "decode_device_ms": sum(decode_kernels.values()),
            "prefill_kernels_ms": prefill_kernels, "decode_kernels_ms": decode_kernels}


def llm_phase(card: str) -> dict:
    """Full width cut to 4 layers, batch 1, 64 tokens: the card (kernel)
    against the port's CPU forward (plain version) on the same params."""
    out = {}
    for compute in ("float32", "bfloat16"):
        cfg = configs.get(SERVE_ARCH).scaled(num_layers=4, attn_impl="flash_pallas",
                                             compute_dtype=compute)
        tokens = torch.from_numpy(np.random.default_rng(3).integers(0, cfg.vocab_size,
                                                                    size=(1, 64)))
        params = transformer.init(1, cfg, device=DEV)
        before = flash_attention.LAUNCHES
        with torch.no_grad():
            got = transformer.forward(params, {"tokens": tokens.to(DEV)}, cfg)
            torch.cuda.synchronize()
            launches = flash_attention.LAUNCHES - before
            want = transformer.forward(tree_map(lambda t: t.cpu(), params), {"tokens": tokens}, cfg)
        err = _rel(got.cpu(), want)
        if not (torch.isfinite(got).all() and got.shape == (1, 64, cfg.vocab_size)):
            raise AssertionError(f"llm: bad logits {tuple(got.shape)}")
        if not err <= LLM_TOL[compute] or launches != cfg.num_layers:
            raise AssertionError(f"llm {compute}: card vs CPU logits {err} of max |logit| "
                                 f"(tolerance {LLM_TOL[compute]}), {launches} launches")
        print(f"llm: {SERVE_ARCH} full width cut to 4 layers, 64 tokens, {compute} compute: card "
              f"vs CPU logits {err:.3g} of max |logit| (tolerance {LLM_TOL[compute]}), "
              f"{launches} flash_attention launches  [{card}]")
        out[compute] = {"rel_err": err, "launches": launches}
        del params
    return out


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
    libs = kbuild.build(ibn_conv.SOURCE, flash_attention.SOURCE)
    print(f"build: {', '.join(lib.name for lib in libs)} in {time.perf_counter() - t0:.1f} s  "
          f"[{card}]")
    for log in kbuild.LOGS.values():
        print(log.strip())

    phase_s = {}

    def timed(name, fn):
        t = time.perf_counter()
        result = fn(card)
        phase_s[name] = time.perf_counter() - t
        return result

    kern = timed("kernel", kernel_phase)
    model = timed("model", model_phase)
    search = timed("search", search_phase)
    prof = timed("profile", profile_phase)
    attn = timed("attention", attention_phase)
    serve = timed("serve", serve_phase)
    llm = timed("llm", llm_phase)
    print("phases (s): " + ", ".join(f"{k} {v:.1f}" for k, v in phase_s.items()))

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
    }, {
        "name": "flash_attention",
        "route": "cuda",
        "source": "src/repro_torch/kernels/csrc/flash_attention.cu",
        "replaces": "src/repro/kernels/flash_attention.py:88",
        "launches": serve["path_launches"]["flash_attention"],
        "max_abs_err": attn["main"]["max_abs_err"],
        "ms": attn["main"]["ms"],
        "plain_ms": attn["main"]["plain_ms"],
        "bound_ms": attn["main"]["bound_ms"],
        "bound_by": attn["main"]["bound_by"],
        "library_ms": attn["main"]["library_ms"],
        "launches_per_prefill": serve["prefill_launches"],
    }]}
    if args.json:
        Path(args.json).parent.mkdir(parents=True, exist_ok=True)
        Path(args.json).write_text(json.dumps(
            {"card": card, "kernel": kern, "model": model, "search": search,
             "profile": prof, "attention": attn, "serve": serve, "llm": llm,
             "phase_s": phase_s, "kernels": kernels}, indent=1, default=str))
    print(json.dumps(kernels))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
