"""The CUDA kernels on the card against their plain PyTorch versions:
ibn_pointwise, flash_attention, ssd_scan and gmm, forward and backward, and
the prefills of the dense transformer (flash_attention), the
Mamba2 LM (ssd_scan), the MoE transformer (gmm) and the hybrid
(flash_attention and ssd_scan) against the port's CPU forward, their
training steps (loss, gradients, an AdamW update, each kernel's launches
per step under remat "none" and "full", and planted faults the gradient
limit must see) against the port's CPU step, and the
oneshot supernet (ibn_pointwise) and the learned cost model against the
port's CPU run, the pod mesh search with its PPO updates on the card
against the same search on the CPU, and a sweep whose spawned workers train
their candidates on the card against the serial sweep, and two threads
training at once on the card against each training alone, and the
parallel substrate on the card (a 4-rank sharded train step against the
unsharded one, the launcher under ``torchrun --mesh 2x2``, the kernels
refusing a DTensor). Every test here carries the ``cuda`` marker
and skips without an NVIDIA GPU; this file imports no JAX, so it runs on a
machine with the card and PyTorch alone:

    PYTHONPATH=src python -m pytest -m cuda tests/test_torch_cuda.py -q
"""
import dataclasses
import sys
from pathlib import Path

import numpy as np
import pytest

torch = pytest.importorskip("torch")

from repro_torch.common import tree_leaves, tree_map  # noqa: E402
from repro_torch.config import SHAPES as LLM_SHAPES  # noqa: E402
from repro_torch.config import ModelConfig, RunConfig, ShapeConfig, TrainConfig  # noqa: E402
from repro_torch.core import costmodel, has, meshsearch, oneshot  # noqa: E402
from repro_torch.kernels import build as kbuild  # noqa: E402
from repro_torch.kernels import flash_attention as tflash  # noqa: E402
from repro_torch.kernels import gmm as tgmm  # noqa: E402
from repro_torch.kernels import ibn_conv, ops  # noqa: E402
from repro_torch.kernels import ssd_scan as tssd  # noqa: E402
from repro_torch.kernels import ref as kref  # noqa: E402
from repro_torch.kernels.ref import (flash_attention_ref, gmm_ref,  # noqa: E402
                                     ibn_pointwise_ref, ssd_chunked, ssd_scan_ref)
from repro_torch.models import api, moe, transformer  # noqa: E402
from repro_torch.models import convnets as C  # noqa: E402
from repro_torch.data.synthetic import LMStream  # noqa: E402
from repro_torch.train import steps  # noqa: E402
from repro_torch.train.optim import make_optimizer  # noqa: E402

sys.path.insert(0, str(Path(__file__).resolve().parents[1]))
import chip_smoke  # noqa: E402  (its phases run only under __main__)

TOL = {"float32": 1e-4, "bfloat16": 2e-2}
SHAPES = [
    (256, 32, 64, "relu"), (100, 48, 40, "silu"), (512, 128, 96, "none"),
    (64, 16, 8, "relu"), (77, 13, 50, "silu"), (130, 70, 33, "relu"),
    (100352, 16, 96, "none"), (392, 320, 1280, "none"), (8, 96, 4, "relu"),
]


def _inputs(n, ci, co, seed=0):
    rng = np.random.default_rng(seed)
    x = rng.normal(size=(n, ci)).astype(np.float32)
    w = (rng.normal(size=(ci, co)) * 0.25 / np.sqrt(ci)).astype(np.float32)
    b = (rng.normal(size=(co,)) * 0.25).astype(np.float32)
    return x, w, b


def _need_card():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU")


@pytest.mark.cuda
def test_kernel_refuses_devices_below_sm90(monkeypatch):
    _need_card()
    x, w, b = (torch.from_numpy(a).cuda() for a in _inputs(8, 4, 4))
    monkeypatch.setitem(kbuild.DEVICES, x.device.index, ((8, 0), 132))
    with pytest.raises(RuntimeError, match="capability 8.0"):
        ops.ibn_pointwise(x, w, b, act="relu")


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("n,ci,co,act", SHAPES)
def test_kernel_matches_plain_version_on_card(n, ci, co, act, dtype):
    _need_card()
    if torch.cuda.get_device_capability() < (9, 0):
        pytest.skip("the kernel is built for sm_90a")
    td = getattr(torch, dtype)
    x, w, b = (torch.from_numpy(a).cuda().to(td) for a in _inputs(n, ci, co))
    before = ibn_conv.LAUNCHES
    got = ops.ibn_pointwise(x, w, b, act=act)
    torch.cuda.synchronize()
    assert ibn_conv.LAUNCHES == before + 1
    want = ibn_pointwise_ref(x, w, b, act)
    assert torch.max(torch.abs(got.float() - want.float())).item() < TOL[dtype]


@pytest.mark.cuda
@pytest.mark.parametrize("act", ["relu", "silu", "none"])
@pytest.mark.parametrize("n,ci,co", [(130, 70, 33), (50176, 24, 144), (8, 96, 4)])
def test_kernel_gradient_matches_plain_version_on_card(n, ci, co, act):
    _need_card()
    if torch.cuda.get_device_capability() < (9, 0):
        pytest.skip("the kernel is built for sm_90a")
    x, w, b = (torch.from_numpy(a).cuda() for a in _inputs(n, ci, co, seed=1))
    dy = torch.from_numpy(np.random.default_rng(2).normal(size=(n, co)).astype(np.float32)).cuda()
    ours = [t.clone().requires_grad_(True) for t in (x, w, b)]
    plain = [t.clone().requires_grad_(True) for t in (x, w, b)]
    before = ibn_conv.LAUNCHES
    ops.ibn_pointwise(*ours, act=act).backward(dy)
    ibn_pointwise_ref(*plain, act).backward(dy)
    torch.cuda.synchronize()
    # forward, dx and dw (and silu's recomputed z) each launch the kernel
    assert ibn_conv.LAUNCHES - before == (4 if act == "silu" else 3)
    for a, p in zip(ours, plain):
        scale = max(1.0, p.grad.abs().max().item())
        assert (a.grad - p.grad).abs().max().item() / scale < TOL["float32"]


# the Hopper body's edges, (M, K, N, how x and w lie): K 960 split across a
# cluster, the backward's dw at K 16384 (xᵀ @ dz) and dx (dz @ wᵀ), ragged M
# and N, one row, every layout of the two operands, and squeeze-excite's 6
# channels (rows under 16 bytes: the wrapper copies them)
K1_EDGES = [(64, 960, 160, "x", "w"), (64, 960, 320, "x", "w"), (16, 16384, 48, "xT", "w"),
            (48, 16384, 96, "xT", "w"), (16384, 48, 16, "x", "wT"), (77, 130, 33, "x", "w"),
            (1000, 70, 50, "xT", "wT"), (1, 96, 1280, "x", "w"), (131, 4096, 45, "x", "wT"),
            (8, 6, 144, "x", "w"), (8, 144, 6, "x", "w")]


def _k1_operands(m, k, n, la, lb, td, seed=16):
    rng = np.random.default_rng(seed)
    a = torch.from_numpy(rng.normal(size=(k, m) if la == "xT" else (m, k)).astype(np.float32))
    b = torch.from_numpy((rng.normal(size=(n, k) if lb == "wT" else (k, n)) / np.sqrt(k))
                         .astype(np.float32))
    bias = torch.from_numpy((rng.normal(size=(n,)) * 0.1).astype(np.float32)).cuda().to(td)
    a = a.cuda().to(td)
    b = b.cuda().to(td)
    return (a.t() if la == "xT" else a), (b.t() if lb == "wT" else b), bias


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("m,k,n,la,lb", K1_EDGES)
def test_kernel_edges_match_plain_version_on_card(m, k, n, la, lb, dtype):
    _need_sm90()
    td = getattr(torch, dtype)
    a, b, bias = _k1_operands(m, k, n, la, lb, td)
    before = ibn_conv.LAUNCHES
    got = ibn_conv.launch(a, b, bias, "relu")
    torch.cuda.synchronize()
    assert ibn_conv.LAUNCHES == before + 1  # one launch, split K or not
    assert got.dtype == td and got.shape == (m, n) and got.is_contiguous()
    want = ibn_pointwise_ref(a, b, bias, "relu")
    scale = max(1.0, want.float().abs().max().item())
    assert (got.float() - want.float()).abs().max().item() / scale < TOL[dtype]


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("m,k,n,la,lb", [K1_EDGES[0], K1_EDGES[2]])
def test_kernel_split_k_controls_fail_the_limit(m, k, n, la, lb, dtype):
    """The limit is tight enough to see a fault in the split-K sum: the
    product without one cluster rank's K range (the first, the last), or
    without the last K step of the last rank, breaks it."""
    _need_sm90()
    td = getattr(torch, dtype)
    a, b, bias = _k1_operands(m, k, n, la, lb, td)
    index = a.device.index
    (_, _, step), splits, k_chunk = ibn_conv.plan(m, n, k, td, kbuild.device_info(index)[1],
                                                  ibn_conv._max_cluster(index))
    assert splits > 1
    want = ibn_pointwise_ref(a, b, bias, "none").float()
    scale = max(1.0, want.abs().max().item())
    last = (k - 1) // k_chunk
    last_step = last * k_chunk + (k - 1 - last * k_chunk) // step * step
    for lo, hi in ((last * k_chunk, k), (0, k_chunk), (last_step, k)):
        cut = a.clone()
        cut[:, lo:hi] = 0
        ctl = ibn_pointwise_ref(cut, b, bias, "none").float()
        assert (ctl - want).abs().max().item() / scale > TOL[dtype], (lo, hi)
    got = ibn_conv.launch(a, b, bias, "none").float()
    assert (got - want).abs().max().item() / scale < TOL[dtype]
    assert torch.equal(ibn_conv.launch(a, b, bias, "none").float(), got)  # a fixed order


# flash_attention: tests/test_kernels.py's shapes, causal with sq != skv, a
# ragged tile, then every other head_dim of the configs (hubert-xlarge's 80,
# zamba2-7b's 112, gemma-2b's 256) with G 1, 2 and 8 at lengths that are not
# multiples of the kv tile, causal with sq != skv both ways, and a single
# row and a tile shorter than the kv tile; (b, h, kv, sq, skv, hd, causal)
ATTN_SHAPES = [
    (1, 4, 4, 64, 64, 32, True), (2, 4, 2, 64, 64, 32, True), (1, 8, 1, 128, 128, 64, True),
    (2, 4, 1, 96, 160, 32, False), (1, 2, 2, 200, 200, 16, True),
    (1, 4, 2, 96, 160, 32, True), (2, 4, 1, 160, 96, 16, True), (1, 16, 8, 1025, 1025, 128, True),
    (2, 8, 8, 1000, 1000, 80, True), (1, 8, 4, 1000, 1025, 112, True),
    (1, 8, 1, 1025, 1000, 256, True), (2, 4, 2, 300, 1025, 80, False),
    (1, 16, 2, 1000, 1000, 112, False), (1, 2, 2, 130, 70, 256, False),
    (2, 4, 2, 1, 1, 128, True), (1, 4, 4, 40, 77, 64, False),
]
ATTN_TOL = {"float32": 2e-5, "bfloat16": 2e-2}
# bf16 also per row, relative to the row's largest |plain value| (two bf16
# steps; chip_smoke.ATTN_ROW_TOL says why)
ATTN_ROW_TOL = 2.0 ** -6


def _need_sm90():
    _need_card()
    if torch.cuda.get_device_capability() < (9, 0):
        pytest.skip("the kernel is built for sm_90a")


def _attention_inputs(rng, b, h, kv, sq, skv, hd, td, layout):
    """q (B, H, Sq, hd), k and v (B, KV, Skv, hd): transposed views of
    (B, S, H, hd) tensors, as ``ops.flash_attention`` passes the model's,
    or contiguous."""
    def draw(heads, rows):
        shape = (b, rows, heads, hd) if layout == "bshd" else (b, heads, rows, hd)
        t = torch.from_numpy(rng.normal(size=shape).astype(np.float32)).cuda().to(td)
        return t.transpose(1, 2) if layout == "bshd" else t

    return draw(h, sq), draw(kv, skv), draw(kv, skv)


@pytest.mark.cuda
@pytest.mark.parametrize("layout", ["bshd", "bhsd"])
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("b,h,kv,sq,skv,hd,causal", ATTN_SHAPES)
def test_flash_attention_matches_plain_version_on_card(b, h, kv, sq, skv, hd, causal, dtype,
                                                       layout):
    _need_sm90()
    rng = np.random.default_rng(3)
    td = getattr(torch, dtype)
    q, k, v = _attention_inputs(rng, b, h, kv, sq, skv, hd, td, layout)
    before = tflash.LAUNCHES
    got = tflash.flash_attention(q, k, v, causal=causal)
    torch.cuda.synchronize()
    assert tflash.LAUNCHES == before + 1
    assert got.dtype == td and got.shape == q.shape
    want = flash_attention_ref(q, k, v, causal=causal).float()
    err = torch.abs(got.float() - want)
    assert torch.max(err).item() < ATTN_TOL[dtype]
    if dtype == "bfloat16":
        row = err.amax(dim=-1) / want.abs().amax(dim=-1).clamp_min(1e-30)
        assert torch.max(row).item() <= ATTN_ROW_TOL


@pytest.mark.cuda
def test_flash_attention_takes_model_layout_views_and_refuses_what_it_cannot_run(monkeypatch):
    _need_sm90()
    rng = np.random.default_rng(4)
    q, k, v = (torch.from_numpy(rng.normal(size=s).astype(np.float32)).cuda()
               for s in ((2, 40, 4, 64), (2, 40, 2, 64), (2, 40, 2, 64)))
    got = ops.flash_attention(q, k, v, causal=True)  # (B, S, H, hd) views, no copies
    want = flash_attention_ref(q.transpose(1, 2), k.transpose(1, 2), v.transpose(1, 2),
                               causal=True).transpose(1, 2)
    assert got.shape == q.shape and got.is_contiguous()
    assert torch.max(torch.abs(got - want)).item() < ATTN_TOL["float32"]
    with pytest.raises(ValueError, match="head_dim"):
        tflash.launch(q[..., :48].transpose(1, 2), k[..., :48].transpose(1, 2),
                      v[..., :48].transpose(1, 2), causal=True)
    # bf16 views whose head stride (72) is not 16-byte aligned: the wrapper
    # copies them for TMA, one launch
    wide = [torch.nn.functional.pad(t, (0, 8)).bfloat16()[..., :64] for t in (q, k, v)]
    assert wide[0].stride(2) == 72
    before = tflash.LAUNCHES
    got = ops.flash_attention(*wide, causal=True)
    assert tflash.LAUNCHES == before + 1
    want = flash_attention_ref(*(t.transpose(1, 2) for t in wide), causal=True).transpose(1, 2)
    assert torch.max(torch.abs(got.float() - want.float())).item() < ATTN_TOL["bfloat16"]
    with pytest.raises(TypeError, match="float32 or bfloat16"):
        tflash.launch(*(t.half().transpose(1, 2) for t in (q, k, v)), causal=True)
    monkeypatch.setitem(kbuild.DEVICES, q.device.index, ((8, 0), 132))
    with pytest.raises(RuntimeError, match="capability 8.0"):
        ops.flash_attention(q, k, v, causal=True)


@pytest.mark.cuda
def test_prefill_on_card_launches_the_kernel_once_per_layer():
    _need_sm90()
    cfg = ModelConfig(name="t", num_layers=3, d_model=256, num_heads=4, num_kv_heads=2,
                      head_dim=64, d_ff=512, vocab_size=1000, use_qk_norm=True,
                      attn_impl="flash_pallas", compute_dtype="float32")
    params = transformer.init(0, cfg, device="cuda")
    toks = torch.from_numpy(np.random.default_rng(5).integers(0, 1000, size=(2, 77))).cuda()
    before = tflash.LAUNCHES
    with torch.no_grad():
        got = transformer.forward(params, {"tokens": toks}, cfg)
        torch.cuda.synchronize()
        assert tflash.LAUNCHES == before + cfg.num_layers
        want = transformer.forward(tree_map(lambda t: t.cpu(), params), {"tokens": toks.cpu()},
                                   cfg)
    assert torch.max(torch.abs(got.cpu() - want)).item() / want.abs().max().item() < 1e-4


@pytest.mark.cuda
def test_hybrid_prefill_on_card_launches_attention_once_per_shared_block():
    """A Zamba2-style hybrid with zamba2-7b's head_dim 112 under
    ``flash_pallas``: one flash_attention launch per application of the
    shared block, one ssd_scan per Mamba2 layer; fp32 logits on the card
    against the port's CPU forward."""
    _need_sm90()
    cfg = ModelConfig(family="hybrid", name="t-hybrid", num_layers=5, hybrid_attn_every=2,
                      d_model=128, num_heads=4, num_kv_heads=2, head_dim=112, d_ff=256,
                      vocab_size=1000, ssm_state=64, ssm_head_dim=32, ssm_chunk=32,
                      attn_impl="flash_pallas", compute_dtype="float32")
    params = api.init(0, cfg, device="cuda")
    toks = torch.from_numpy(np.random.default_rng(10).integers(0, 1000, size=(2, 77))).cuda()
    before = (tflash.LAUNCHES, tssd.LAUNCHES)
    with torch.no_grad():
        got, _ = api.forward(params, {"tokens": toks}, cfg)
        torch.cuda.synchronize()
        assert tflash.LAUNCHES - before[0] == cfg.num_layers // cfg.hybrid_attn_every
        assert tssd.LAUNCHES - before[1] == cfg.num_layers
        want, _ = api.forward(tree_map(lambda t: t.cpu(), params), {"tokens": toks.cpu()}, cfg)
    assert torch.max(torch.abs(got.cpu() - want)).item() / want.abs().max().item() < 1e-4


# ssd_scan: tests/test_kernels.py's shapes, a ragged tail with G > 1, a chunk
# longer than S, mamba2-370m's widths at a ragged S, and zamba2-7b's; then the
# cluster's edges: S 4096 and 8192 (16 and 32 chunks over groups of a
# cluster), S 2300 (9 chunks, not a multiple of the cluster), B 1 H 8 S 4096
# (a cluster of 8), one chunk (S <= Q), G 4 with a ragged tail;
# (b, s, h, p, g, n, chunk)
SSD_SHAPES = [
    (2, 64, 4, 16, 1, 32, 16), (1, 128, 4, 8, 2, 16, 32), (2, 96, 2, 32, 1, 64, 32),
    (1, 48, 8, 16, 4, 8, 48), (1, 37, 4, 16, 2, 16, 16), (2, 20, 2, 8, 1, 8, 64),
    (2, 1000, 32, 64, 1, 128, 256), (1, 300, 112, 64, 1, 64, 256),
    (2, 4096, 32, 64, 1, 128, 256), (2, 8192, 32, 64, 1, 128, 256),
    (2, 2300, 32, 64, 1, 128, 256), (1, 4096, 8, 64, 1, 128, 256),
    (2, 200, 32, 64, 1, 128, 256), (2, 1100, 32, 64, 4, 128, 256),
]
SSD_EDGES = SSD_SHAPES[8:]
# relative to max |plain value|: fp32, the chunk's cumsum is a scan in
# another order and the products sum in another order, which moves
# exp(cs_i - cs_j) by ~1e-5 where |cs| reaches hundreds; bf16 rounds y to 8
# bits of mantissa
SSD_TOL = {"float32": 1e-3, "bfloat16": 2e-2}


def _ssd_inputs(b, s, h, p, g, n, dtype, seed=6, ranges="normal"):
    """x, dt, A and B, C as views into one (B, S, 2GN) tensor, as the model
    passes them. ``ranges`` "normal": dt softplus of a normal, A -exp of a
    normal (a decay of about e^-1 a position); "model": mamba2's ranges
    (dt = softplus(d + 0.5 normal) with softplus(d) log-uniform in [1e-3,
    1e-1] per head, A uniform in [-16, -1]), under which the state carries
    across chunks."""
    rng = np.random.default_rng(seed)
    td = getattr(torch, dtype)
    x = torch.from_numpy(rng.normal(size=(b, s, h, p)).astype(np.float32)).cuda().to(td)
    if ranges == "model":
        d0 = np.exp(rng.uniform(np.log(1e-3), np.log(1e-1), size=(h,)))
        dt = np.log1p(np.exp(np.log(np.expm1(d0)) + 0.5 * rng.normal(size=(b, s, h))))
        A = -rng.uniform(1.0, 16.0, size=(h,))
    else:
        dt = np.log1p(np.exp(rng.normal(size=(b, s, h))))
        A = -np.exp(rng.normal(size=(h,)))
    dt = torch.from_numpy(dt.astype(np.float32)).cuda()
    A = torch.from_numpy(A.astype(np.float32)).cuda()
    bc = torch.from_numpy(rng.normal(size=(b, s, 2 * g * n)).astype(np.float32)).cuda().to(td)
    return x, dt, A, bc[..., :g * n].reshape(b, s, g, n), bc[..., g * n:].reshape(b, s, g, n)


def _rel_to_max(got, want):
    return (torch.max(torch.abs(got.float() - want.float())) / want.float().abs().max()).item()


def _grad_rel(got, want):
    """Over max(1, max |want|): absolute below 1 (a single query row's dq
    and dk are 0 up to rounding)."""
    return (torch.max(torch.abs(got.float() - want.float()))
            / want.float().abs().max().clamp_min(1.0)).item()


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("b,s,h,p,g,n,chunk", SSD_SHAPES)
def test_ssd_scan_matches_plain_version_on_card(b, s, h, p, g, n, chunk, dtype):
    _need_sm90()
    x, dt, A, Bm, Cm = _ssd_inputs(b, s, h, p, g, n, dtype)
    assert not Bm.is_contiguous()  # the kernel reads the views' strides
    before = tssd.LAUNCHES
    y, st = ops.ssd_scan(x, dt, A, Bm, Cm, chunk=chunk)
    torch.cuda.synchronize()
    assert tssd.LAUNCHES == before + 1
    assert y.dtype == x.dtype and y.shape == x.shape and st.shape == (b, h, p, n)
    want_y, want_st = ssd_chunked(x, dt, A, Bm, Cm, chunk)
    assert torch.isfinite(y.float()).all() and torch.isfinite(st).all()
    assert _rel_to_max(y, want_y) < SSD_TOL[dtype]
    assert _rel_to_max(st, want_st) < SSD_TOL["float32"]  # the state is fp32 in both


@pytest.mark.cuda
@pytest.mark.parametrize("b,s,h,p,g,n,chunk", [e for e in SSD_EDGES if e[1] > e[6]])
def test_ssd_scan_split_controls_fail_the_limit_while_the_kernel_passes(b, s, h, p, g, n, chunk):
    """In mamba2's dt and A ranges, fp32: the kernel holds the limit, and two
    controls built from the plain version fail it: the scan run apart on the
    two sides of the first chunk boundary (rank 0's state dropped) and of
    the first group boundary (the carry between groups dropped)."""
    _need_sm90()
    x, dt, A, Bm, Cm = _ssd_inputs(b, s, h, p, g, n, "float32", ranges="model")
    y, st = ops.ssd_scan(x, dt, A, Bm, Cm, chunk=chunk)
    want_y, want_st = ssd_chunked(x, dt, A, Bm, Cm, chunk)
    limit = SSD_TOL["float32"]
    assert _rel_to_max(y, want_y) < limit and _rel_to_max(st, want_st) < limit
    pl = tssd.plan(b, s, h, p, n, chunk, torch.float32, kbuild.device_info(x.device.index)[1])
    assert pl.cluster > 1 and pl.groups > 1
    for at in (chunk, pl.cluster * chunk):
        y1, _ = ssd_chunked(x[:, :at], dt[:, :at], A, Bm[:, :at], Cm[:, :at], chunk)
        y2, st2 = ssd_chunked(x[:, at:], dt[:, at:], A, Bm[:, at:], Cm[:, at:], chunk)
        control = max(_rel_to_max(torch.cat([y1, y2], dim=1), want_y), _rel_to_max(st2, want_st))
        assert control > limit, (at, control)


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_ssd_scan_takes_dt_of_either_sign(dtype):
    """The kernel computes the plain version for any dt, not only the
    model's softplus: dt of either sign and exact zeros, over two groups of
    a cluster."""
    _need_sm90()
    b, s, h, p, g, n, chunk = 1, 1100, 8, 64, 2, 128, 256
    x, dt, A, Bm, Cm = _ssd_inputs(b, s, h, p, g, n, dtype, ranges="model")
    rng = np.random.default_rng(9)
    dt = torch.from_numpy((0.02 * rng.normal(size=(b, s, h))).astype(np.float32)).cuda()
    dt[:, ::7] = 0.0
    y, st = ops.ssd_scan(x, dt, A, Bm, Cm, chunk=chunk)
    want_y, want_st = ssd_chunked(x, dt, A, Bm, Cm, chunk)
    assert torch.isfinite(y.float()).all() and torch.isfinite(st).all()
    assert _rel_to_max(y, want_y) < SSD_TOL[dtype]
    assert _rel_to_max(st, want_st) < SSD_TOL["float32"]


@pytest.mark.cuda
def test_ssd_scan_plan_is_what_the_launcher_lays_out():
    """``ssd_scan.plan``'s shared memory is the kernel's own layout (the C
    entry point ``ssd_scan_smem``) for every shape the card tests run."""
    _need_sm90()
    lib = tssd._library()
    for b, s, h, p, g, n, chunk in SSD_SHAPES:
        for dtype, code in ((torch.float32, 0), (torch.bfloat16, 1)):
            pl = tssd.plan(b, s, h, p, n, chunk, dtype)
            assert lib.ssd_scan_smem(code, n, pl.chunk, pl.stages, pl.cbufs) == pl.smem


@pytest.mark.cuda
def test_ssd_scan_plain_version_matches_sequential_oracle_on_card():
    _need_sm90()
    for shape in SSD_SHAPES[:6]:
        x, dt, A, Bm, Cm = _ssd_inputs(*shape[:6], "float32")
        y, st = ssd_chunked(x, dt, A, Bm, Cm, shape[6])
        ry, rst = ssd_scan_ref(x, dt, A, Bm, Cm, shape[6])
        assert torch.max(torch.abs(y - ry)).item() < 2e-3  # tests/test_kernels.py's
        assert torch.max(torch.abs(st - rst)).item() < 2e-3


@pytest.mark.cuda
def test_ssd_scan_refuses_what_it_cannot_run(monkeypatch):
    _need_sm90()
    x, dt, A, Bm, Cm = _ssd_inputs(1, 16, 2, 8, 1, 8, "float32")
    with pytest.raises(ValueError, match="head_dim"):
        tssd.launch(torch.cat([x] * 9, dim=-1), dt, A, Bm, Cm, chunk=8)
    with pytest.raises(ValueError, match="dt must be float32"):
        tssd.launch(x, dt.bfloat16(), A, Bm, Cm, chunk=8)
    with pytest.raises(ValueError, match="unit stride"):
        tssd.launch(x, dt, A, Bm.repeat_interleave(2, dim=-1)[..., ::2], Cm, chunk=8)
    monkeypatch.setitem(kbuild.DEVICES, x.device.index, ((8, 0), 132))
    with pytest.raises(RuntimeError, match="capability 8.0"):
        ops.ssd_scan(x, dt, A, Bm, Cm, chunk=8)


# gmm: tests/test_kernels.py's shapes, ragged edges, and qwen2-moe-a2.7b's
# three products at a reduced expert count; (e, c, d, f)
GMM_SHAPES = [
    (4, 64, 32, 48), (2, 100, 70, 30), (8, 128, 256, 128), (1, 8, 8, 8), (3, 129, 33, 257),
    (4, 688, 2048, 1408), (4, 688, 1408, 2048), (60, 32, 2048, 1408),
    # the bf16 body's edges: C on both sides of its 64-row body and of one and
    # two 128-row tiles, and 8192; D off its 64-wide K steps; F under one
    # 256-wide tile; 60 experts of 8 rows, many tiles per CTA
    (3, 1, 256, 1408), (3, 33, 72, 256), (2, 64, 1000, 1408), (2, 65, 2048, 72),
    (2, 129, 8, 1408), (2, 8192, 2048, 1408), (60, 8, 2048, 1408),
]
# relative to max |plain value|: fp32 sums in another order; bf16 rounds the
# output to 8 bits of mantissa
GMM_TOL = {"float32": 1e-4, "bfloat16": 2e-2}


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("e,c,d,f", GMM_SHAPES)
def test_gmm_matches_plain_version_on_card(e, c, d, f, dtype):
    _need_sm90()
    rng = np.random.default_rng(7)
    td = getattr(torch, dtype)
    x = torch.from_numpy(rng.normal(size=(e, c, d)).astype(np.float32)).cuda().to(td)
    w = torch.from_numpy(rng.normal(size=(e, d, f)).astype(np.float32)).cuda().to(td)
    before = tgmm.LAUNCHES
    got = ops.gmm(x, w)
    torch.cuda.synchronize()
    assert tgmm.LAUNCHES == before + 1
    assert got.dtype == td and got.shape == (e, c, f)
    assert _rel_to_max(got, gmm_ref(x, w)) < GMM_TOL[dtype]


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_gmm_takes_strided_views_and_refuses_what_it_cannot_run(dtype, monkeypatch):
    _need_sm90()
    rng = np.random.default_rng(8)
    td = getattr(torch, dtype)
    x = torch.from_numpy(rng.normal(size=(3, 90, 40)).astype(np.float32)).cuda().to(td)
    w = torch.from_numpy(rng.normal(size=(3, 70, 40)).astype(np.float32)).cuda().to(td)
    # (3, 45, 40) @ (3, 40, 70): fp32 reads the views, bf16 copies them into
    # zero-padded contiguous operands (F 70 -> 72); one launch each
    xs, ws = x[:, ::2], w.transpose(1, 2)
    before = tgmm.LAUNCHES
    got = ops.gmm(xs, ws)
    assert got.shape == (3, 45, 70) and got.is_contiguous()
    assert _rel_to_max(got, gmm_ref(xs, ws)) < GMM_TOL[dtype]
    xt = x.transpose(1, 2).contiguous().transpose(1, 2)  # unit stride along C, not D
    assert _rel_to_max(ops.gmm(xt, ws), gmm_ref(xt, ws)) < GMM_TOL[dtype]
    assert tgmm.LAUNCHES == before + 2
    with pytest.raises(ValueError, match="must match x"):
        tgmm.launch(x, ws.float() if dtype == "bfloat16" else ws.bfloat16())
    with pytest.raises(TypeError, match="float32 or bfloat16"):
        tgmm.launch(x.half(), ws.half())
    monkeypatch.setitem(kbuild.DEVICES, x.device.index, ((8, 0), 132))
    with pytest.raises(RuntimeError, match="capability 8.0"):
        ops.gmm(x, ws)


@pytest.mark.cuda
@pytest.mark.parametrize("n_tokens", [8, 300])
def test_gmm_on_the_buffers_moe_dispatch_builds(n_tokens):
    """ops.gmm on the (E, C, D) buffer that moe.dispatch builds, read as it
    is: at 8 tokens the 64-row body (C 16), at 300 the 128-row tiles (C 600,
    five of them, so one cluster's second CTA has no rows)."""
    _need_sm90()
    cfg = _family_cfg("moe")
    rng = np.random.default_rng(11)
    x2d = torch.from_numpy(rng.normal(size=(n_tokens, cfg.d_model)).astype(np.float32)).cuda()
    wr = torch.from_numpy(rng.normal(size=(cfg.d_model, cfg.num_experts)).astype(np.float32))
    _, top_e, _ = moe.route(x2d, wr.cuda(), cfg)
    cap = moe.capacity_for(n_tokens, cfg)
    buf, _, _ = moe.dispatch(x2d.bfloat16(), top_e, cfg.num_experts, cap, 0, cfg.num_experts)
    w = torch.from_numpy(rng.normal(size=(cfg.num_experts, cfg.d_model, cfg.moe_d_ff))
                         .astype(np.float32)).cuda().bfloat16()
    assert buf.shape == (cfg.num_experts, cap, cfg.d_model) and tgmm._fits_bf16_body(buf)
    before = tgmm.LAUNCHES
    got = ops.gmm(buf, w)
    torch.cuda.synchronize()
    assert tgmm.LAUNCHES == before + 1
    assert _rel_to_max(got, gmm_ref(buf, w)) < GMM_TOL["bfloat16"]


def _family_cfg(family):
    common = dict(name=f"t-{family}", num_layers=3, d_model=128, vocab_size=1000,
                  compute_dtype="float32")
    if family == "ssm":
        return ModelConfig(family="ssm", num_heads=1, num_kv_heads=1, d_ff=0, ssm_state=64,
                           ssm_head_dim=32, ssm_chunk=32, **common)
    return ModelConfig(family="moe", num_heads=4, num_kv_heads=4, head_dim=32, d_ff=96,
                       moe_d_ff=96, num_experts=6, num_experts_per_tok=2,
                       num_shared_experts=1, attn_impl="flash_pallas", **common)


@pytest.mark.cuda
@pytest.mark.parametrize("family,kernel,per_layer", [("ssm", tssd, 1), ("moe", tgmm, 3)])
def test_prefill_on_card_launches_its_kernel_per_layer(family, kernel, per_layer):
    """The Mamba2 LM runs one ssd_scan per layer, the MoE transformer three
    gmm per layer; fp32 logits on the card against the port's CPU forward."""
    _need_sm90()
    cfg = _family_cfg(family)
    params = api.init(0, cfg, device="cuda")
    toks = torch.from_numpy(np.random.default_rng(9).integers(0, 1000, size=(2, 77))).cuda()
    before = kernel.LAUNCHES
    with torch.no_grad():
        got, aux = api.forward(params, {"tokens": toks}, cfg)
        torch.cuda.synchronize()
        assert kernel.LAUNCHES == before + per_layer * cfg.num_layers
        want, want_aux = api.forward(tree_map(lambda t: t.cpu(), params), {"tokens": toks.cpu()},
                                     cfg)
    assert torch.max(torch.abs(got.cpu() - want)).item() / want.abs().max().item() < 1e-4
    assert abs(aux.item() - want_aux.item()) < 1e-4


# H8: the backward of gmm (three kernel launches for a product with both
# grads), ssd_scan (BWD_LAUNCHES launches of its backward kernels) and
# flash_attention (two) against the plain versions: gmm's own autograd, and
# the written-out plain backwards (ref.ssd_chunked_bwd,
# ref.flash_attention_bwd)

def _grads(fn, inputs, cotangent):
    leaves = [t.clone().requires_grad_(True) for t in inputs]
    out = fn(*leaves)
    (out[0] if isinstance(out, tuple) else out).backward(cotangent)
    return [t.grad for t in leaves]


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("e,c,d,f", [(4, 64, 32, 48), (3, 129, 33, 257), (4, 688, 2048, 1408),
                                     (4, 688, 1408, 2048)])
def test_gmm_backward_matches_plain_version_on_card(e, c, d, f, dtype):
    _need_sm90()
    rng = np.random.default_rng(12)
    td = getattr(torch, dtype)
    x, w, dy = (torch.from_numpy(rng.normal(size=s).astype(np.float32)).cuda().to(td)
                for s in ((e, c, d), (e, d, f), (e, c, f)))
    before = tgmm.LAUNCHES
    got = _grads(ops.gmm, (x, w), dy)
    torch.cuda.synchronize()
    assert tgmm.LAUNCHES - before == 3  # y, dx and dw
    want = _grads(gmm_ref, (x, w), dy)
    for g, p in zip(got, want):
        assert g.dtype == td and g.shape == p.shape
        assert _rel_to_max(g, p) < GMM_TOL[dtype]


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("e,c,d,f,view", chip_smoke.GMM_BWD_EDGES)
def test_gmm_backward_reads_transposed_views_without_a_copy_on_card(e, c, d, f, view, dtype):
    """K4's backward at the transposed layouts' edges (chip_smoke's
    GMM_BWD_EDGES: C ragged and at most 64, D and F off 64, expert-strided
    views, and a w whose row stride no TMA map takes): dx and dw within
    GMM_TOL of autograd through the plain version, two launches, twice
    bitwise, and an operand copy only where no map describes wᵀ (bf16)."""
    _need_sm90()
    gen = torch.Generator("cuda").manual_seed(14)
    rec = chip_smoke.check_gmm_backward(e, c, d, f, getattr(torch, dtype), gen, view=view)
    assert rec["launches"] == 2 and rec["bitwise"]
    assert max(rec["dx_rel_err"], rec["dw_rel_err"]) <= GMM_TOL[dtype]
    assert rec["operand_copies"] == (1 if view == "unaligned w" and dtype == "bfloat16" else 0)


# the backward kernels: a ragged tail with G > 1, a single chunk (S < Q),
# mamba2-370m's widths at a ragged S (G 1, 32 heads sharing B and C),
# zamba2-7b's H 112 N 64, and a cluster edge (S 4096) in mamba2's ranges;
# (b, s, h, p, g, n, chunk, ranges)
SSD_BWD_SHAPES = [SSD_SHAPES[4] + ("normal",), SSD_SHAPES[5] + ("normal",),
                  SSD_SHAPES[6] + ("normal",), SSD_SHAPES[7] + ("normal",),
                  SSD_EDGES[0] + ("model",)]


@pytest.mark.cuda
@pytest.mark.parametrize("with_state", [False, True])
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("b,s,h,p,g,n,chunk,ranges", SSD_BWD_SHAPES)
def test_ssd_scan_backward_matches_plain_version_on_card(b, s, h, p, g, n, chunk, ranges,
                                                         dtype, with_state):
    """The backward kernels through ``ops.ssd_scan``'s autograd (with y's
    cotangent alone and with the final state's too) against the plain
    backward on the same inputs, per gradient relative to its largest
    value: fp32 within SSD_TOL's 1e-3 (the chunk's cumsum and the sums run in
    another order), bf16 within 2e-2 (the products' operands are rounded to
    bf16 in the kernels, not in the plain backward)."""
    _need_sm90()
    x, dt, A, Bm, Cm = _ssd_inputs(b, s, h, p, g, n, dtype, ranges=ranges)
    gen = torch.Generator("cuda").manual_seed(0)
    dy = torch.randn(x.shape, generator=gen, device="cuda").to(x.dtype)
    dst = torch.randn((b, h, p, n), generator=gen, device="cuda") if with_state else None
    leaves = [t.clone().requires_grad_(True) for t in (x, dt, A, Bm, Cm)]
    before, bwd_before = tssd.LAUNCHES, tssd.BACKWARD_LAUNCHES
    y, st = ops.ssd_scan(*leaves, chunk=chunk)
    torch.autograd.backward([y, st] if with_state else [y], [dy, dst] if with_state else [dy])
    torch.cuda.synchronize()
    assert tssd.LAUNCHES - before == 1 + tssd.BWD_LAUNCHES  # the forward and the backward's
    assert tssd.BACKWARD_LAUNCHES - bwd_before == tssd.BWD_LAUNCHES
    want = kref.ssd_chunked_bwd(x, dt, A, Bm, Cm, dy, dst, chunk)
    for leaf, pl in zip(leaves, want, strict=True):
        gr = leaf.grad
        assert gr.dtype == pl.dtype and gr.shape == pl.shape and torch.isfinite(gr.float()).all()
        assert _rel_to_max(gr, pl) < SSD_TOL[dtype]


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("shape", chip_smoke.SSD_BWD_EDGES)
def test_ssd_scan_backward_edges_on_card(shape, dtype):
    """K3's backward at its design's edges (chip_smoke's SSD_BWD_EDGES: a
    group's heads over several slices, chunks of 64 and 4096, S < 64, a
    chunk whose last tile is short, P 60) against the plain backward, in
    float64 for fp32 (the fp32 plain backward is itself off by more than the
    limit at some of these draws):
    within BWD_TOL, twice bitwise, BWD_LAUNCHES launches, the slices the plan
    gives, and an operand copy only where bf16's TMA maps cannot read x and
    dy as they lie."""
    _need_sm90()
    gen = torch.Generator("cuda").manual_seed(15)
    td = getattr(torch, dtype)
    rec = chip_smoke.check_ssd_backward(shape, td, gen, with_state=True,
                                        exact=dtype == "float32")
    assert rec["bitwise"] and rec["launches"] == tssd.BWD_LAUNCHES
    assert max(rec["rel_err"].values()) <= chip_smoke.BWD_TOL[td]
    assert rec["operand_copies"] == (2 if shape[3] % 8 and dtype == "bfloat16" else 0)
    b, s, h, p, g, n, chunk = shape
    assert rec["plan"] == dataclasses.asdict(
        tssd.bwd_plan(b, s, h, p, g, n, chunk, kbuild.device_info(0)[1]))
    if shape in chip_smoke.SSD_BWD_EDGES[:3]:  # the heads of a group over several slices
        assert rec["plan"]["slices"] > 1


@pytest.mark.cuda
def test_ssd_scan_bwd_plan_is_what_the_launcher_takes():
    """``ssd_scan.bwd_plan``'s workspace is the backward's own
    (``ssd_scan_bwd_workspace``) at every shape the card tests run, at the
    plan's slices and at each other count of them."""
    _need_sm90()
    lib = tssd._bwd_library()
    for b, s, h, p, g, n, chunk in ([sh[:7] for sh in SSD_BWD_SHAPES]
                                    + chip_smoke.SSD_BWD_EDGES + [chip_smoke.SSD_BWD_EXACT]):
        q = min(chunk, s)
        pl = tssd.bwd_plan(b, s, h, p, g, n, chunk)
        assert lib.ssd_scan_bwd_workspace(b, s, h, g, p, n, q, pl.slices) == pl.workspace
        for slices in (1, 2, h // g):
            if slices <= h // g:
                other = tssd.bwd_plan(b, s, h, p, g, n, chunk, slices=slices)
                assert lib.ssd_scan_bwd_workspace(b, s, h, g, p, n, q, slices) == other.workspace


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_backward_kernels_are_bitwise_the_same_twice(dtype):
    """No atomics: two backward calls on the same inputs give bitwise the
    same gradients (mamba2-370m's scan widths, 32 heads summing into one
    group's B and C; qwen3's attention widths)."""
    _need_sm90()
    x, dt, A, Bm, Cm = _ssd_inputs(2, 600, 32, 64, 1, 128, dtype, ranges="model")
    dy = torch.randn(x.shape, generator=torch.Generator("cuda").manual_seed(1),
                     device="cuda").to(x.dtype)
    one, two = (tssd.launch_bwd(x, dt, A, Bm, Cm, dy, None, chunk=256) for _ in range(2))
    assert all(torch.equal(a, b) for a, b in zip(one, two, strict=True))
    rng = np.random.default_rng(3)
    q, k, v = _attention_inputs(rng, 2, 16, 8, 600, 600, 128, getattr(torch, dtype), "bshd")
    do = torch.randn(q.shape, generator=torch.Generator("cuda").manual_seed(2),
                     device="cuda").to(q.dtype)
    o, lse = tflash.launch(q, k, v, causal=True, with_lse=True)
    one, two = (tflash.launch_bwd(q, k, v, o, lse, do, causal=True) for _ in range(2))
    assert all(torch.equal(a, b) for a, b in zip(one, two, strict=True))


# the attention backward: every head_dim the kernels take at a ragged length
# with G 2, then causal with sq != skv both ways, cross-attention, MQA and a
# single row; (b, h, kv, sq, skv, hd, causal)
ATTN_BWD_SHAPES = ([(1, 4, 2, 130, 130, hd, True) for hd in tflash.HEAD_DIMS]
                   + [ATTN_SHAPES[5], ATTN_SHAPES[6], ATTN_SHAPES[9], ATTN_SHAPES[11],
                      (1, 8, 1, 200, 200, 64, True), (2, 4, 2, 1, 1, 128, True)])


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("b,h,kv,sq,skv,hd,causal", ATTN_BWD_SHAPES)
def test_flash_attention_backward_matches_plain_version_on_card(b, h, kv, sq, skv, hd, causal,
                                                                dtype):
    """The backward kernels through ``flash_attention``'s autograd on the
    model's (B, S, H, hd) views against the plain backward, per gradient
    over max(1, its largest value): fp32 within 1e-5, bf16 within 2e-2 (P
    and dS rounded to bf16 as the kernels' operands, in another order)."""
    _need_sm90()
    rng = np.random.default_rng(13)
    td = getattr(torch, dtype)
    q, k, v = _attention_inputs(rng, b, h, kv, sq, skv, hd, td, "bshd")
    do = torch.from_numpy(rng.normal(size=q.shape).astype(np.float32)).cuda().to(td)
    before, bwd_before = tflash.LAUNCHES, tflash.BACKWARD_LAUNCHES
    got = _grads(lambda *t: tflash.flash_attention(*t, causal=causal), (q, k, v), do)
    torch.cuda.synchronize()
    assert tflash.LAUNCHES - before == 3  # the forward and the backward's two
    assert tflash.BACKWARD_LAUNCHES - bwd_before == 2
    o = flash_attention_ref(q, k, v, causal=causal)
    want = kref.flash_attention_bwd(q, k, v, o, do, causal=causal)
    for gr, pl in zip(got, want, strict=True):
        assert gr.dtype == td and gr.shape == pl.shape
        assert _grad_rel(gr, pl) < (1e-5 if dtype == "float32" else 2e-2)


@pytest.mark.cuda
@pytest.mark.parametrize("family", ["dense", "ssm"])
def test_no_plain_vjp_runs_on_the_card(monkeypatch, family):
    """On CUDA tensors the gradients come from the backward kernels alone:
    with ``ref.vjp``, the plain backwards and the plain forwards made to
    raise, a backward of each op and a small train step still run."""
    _need_sm90()

    def refuse(*args, **kwargs):
        raise AssertionError("a plain version ran on the card")

    for name in ("vjp", "ssd_chunked_bwd", "flash_attention_bwd", "ssd_chunked",
                 "flash_attention_ref"):
        monkeypatch.setattr(kref, name, refuse)
    if family == "ssm":
        x, dt, A, Bm, Cm = _ssd_inputs(1, 130, 4, 16, 2, 16, "float32")
        _grads(lambda *t: ops.ssd_scan(*t, chunk=64), (x, dt, A, Bm, Cm), torch.ones_like(x))
    else:
        q, k, v = _attention_inputs(np.random.default_rng(0), 1, 4, 2, 70, 70, 64,
                                    torch.bfloat16, "bshd")
        _grads(lambda *t: tflash.flash_attention(*t, causal=True), (q, k, v), torch.ones_like(q))
    cfg = _train_cfg(family)
    run, batch = _train_inputs(cfg)
    params = api.init(0, cfg, device="cuda")
    loss, _, grads = steps.value_and_grad(params, {k: v.cuda() for k, v in batch.items()}, run)
    torch.cuda.synchronize()
    assert torch.isfinite(loss) and all(torch.isfinite(g).all() for g in tree_leaves(grads))


@pytest.mark.cuda
@pytest.mark.parametrize("family", ["ssm", "moe"])
def test_model_backward_on_card_matches_cpu(family):
    """H8 on the card: the gradient of a small Mamba2 LM and MoE transformer
    (fp32) through the kernels' backwards, against the port's CPU gradient
    (the plain versions) on the same parameters."""
    _need_sm90()
    cfg = _family_cfg(family)
    params = api.init(0, cfg, device="cuda")
    cpu_params = tree_map(lambda t: t.detach().cpu().requires_grad_(True), params)
    params = tree_map(lambda t: t.detach().requires_grad_(True), params)
    toks = torch.from_numpy(np.random.default_rng(14).integers(0, 1000, size=(2, 77)))
    ct = torch.from_numpy(np.random.default_rng(15).normal(size=(2, 77, 1000))
                          .astype(np.float32))
    got, _ = api.forward(params, {"tokens": toks.cuda()}, cfg)
    got.backward(ct.cuda())
    want, _ = api.forward(cpu_params, {"tokens": toks}, cfg)
    want.backward(ct)
    for leaf, cpu_leaf in zip(tree_leaves(params), tree_leaves(cpu_params)):
        scale = max(1.0, cpu_leaf.grad.abs().max().item())
        assert (leaf.grad.cpu() - cpu_leaf.grad).abs().max().item() / scale < 1e-4


def _supernet_base(full: bool):
    """Full-width MobileNetV2 at 32 px, or oneshot_bench's small base."""
    base = C.mobilenet_v2(10, 32) if full else C.mobilenet_v2(10, 32, width=0.35)
    if full:
        return base
    return dataclasses.replace(base, blocks=base.blocks[:4], head_filters=128)


def _no_tf32(monkeypatch):
    """fp32 products and convolutions in full fp32, as on the CPU."""
    monkeypatch.setattr(torch.backends.cuda.matmul, "allow_tf32", False)
    monkeypatch.setattr(torch.backends.cudnn, "allow_tf32", False)


@pytest.mark.cuda
@pytest.mark.parametrize("draw", ["all_ibn", "all_fused", "mixed"])
def test_supernet_forward_and_sgd_step_on_card_match_cpu(draw, monkeypatch):
    """The oneshot supernet at the small base: logits and one SGD step, card
    (every 1×1 conv on ibn_pointwise) against the port's CPU run on the same
    parameters, within 1e-4: the parameters after the step, and each leaf's
    gradient against that leaf's largest (0 where the CPU's is all 0)."""
    _need_sm90()
    _no_tf32(monkeypatch)
    base = _supernet_base(full=False)
    n = len(base.blocks)
    ks, exps, ops = {"all_ibn": ([7] * n, [1] + [6] * (n - 1), [0] * n),
                     "all_fused": ([3] * n, [1] + [3] * (n - 1), [1] * n),
                     "mixed": ([3, 5, 7, 5], [1, 3, 6, 3], [0, 1, 0, 1])}[draw]
    rng = np.random.default_rng(16)
    x = torch.from_numpy(rng.normal(size=(8, 32, 32, 3)).astype(np.float32))
    y = torch.from_numpy(rng.integers(0, 10, size=8))
    params = oneshot.init_supernet(0, base, device="cuda")
    cpu_params = tree_map(lambda t: t.cpu(), params)
    with torch.no_grad():
        got = oneshot.supernet_forward(params, x.cuda(), base, ks, exps, ops)
        want = oneshot.supernet_forward(cpu_params, x, base, ks, exps, ops)
    assert (got.cpu() - want).abs().max().item() <= 1e-4 * want.abs().max().item()
    new, loss = oneshot.train_step(params, x.cuda(), y.cuda(), base, ks, exps, ops, 0.05)
    new_cpu, loss_cpu = oneshot.train_step(cpu_params, x, y, base, ks, exps, ops, 0.05)
    assert abs(float(loss) - float(loss_cpu)) <= 1e-4 * max(1.0, abs(float(loss_cpu)))
    for g, w in zip(tree_leaves(new), tree_leaves(new_cpu)):
        assert (g.cpu() - w).abs().max().item() <= 1e-4 * max(1.0, w.abs().max().item())
    _, grads = oneshot.loss_and_grads(params, x.cuda(), y.cuda(), base, ks, exps, ops)
    _, grads_cpu = oneshot.loss_and_grads(cpu_params, x, y, base, ks, exps, ops)
    for g, w in zip(tree_leaves(grads), tree_leaves(grads_cpu)):
        assert (g.cpu() - w).abs().max().item() <= 1e-4 * w.abs().max().item()


@pytest.mark.cuda
@pytest.mark.parametrize("full", [False, True])
def test_supernet_step_launches_the_kernel_three_times_per_pointwise_conv(full):
    """Every 1×1 conv of the supernet (expand and project per block, the
    head) is one forward, one dx and one dw launch of ibn_pointwise, whatever
    the draw: 27 at the small base, 105 at full width."""
    _need_sm90()
    base = _supernet_base(full)
    n = len(base.blocks)
    params = oneshot.init_supernet(0, base, device="cuda")
    x = torch.randn((2, 32, 32, 3), device="cuda")
    y = torch.randint(0, 10, (2,), device="cuda")
    for ops in ([0] * n, [1] * n):
        before = ibn_conv.LAUNCHES
        params, _ = oneshot.train_step(params, x, y, base, [5] * n, [1] + [6] * (n - 1), ops,
                                       0.05)
        torch.cuda.synchronize()
        assert ibn_conv.LAUNCHES - before == 3 * (2 * n + 1) == (105 if full else 27)


@pytest.mark.cuda
def test_costmodel_forward_and_steps_on_card_match_cpu(monkeypatch):
    """The cost model's forward on one init, and 3 Adam steps (dropout 0)
    from it, card against CPU: 1e-5 of max |output| and 1e-4 per leaf."""
    _need_card()
    _no_tf32(monkeypatch)
    space = oneshot.oneshot_space(_supernet_base(full=False))
    feats, lat, area, energy = costmodel.generate_dataset(space, has.has_space(), 600,
                                                          seed=0, include_energy=True)
    cfg = costmodel.CostModelConfig(steps=3, batch=64, dropout=0.0)
    init = {dev: costmodel.init_mlp(torch.Generator().manual_seed(0), feats.shape[1], cfg,
                                    energy=True, device=dev) for dev in ("cuda", "cpu")}
    x = torch.from_numpy(feats.astype(np.float32))
    with torch.no_grad():
        got = costmodel.mlp_forward_all(init["cuda"], x.cuda())
        want = costmodel.mlp_forward_all(init["cpu"], x)
    for g, w in zip(got, want):
        assert (g.cpu() - w).abs().max().item() <= 1e-5 * w.abs().max().item()
    on_card, m_card = costmodel.train(feats, lat, area, cfg, energy_mj=energy, device="cuda")
    on_cpu, m_cpu = costmodel.train(feats, lat, area, cfg, energy_mj=energy, device="cpu")
    assert np.array_equal(on_card.mu, on_cpu.mu)
    for g, w in zip(tree_leaves(on_card.params), tree_leaves(on_cpu.params)):
        assert g.device.type == "cuda"
        assert (g.cpu() - w).abs().max().item() <= 1e-4 * max(1.0, w.abs().max().item())
    for key, w in m_cpu.items():
        assert m_card[key] == pytest.approx(w, rel=1e-4), key


# the training step on the card (chip_smoke's train phase at small sizes):
# fp32 card against CPU, the launches of each kernel per step, and the
# planted faults

TRAIN_TOL = chip_smoke.TRAIN_TOL


def _train_cfg(family):
    """A small config of each family with every kernel on its path, fp32."""
    if family in ("ssm", "moe"):
        return _family_cfg(family)
    common = dict(name=f"t-{family}", d_model=128, vocab_size=1000, compute_dtype="float32",
                  num_heads=4, num_kv_heads=2, head_dim=32, d_ff=256, attn_impl="flash_pallas")
    if family == "dense":
        return ModelConfig(family="dense", num_layers=3, **common)
    return ModelConfig(family="hybrid", num_layers=5, hybrid_attn_every=2, ssm_state=64,
                       ssm_head_dim=32, ssm_chunk=32, **common)


def _train_launches(cfg, remat: str) -> dict:
    """Each kernel's launches in one training step: forward (again in the
    recompute under remat) and the backward's: gmm's dx and dw, ssd_scan's
    BWD_LAUNCHES, flash_attention's two (and those two counted apart, as
    ``*_bwd``)."""
    r, n = (1 if remat == "none" else 2), cfg.num_layers
    if cfg.family == "moe":
        return {"gmm": (3 * r + 6) * n, "flash_attention": (r + 2) * n,
                "flash_attention_bwd": 2 * n}
    if cfg.family == "ssm":
        k3 = tssd.BWD_LAUNCHES
        return {"ssd_scan": (r + k3) * n, "ssd_scan_bwd": k3 * n}
    if cfg.family == "hybrid":  # the tail's Mamba2 layers are outside the remat
        groups = n // cfg.hybrid_attn_every
        per = cfg.hybrid_attn_every
        k3 = tssd.BWD_LAUNCHES
        return {"ssd_scan": r * groups * per + n - groups * per + k3 * n,
                "ssd_scan_bwd": k3 * n,
                "flash_attention": (r + 2) * groups, "flash_attention_bwd": 2 * groups}
    return {"flash_attention": (r + 2) * n, "flash_attention_bwd": 2 * n}


def _train_inputs(cfg, remat="none"):
    run = RunConfig(model=cfg, shape=ShapeConfig("t", 77, 2, "train"),
                    train=TrainConfig(warmup_steps=5, learning_rate=1e-3, remat=remat))
    host = LMStream(cfg.vocab_size, 77, 2, seed=0).batch_at(0)
    return run, {k: torch.from_numpy(v) for k, v in host.items()}


@pytest.mark.cuda
@pytest.mark.parametrize("family", ["dense", "ssm", "moe", "hybrid"])
def test_train_step_on_card_matches_cpu(family):
    """Loss (relative), each leaf's gradient (over that leaf's max
    |gradient|) and one AdamW update from the card's gradients (over each
    leaf's max |update|, beyond one rounding step of the new parameter),
    card against CPU, fp32, at chip_smoke's limit."""
    _need_sm90()
    cfg = _train_cfg(family)
    run, batch = _train_inputs(cfg)
    params = api.init(0, cfg, device="cuda")
    cpu_params = tree_map(lambda t: t.cpu(), params)
    loss, _, grads = steps.value_and_grad(params, {k: v.cuda() for k, v in batch.items()}, run)
    want_loss, _, want = steps.value_and_grad(cpu_params, batch, run)
    assert abs(loss.item() - want_loss.item()) <= TRAIN_TOL * abs(want_loss.item())
    assert max(chip_smoke._grad_errs(grads, want)) <= TRAIN_TOL
    want_new = chip_smoke._stepped(cpu_params, tree_map(lambda t: t.cpu(), grads), run)
    got = chip_smoke._stepped(params, grads, run)
    assert all(t.device.type == "cuda" for t in tree_leaves(got))
    assert max(chip_smoke._update_errs(got, want_new, cpu_params)) <= TRAIN_TOL


@pytest.mark.cuda
@pytest.mark.parametrize("remat", ["none", "full"])
@pytest.mark.parametrize("family", ["dense", "ssm", "moe", "hybrid"])
def test_train_step_launches_each_kernel_exactly(family, remat):
    _need_sm90()
    cfg = _train_cfg(family)
    run, batch = _train_inputs(cfg, remat)
    step = steps.make_train_step(run)[0]
    params = api.init(0, cfg, device="cuda")
    state = {"params": params, "opt": chip_smoke.make_optimizer(run.train).init(params)}
    before = chip_smoke.launch_counts()
    state, metrics = step(state, {k: v.cuda() for k, v in batch.items()})
    torch.cuda.synchronize()
    launches = {k: v - before[k] for k, v in chip_smoke.launch_counts().items() if v != before[k]}
    assert launches == _train_launches(cfg, remat)
    assert torch.isfinite(metrics["loss"]) and int(state["opt"]["step"]) == 1


@pytest.mark.cuda
@pytest.mark.parametrize("fault,family", [("gmm_dw_dropped", "moe"),
                                          ("ssd_scan_dB_zeroed", "ssm")])
def test_train_gradient_check_fails_a_planted_fault(fault, family):
    """One product's dw dropped from gmm's backward, or the B gradient of
    the scan's backward zeroed, on the card: the gradient limit must fail."""
    _need_sm90()
    cfg = _train_cfg(family)
    run, batch = _train_inputs(cfg)
    params = api.init(0, cfg, device="cuda")
    want = steps.value_and_grad(tree_map(lambda t: t.cpu(), params), batch, run)[2]
    with chip_smoke._train_fault(fault):
        got = steps.value_and_grad(params, {k: v.cuda() for k, v in batch.items()}, run)[2]
    assert max(chip_smoke._grad_errs(got, want)) > TRAIN_TOL
    clean = steps.value_and_grad(params, {k: v.cuda() for k, v in batch.items()}, run)[2]
    assert max(chip_smoke._grad_errs(clean, want)) <= TRAIN_TOL  # the fault is gone


@pytest.mark.cuda
def test_mesh_search_on_card_matches_cpu():
    """The pod mesh search with its PPO updates on the card samples the
    configs and scores the records of the same search on the CPU."""
    _need_card()
    from repro_torch import configs

    cfg, shape = configs.get("qwen3_1_7b"), LLM_SHAPES["train_4k"]
    card = meshsearch.search_mesh(cfg, shape, samples=32, seed=0, device="cuda")
    cpu = meshsearch.search_mesh(cfg, shape, samples=32, seed=0, device="cpu")
    assert repr(card.history) == repr(cpu.history)
    assert card.best_cfg == cpu.best_cfg


@pytest.mark.cuda
def test_process_sweep_on_card_is_bitwise_the_serial_one(tmp_path):
    """A 2-scenario sweep with proxy training on the card, serially here and
    on 2 spawned workers: the same histories and winners bitwise, and every
    worker that trained launched ibn_pointwise (chip_smoke's
    ``RecordingAccuracy`` logs each process's launches)."""
    _need_card()
    import os

    from repro_torch.core import nas, sweep
    from repro_torch.core.search import SearchConfig
    from repro_torch.runtime import SearchRuntime

    logs = tmp_path / "acc"
    logs.mkdir()
    acc = chip_smoke.RecordingAccuracy(steps=4, batch=16, device="cuda", log_dir=str(logs))
    cfg = sweep.SweepConfig(search=SearchConfig(samples=8, batch=4, seed=0))
    names = ["lat-0.5ms", "energy-0.7mJ"]
    ibn_conv.LAUNCHES = 0
    serial = sweep.SweepRunner(names, nas.s1_mobilenetv2(), acc, cfg).run(
        runtime=SearchRuntime.at(tmp_path / "s", tmp_path / "s" / "store.jsonl"))
    assert ibn_conv.LAUNCHES > 0
    proc = sweep.SweepRunner(names, nas.s1_mobilenetv2(), dataclasses.replace(acc),
                             dataclasses.replace(cfg, workers=2, processes=True)).run(
        runtime=SearchRuntime.at(tmp_path / "p", tmp_path / "p" / "store.jsonl"))
    for s, p in zip(serial.outcomes, proc.outcomes):
        assert p.result.history == s.result.history  # bitwise
        assert p.best == s.best
    workers = {pid: lines for pid, lines in chip_smoke._acc_logs(logs).items()
               if pid != os.getpid()}
    assert len(workers) == 2
    assert all(lines[-1]["launches"] > 0 for lines in workers.values())


@pytest.mark.cuda
def test_sweep_cli_trains_on_card_in_processes_and_resumes(tmp_path, capsys):
    """``scripts/torch_sweep.py --accuracy trained`` on the card: 2 spawned
    workers train the candidates, then ``--resume`` replays the same table."""
    _need_card()
    import importlib.util

    path = Path(__file__).resolve().parents[1] / "scripts" / "torch_sweep.py"
    spec = importlib.util.spec_from_file_location("torch_sweep", path)
    cli = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(cli)
    argv = ["--quick", "--accuracy", "trained", "--samples", "8", "--batch", "4",
            "--scenarios", "lat-0.3ms,energy-0.7mJ", "--store", str(tmp_path / "s.jsonl")]
    cli.main(argv + ["--workers", "2", "--processes"])
    first = capsys.readouterr().out
    cli.main(argv + ["--resume"])
    again = capsys.readouterr().out

    def table(out):
        lines = out.splitlines()
        start = next(i for i, ln in enumerate(lines) if ln.startswith("scenario "))
        return lines[start:start + 4]  # header, rule, the two scenarios

    assert table(again) == table(first)
    assert "appended 0)" in again


@pytest.mark.cuda
def test_concurrent_trainings_on_card_are_bitwise_the_lone_ones(monkeypatch):
    """Two threads train two candidates on the card at once, the shorter
    training leaving while the longer one still runs (as two admitted
    searches or a thread-mode sweep do): each candidate ends with the
    parameters and accuracy it gets trained alone, every step of both ran
    under the training flags (``proxy.CARD_FLAGS``: cuDNN deterministic,
    TF32 off), and the process's own flags come back after both."""
    _need_card()
    import hashlib
    import threading
    import time

    from repro_torch.core import nas, proxy

    space = nas.s1_mobilenetv2()
    rng = np.random.default_rng(0)
    specs = [space.decode(space.sample(rng)) for _ in range(2)]
    accs = [proxy.TrainedAccuracy(steps=4, batch=32, device="cuda"),
            proxy.TrainedAccuracy(steps=24, batch=32, device="cuda")]
    accs[0].prepare()
    real_step = proxy.train_step
    finals, flags, stamps, done, results = {}, {}, {}, {}, {}

    def recording_step(*args):
        name = threading.current_thread().name
        stamps.setdefault(name, []).append(time.perf_counter())
        flags.setdefault(name, []).append(
            (torch.backends.cudnn.deterministic, torch.backends.cudnn.benchmark,
             torch.backends.cudnn.allow_tf32, torch.backends.cuda.matmul.allow_tf32))
        params, loss = real_step(*args)
        finals[name] = params
        return params, loss

    monkeypatch.setattr(proxy, "train_step", recording_step)

    def train(i, name):
        acc = accs[i](specs[i])
        torch.cuda.synchronize()
        h = hashlib.sha256()
        for leaf in tree_leaves(finals[name]):
            h.update(leaf.detach().cpu().numpy().tobytes())
        results[name] = (acc, h.hexdigest())
        done[name] = time.perf_counter()

    def run(names):
        threads = [threading.Thread(target=train, args=(i, n), name=n) for i, n in names]
        for t in threads:
            t.start()
        for t in threads:
            t.join(300)
        assert not any(t.is_alive() for t in threads)

    before = proxy._read_card_flags()
    run([(0, "alone-0")])
    run([(1, "alone-1")])
    run([(0, "both-0"), (1, "both-1")])
    assert proxy._read_card_flags() == before
    assert results["both-0"] == results["alone-0"]  # bitwise: accuracy, parameters
    assert results["both-1"] == results["alone-1"]
    held = (True, False, False, False)
    assert all(f == held for name in ("both-0", "both-1") for f in flags[name])
    assert len(flags["both-1"]) == 24
    assert stamps["both-1"][-1] > done["both-0"]  # the longer one trained on alone


# ---------------------------------------------------------------------------
# The parallel substrate on the card: ranks sharing one GPU talk over gloo
# ---------------------------------------------------------------------------


def _sharded_card_step(rank: int) -> dict:
    """One rank of a (2, 2) world on the card: the qwen3-like config's
    sharded loss and gradients (whole), its AdamW update against the
    unsharded optimizer's on the same clipped gradients, one train step's
    loss, and its K2 launches."""
    from repro_torch.config import MeshConfig
    from repro_torch.launch.mesh import make_mesh
    from repro_torch.parallel import sharding
    from repro_torch.parallel.ctx import from_mesh

    cfg = _sharded_card_cfg()
    run, batch = _sharded_card_run(cfg)
    pc = from_mesh(make_mesh((2, 2), ("data", "model")))
    step, sspecs, bspecs = steps.make_train_step(run, pc)
    whole = api.init(0, cfg, device="cuda")
    params = sharding.distribute_tree(whole, sspecs["params"], pc.mesh)
    batch = sharding.distribute_tree({k: v.cuda() for k, v in batch.items()}, bspecs, pc.mesh)
    opt = make_optimizer(run.train)
    tflash.LAUNCHES = 0
    loss, _, grads = steps.value_and_grad(params, batch, run, pc)
    out = {"loss": loss.full_tensor().item(), "launches": tflash.LAUNCHES,
           "grads": tree_map(lambda g: g.full_tensor().cpu(), grads)}
    new, _, _ = opt.step(tree_map(torch.clone, params), grads, opt.init(params))
    out["update_err"] = chip_smoke._sharded_update_err(new, grads, whole, run)
    _, metrics = step({"params": params, "opt": opt.init(params)}, batch)
    out["step_loss"] = metrics["loss"].item()
    return out


def _sharded_card_cfg():
    return ModelConfig(family="dense", num_layers=2, d_model=128, num_heads=4,
                       num_kv_heads=2, head_dim=32, d_ff=256, vocab_size=512,
                       use_qk_norm=True, attn_impl="flash_pallas", compute_dtype="float32")


def _sharded_card_run(cfg):
    from repro_torch.config import MeshConfig

    run = RunConfig(model=cfg, shape=ShapeConfig("t", 64, 4, "train"),
                    train=TrainConfig(warmup_steps=1, learning_rate=1e-3),
                    mesh=MeshConfig(fsdp_min_size=1))
    host = LMStream(cfg.vocab_size, 64, 4, seed=0).batch_at(0)
    return run, {k: torch.from_numpy(v) for k, v in host.items()}


@pytest.mark.cuda
def test_sharded_train_step_on_card_matches_the_unsharded_one():
    """A 4-rank (2, 2) world whose ranks share the card (gloo, CUDA
    tensors staged through host memory), fp32: the sharded loss (and the
    train step's) and gradients against the card's unsharded ones, and the
    sharded AdamW update against the unsharded optimizer's on the same
    clipped gradients, at chip_smoke's limits; K2 launched on every rank
    (its local heads), the same number of times."""
    _need_sm90()
    from repro_torch.launch.mesh import run_world

    kbuild.build(tflash.SOURCE)  # once, before the ranks start
    res = run_world(_sharded_card_step, 4, "cuda", timeout_s=600)
    cfg = _sharded_card_cfg()
    run, batch = _sharded_card_run(cfg)
    params = api.init(0, cfg, device="cuda")
    loss, _, grads = steps.value_and_grad(params, {k: v.cuda() for k, v in batch.items()}, run)
    for r in res:
        for got in (r["loss"], r["step_loss"]):
            assert abs(got - loss.item()) <= 1e-5 * abs(loss.item())
        assert max(chip_smoke._grad_errs(r["grads"], tree_map(lambda g: g.cpu(), grads))) \
            <= 1e-4
        assert r["update_err"] <= 1e-4
    assert len({r["launches"] for r in res}) == 1 and res[0]["launches"] > 0


@pytest.mark.cuda
def test_launcher_trains_over_a_mesh_on_card(tmp_path):
    import os
    import subprocess

    _need_sm90()
    root = Path(__file__).resolve().parents[1]
    env = dict(os.environ, PYTHONPATH=str(root / "src"))
    out = subprocess.run(
        [sys.executable, "-m", "torch.distributed.run", "--standalone", "--nproc-per-node",
         "4", "-m", "repro_torch.launch.train", "--arch", "qwen3-1.7b", "--smoke",
         "--steps", "3", "--seq", "32", "--batch", "4", "--mesh", "2x2",
         "--ckpt", str(tmp_path / "ck")],
        cwd=tmp_path, env=env, capture_output=True, text=True, timeout=600)
    assert out.returncode == 0, out.stderr[-4000:]
    backend = "nccl" if torch.cuda.device_count() >= 4 else "gloo"
    assert f"backend {backend}" in out.stdout and "done: 3 steps" in out.stdout


@pytest.mark.cuda
def test_kernels_refuse_a_dtensor(tmp_path):
    import torch.distributed as dist

    from repro_torch.launch.mesh import init_world, make_mesh
    from repro_torch.parallel.ctx import P, placements

    _need_card()
    init_world(0, 1, "cuda", store=dist.FileStore(str(tmp_path / "store"), 1))
    try:
        mesh = make_mesh((1,), ("data",))

        def dt(*shape):
            t = torch.randn(*shape, device="cuda")
            return torch.distributed.tensor.DTensor.from_local(
                t, mesh, placements(P(*([None] * len(shape))), mesh))

        calls = {
            "ibn_pointwise": lambda: ops.ibn_pointwise(dt(8, 16), dt(16, 8), None),
            "flash_attention": lambda: ops.flash_attention(dt(1, 8, 2, 64), dt(1, 8, 2, 64),
                                                           dt(1, 8, 2, 64)),
            "ssd_scan": lambda: ops.ssd_scan(dt(1, 8, 2, 16), dt(1, 8, 2), dt(2),
                                             dt(1, 8, 1, 16), dt(1, 8, 1, 16), chunk=8),
            "gmm": lambda: ops.gmm(dt(2, 8, 16), dt(2, 16, 8)),
        }
        for name, call in calls.items():
            with pytest.raises(TypeError, match=f"{name} takes local tensors"):
                call()
    finally:
        dist.destroy_process_group()
