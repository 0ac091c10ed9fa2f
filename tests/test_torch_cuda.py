"""The CUDA kernels on the card against their plain PyTorch versions:
ibn_pointwise forward and backward, flash_attention forward, and the dense
transformer's prefill through flash_attention. Every test here carries the ``cuda`` marker
and skips without an NVIDIA GPU; this file imports no JAX, so it runs on a
machine with the card and PyTorch alone:

    PYTHONPATH=src python -m pytest -m cuda tests/test_torch_cuda.py -q
"""
import numpy as np
import pytest

torch = pytest.importorskip("torch")

from repro_torch.common import tree_map  # noqa: E402
from repro_torch.config import ModelConfig  # noqa: E402
from repro_torch.kernels import build as kbuild  # noqa: E402
from repro_torch.kernels import flash_attention as tflash  # noqa: E402
from repro_torch.kernels import ibn_conv, ops  # noqa: E402
from repro_torch.kernels.ref import flash_attention_ref, ibn_pointwise_ref  # noqa: E402
from repro_torch.models import transformer  # noqa: E402

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


# flash_attention: tests/test_kernels.py's shapes, causal with sq != skv, a
# ragged tile, every head_dim; (b, h, kv, sq, skv, hd, causal)
ATTN_SHAPES = [
    (1, 4, 4, 64, 64, 32, True), (2, 4, 2, 64, 64, 32, True), (1, 8, 1, 128, 128, 64, True),
    (2, 4, 1, 96, 160, 32, False), (1, 2, 2, 200, 200, 16, True),
    (1, 4, 2, 96, 160, 32, True), (2, 4, 1, 160, 96, 16, True), (1, 16, 8, 1025, 1025, 128, True),
]
ATTN_TOL = {"float32": 2e-5, "bfloat16": 2e-2}


def _need_sm90():
    _need_card()
    if torch.cuda.get_device_capability() < (9, 0):
        pytest.skip("the kernel is built for sm_90a")


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("b,h,kv,sq,skv,hd,causal", ATTN_SHAPES)
def test_flash_attention_matches_plain_version_on_card(b, h, kv, sq, skv, hd, causal, dtype):
    _need_sm90()
    rng = np.random.default_rng(3)
    td = getattr(torch, dtype)
    q, k, v = (torch.from_numpy(rng.normal(size=s).astype(np.float32)).cuda().to(td)
               for s in ((b, h, sq, hd), (b, kv, skv, hd), (b, kv, skv, hd)))
    before = tflash.LAUNCHES
    got = tflash.flash_attention(q, k, v, causal=causal)
    torch.cuda.synchronize()
    assert tflash.LAUNCHES == before + 1
    assert got.dtype == td and got.shape == q.shape
    want = flash_attention_ref(q, k, v, causal=causal)
    assert torch.max(torch.abs(got.float() - want.float())).item() < ATTN_TOL[dtype]


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

