"""The ibn_pointwise CUDA kernel on the card, against its plain PyTorch
version, forward and backward. Every test here carries the ``cuda`` marker
and skips without an NVIDIA GPU; this file imports no JAX, so it runs on a
machine with the card and PyTorch alone:

    PYTHONPATH=src python -m pytest -m cuda tests/test_torch_cuda.py -q
"""
import numpy as np
import pytest

torch = pytest.importorskip("torch")

from repro_torch.kernels import ibn_conv, ops  # noqa: E402
from repro_torch.kernels.ref import ibn_pointwise_ref  # noqa: E402

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
    monkeypatch.setitem(ibn_conv._devices, x.device.index, ((8, 0), 132))
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
