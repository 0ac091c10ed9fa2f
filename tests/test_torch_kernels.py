"""The port's ibn_pointwise: its plain version against the Pallas kernel
(run in interpret mode, as tests/test_kernels.py runs it), its gradient
against ``jax.grad`` of the reference oracle, and its dispatch rules. The
CUDA kernel itself is tested on the card by tests/test_torch_cuda.py.

Inputs come from numpy seeds.
"""
import numpy as np
import pytest

torch = pytest.importorskip("torch")
import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

from repro.kernels import ref as jref  # noqa: E402
from repro.kernels.ibn_conv import ibn_pointwise as pallas_ibn_pointwise  # noqa: E402
from repro_torch.kernels import ibn_conv, ops  # noqa: E402
from repro_torch.kernels.ref import ibn_pointwise_ref  # noqa: E402

TOL = {"float32": 1e-4, "bfloat16": 2e-2}
GRAD_TOL = 1e-4

# tests/test_kernels.py's shapes, plus two ragged ones (nothing a multiple
# of the block sizes)
SHAPES = [
    (256, 32, 64, "relu"), (100, 48, 40, "silu"), (512, 128, 96, "none"),
    (64, 16, 8, "relu"), (77, 13, 50, "silu"), (130, 70, 33, "relu"),
]


def _inputs(n, ci, co, seed=0):
    rng = np.random.default_rng(seed)
    x = rng.normal(size=(n, ci)).astype(np.float32)
    # outputs of order 1, so one bf16 rounding step stays under the bf16 tolerance
    w = (rng.normal(size=(ci, co)) * 0.25 / np.sqrt(ci)).astype(np.float32)
    b = (rng.normal(size=(co,)) * 0.25).astype(np.float32)
    return x, w, b


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("n,ci,co,act", SHAPES)
def test_ref_matches_pallas_kernel(n, ci, co, act, dtype):
    x, w, b = _inputs(n, ci, co)
    jd = jnp.dtype(dtype)
    want = pallas_ibn_pointwise(
        jnp.asarray(x, jd), jnp.asarray(w, jd), jnp.asarray(b, jd), act=act,
        block_n=64, block_f=32, block_k=32, interpret=True)
    td = getattr(torch, dtype)
    got = ibn_pointwise_ref(torch.from_numpy(x).to(td), torch.from_numpy(w).to(td),
                            torch.from_numpy(b).to(td), act)
    assert got.dtype == td
    err = np.max(np.abs(got.float().numpy() - np.asarray(want, np.float32)))
    assert err < TOL[dtype]


def _jax_grads(x, w, b, dy, act):
    def f(x, w, b):
        return jnp.sum(jref.ibn_pointwise_ref(x, w, b, act) * dy)

    return jax.grad(f, argnums=(0, 1, 2))(jnp.asarray(x), jnp.asarray(w), jnp.asarray(b))


@pytest.mark.parametrize("act", ["relu", "silu", "none"])
@pytest.mark.parametrize("n,ci,co", [(96, 24, 40), (33, 7, 5)])
def test_gradient_matches_jax_grad(n, ci, co, act):
    x, w, b = _inputs(n, ci, co, seed=1)
    dy = np.random.default_rng(2).normal(size=(n, co)).astype(np.float32)
    tx, tw, tb = (torch.from_numpy(a).requires_grad_(True) for a in (x, w, b))
    y = ops.ibn_pointwise(tx, tw, tb, act=act)
    y.backward(torch.from_numpy(dy))
    want = _jax_grads(x, w, b, dy, act)
    for got, ref in zip((tx.grad, tw.grad, tb.grad), want):
        assert got.shape == ref.shape
        assert np.max(np.abs(got.numpy() - np.asarray(ref))) < GRAD_TOL


def test_gradient_without_bias():
    x, w, _ = _inputs(40, 12, 20, seed=3)
    dy = np.random.default_rng(4).normal(size=(40, 20)).astype(np.float32)
    tx, tw = (torch.from_numpy(a).requires_grad_(True) for a in (x, w))
    ops.ibn_pointwise(tx, tw, None, act="none").backward(torch.from_numpy(dy))
    gx, gw, _ = _jax_grads(x, w, np.zeros(20, np.float32), dy, "none")
    assert np.max(np.abs(tx.grad.numpy() - np.asarray(gx))) < GRAD_TOL
    assert np.max(np.abs(tw.grad.numpy() - np.asarray(gw))) < GRAD_TOL


def test_cpu_tensors_take_the_plain_version_and_count_no_launch():
    x, w, b = (torch.from_numpy(a) for a in _inputs(50, 10, 6))
    before = ibn_conv.LAUNCHES
    y = ops.ibn_pointwise(x, w, b, act="silu")
    assert ibn_conv.LAUNCHES == before
    assert torch.equal(y, ibn_pointwise_ref(x, w, b, "silu"))


def test_kernel_launch_refuses_cpu_tensors():
    x, w, b = (torch.from_numpy(a) for a in _inputs(8, 4, 4))
    with pytest.raises(ValueError, match="CUDA"):
        ibn_conv.launch(x, w, b, "relu")


@pytest.mark.parametrize("m,n,k", [(100352, 96, 16), (16, 96, 100352), (392, 1280, 320),
                                   (8, 4, 96), (1, 1, 1)])
def test_split_k_plan_covers_k(m, n, k):
    splits, k_chunk = ibn_conv._split_k(m, n, k, sms=132)
    assert splits >= 1 and k_chunk % 16 == 0
    assert (splits - 1) * k_chunk < k <= splits * k_chunk
    if m * n >= 264 * 64 * 64:
        assert splits == 1
