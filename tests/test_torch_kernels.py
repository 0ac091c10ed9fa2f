"""The port's ibn_pointwise: its plain version against the Pallas kernel
(run in interpret mode, as tests/test_kernels.py runs it), its gradient
against ``jax.grad`` of the reference oracle, and its dispatch rules. The
CUDA kernel itself is tested on the card by tests/test_torch_cuda.py.

Inputs come from numpy seeds.
"""
from pathlib import Path

import numpy as np
import pytest

torch = pytest.importorskip("torch")
import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

from repro.kernels import ref as jref  # noqa: E402
from repro.kernels.ibn_conv import ibn_pointwise as pallas_ibn_pointwise  # noqa: E402
from repro_torch.kernels import build as kbuild  # noqa: E402
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


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("m,n,k", [(100352, 96, 16), (16, 96, 100352), (392, 1280, 320),
                                   (8, 4, 96), (1, 1, 1)])
def test_split_k_plan_covers_k(m, n, k, dtype):
    """The planner's split of K over a cluster: every K step belongs to
    exactly one rank, each rank's range starts on a K step, a power of two
    up to the cluster limit, no split where the tiles fill the card, the
    smallest tile where they do not, and the deep K step only for long
    ranges."""
    for max_cluster in (8, 16):
        (bm, bn, step), splits, k_chunk = ibn_conv.plan(m, n, k, dtype, 132, max_cluster)
        assert (bm, bn, step) in ibn_conv.TILES[dtype]
        assert 1 <= splits <= max_cluster and splits & (splits - 1) == 0
        assert k_chunk % step == 0 and k_chunk >= step
        used = -(-k // k_chunk)  # ranks with a K range; the rest add zeros
        assert used <= splits and (used - 1) * k_chunk < k <= splits * k_chunk
        if splits > 1:
            assert k_chunk >= ibn_conv.MIN_STEPS * step
        tiles = -(-m // bm) * -(-n // bn)
        if -(-m // 64) * -(-n // 64) >= 132:
            assert splits == 1 and (bm, bn) == (64, 64)
        else:  # the smallest tile of the type
            assert (bm, bn) == min(b[:2] for b in ibn_conv.TILES[dtype])
        if 1 < splits < max_cluster:
            assert tiles * splits >= 132 or -(-k // (2 * splits * step)) < ibn_conv.MIN_STEPS
        deeper = [b[2] for b in ibn_conv.TILES[dtype] if b[:2] == (bm, bn) and b[2] > step]
        assert not deeper or k_chunk < ibn_conv.DEEP_K


@pytest.mark.parametrize("m,k,n", [(64, 960, 160), (64, 960, 320), (48, 16384, 96),
                                   (16, 16384, 48), (96, 100352, 16)])
def test_plan_fills_the_card_where_k_allows(m, k, n):
    """The long-K products of the search (K 960) and the backward's dw
    (M = Cin, N = Cout, K = pixels) run on at least one wave of 132 SMs, or
    on every CTA that K steps of MIN_STEPS each and clusters of 16 give;
    the dw products walk their long K ranges in deep steps."""
    (bm, bn, step), splits, k_chunk = ibn_conv.plan(m, n, k, torch.float32, 132, 16)
    tiles = -(-m // bm) * -(-n // bn)
    assert splits > 1
    assert tiles * splits >= 132 or splits == 16 or k_chunk == ibn_conv.MIN_STEPS * step
    assert (step == 64) == (k_chunk >= ibn_conv.DEEP_K)
    if k >= 16384:
        assert step == 64


def test_operands_are_read_as_they_lie_where_a_tma_map_can():
    """``_operand``: contiguous x, w and the backward's transposed views go
    to the kernel as they are (K-major or MN-major, with their outer
    stride); an operand whose rows are not 16-byte aligned (EfficientNet's
    6-channel squeeze-excite) is copied into a padded K-major one with the
    same values."""
    x = torch.randn(40, 24)
    w = torch.randn(24, 96)
    for t, k_axis, kmajor, stride in ((x, 1, True, 24), (w, 0, False, 96),
                                      (w.t(), 1, False, 96), (x.t(), 0, True, 24)):
        got, got_kmajor, got_stride = ibn_conv._operand(t, k_axis)
        assert got is t and got_kmajor == kmajor and got_stride == stride
    for t, k_axis in ((torch.randn(8, 6), 1), (torch.randn(6, 10), 0),
                      (torch.randn(10, 6).t(), 0), (torch.randn(32, 12)[:, 1:7], 1)):
        got, kmajor, stride = ibn_conv._operand(t, k_axis)
        assert got is not t and kmajor and stride % 4 == 0 and got.stride(k_axis) == 1
        assert torch.equal(got, t) and got.data_ptr() % 16 == 0
    bf = torch.randn(8, 24).bfloat16()
    assert ibn_conv._operand(bf, 1)[0] is bf  # 48-byte rows
    odd = torch.randn(8, 12).bfloat16()  # 24-byte rows
    got, _, stride = ibn_conv._operand(odd, 1)
    assert stride == 16 and torch.equal(got, odd)


def test_library_path_digests_the_headers_a_source_includes(tmp_path):
    """Editing a header that a source includes (directly or through another
    header) names another library, so the build does not load a stale one;
    editing a header it does not include, or a system include, does not."""
    src = tmp_path / "k.cu"
    src.write_text('#include <cstdint>\n#include "a.cuh"\nint k() { return A + B; }\n')
    (tmp_path / "a.cuh").write_text('#pragma once\n  #  include "b.cuh"\nconstexpr int A = 1;\n')
    (tmp_path / "b.cuh").write_text("constexpr int B = 2;\n")
    (tmp_path / "c.cuh").write_text("constexpr int C = 3;\n")
    assert kbuild._local_includes(src) == [tmp_path / "a.cuh", tmp_path / "b.cuh"]
    first = kbuild.library_path(src)
    assert first.parent == kbuild.BUILD_DIR and first.name.startswith("libk-")
    assert kbuild.library_path(src) == first
    (tmp_path / "c.cuh").write_text("constexpr int C = 4;\n")
    assert kbuild.library_path(src) == first
    (tmp_path / "b.cuh").write_text("constexpr int B = 5;\n")
    second = kbuild.library_path(src)
    assert second != first
    (tmp_path / "a.cuh").write_text('#pragma once\n#include "b.cuh"\nconstexpr int A = 6;\n')
    assert kbuild.library_path(src) not in (first, second)
    # the port's kernels: all four include the shared Hopper header
    csrc = Path(ibn_conv.SOURCE).parent
    for name in ("ibn_pointwise.cu", "gmm.cu", "flash_attention.cu", "ssd_scan.cu"):
        assert kbuild._local_includes(csrc / name) == [csrc / "hopper.cuh"]
