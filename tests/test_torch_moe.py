"""The port's grouped matmul and MoE transformer against the JAX reference
on the CPU: gmm's plain version against the Pallas kernel (interpret mode,
as tests/test_kernels.py runs it), routing, dispatch and combine on the
same inputs, then ``models.moe`` forward (logits and the router's aux
loss) and decode on the same parameters. The CUDA kernel itself is tested
on the card by tests/test_torch_cuda.py.

Config: ``qwen2_moe_a2_7b.SMOKE`` (6 experts, top-2, 2 shared experts).
Parameters, tokens and inputs come from numpy seeds and go to both.
Routing is compared in fp32, where the top-k has no ties: ``jax.lax.top_k``
and ``torch.topk`` may order exact ties differently.
"""
import dataclasses
import functools
from types import SimpleNamespace

import numpy as np
import pytest

torch = pytest.importorskip("torch")
import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

from repro.configs import qwen2_moe_a2_7b as ref_qwen2_moe  # noqa: E402
from repro.kernels import ref as jref  # noqa: E402
from repro.kernels.gmm import gmm as pallas_gmm  # noqa: E402
from repro.models import moe as RM  # noqa: E402
from repro_torch.kernels import gmm as tgmm  # noqa: E402
from repro_torch.kernels import ops  # noqa: E402
from repro_torch.models import api, moe as TM  # noqa: E402
from test_torch_ssm import (GRAD_TOL, _port, _shapes, draw_params, model_vjp,  # noqa: E402
                            rel, tokens)

GMM_TOL = {"float32": 1e-4, "bfloat16": 1e-1}  # tests/test_kernels.py's
ROUTE_TOL = 1e-6  # top_w, aux and combine: fp32, the same sums
# logits relative to max |reference logit|: fp32 sums in another order;
# bf16 rounds at other places in the two frameworks (and no token's top-k
# flips at this seed: a flip moves that token's output by O(1))
LOGIT_TOL = {"float32": 1e-4, "bfloat16": 2e-2}
# fp32 compute, relative to max |logit|. The cache holds bf16: where the two
# frameworks' fp32 k/v differ by 1e-7 across a bf16 rounding boundary, one
# cached element rounds the other way and moves a logit by up to ~2e-3 of
# the largest one (at some token seeds); at this seed none does, and the two
# agree to ~1e-6
DECODE_TOL = 2e-3
B, P, MAX, STEPS = 2, 10, 24, 6
CFG = ref_qwen2_moe.SMOKE

GMM_SHAPES = [(4, 64, 32, 48), (2, 100, 70, 30), (8, 128, 256, 128), (1, 8, 8, 8)]


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("e,c,d,f", GMM_SHAPES)
def test_plain_gmm_matches_pallas_kernel(e, c, d, f, dtype):
    rng = np.random.default_rng(0)
    x = rng.normal(size=(e, c, d)).astype(np.float32)
    w = rng.normal(size=(e, d, f)).astype(np.float32)
    jd = jnp.dtype(dtype)
    want = pallas_gmm(jnp.asarray(x, jd), jnp.asarray(w, jd), block_c=32, block_f=32,
                      block_d=32, interpret=True)
    td = getattr(torch, dtype)
    before = tgmm.LAUNCHES
    got = ops.gmm(torch.from_numpy(x).to(td), torch.from_numpy(w).to(td))
    assert tgmm.LAUNCHES == before  # the plain version on the CPU
    assert got.dtype == td and got.shape == (e, c, f)
    assert np.max(np.abs(got.float().numpy() - np.asarray(want, np.float32))) < GMM_TOL[dtype]
    oracle = jref.gmm_ref(jnp.asarray(x, jd), jnp.asarray(w, jd))
    assert np.max(np.abs(got.float().numpy() - np.asarray(oracle, np.float32))) < GMM_TOL[dtype]


def test_gmm_takes_strided_views():
    rng = np.random.default_rng(1)
    x = torch.from_numpy(rng.normal(size=(3, 20, 12)).astype(np.float32))
    w = torch.from_numpy(rng.normal(size=(3, 16, 12)).astype(np.float32))
    got = ops.gmm(x[:, ::2], w.transpose(1, 2))  # (3, 10, 12) @ (3, 12, 16)
    want = torch.einsum("ecd,efd->ecf", x[:, ::2], w)
    assert torch.max(torch.abs(got - want)).item() < 1e-5


_gmm_vjp = jax.jit(lambda x, w, dy: jax.vjp(jref.gmm_ref, x, w)[1](dy))


def gmm_grad_err(e, c, d, f, strided):
    """max |port grad - jax.vjp grad| / max |jax.vjp grad| over dx and dw of
    ``ops.gmm`` (contiguous, or a row-strided x and a transposed w), fp32."""
    rng = np.random.default_rng(5)
    x = rng.normal(size=(e, c, d)).astype(np.float32)
    w = rng.normal(size=(e, d, f)).astype(np.float32)
    dy = rng.normal(size=(e, c, f)).astype(np.float32)
    want = _gmm_vjp(jnp.asarray(x), jnp.asarray(w), jnp.asarray(dy))
    tx = torch.from_numpy(np.repeat(x, 2, axis=1) if strided else x).requires_grad_(True)
    tw = torch.from_numpy(w.transpose(0, 2, 1).copy() if strided else w).requires_grad_(True)
    xv, wv = (tx[:, ::2], tw.transpose(1, 2)) if strided else (tx, tw)
    before = tgmm.LAUNCHES
    ops.gmm(xv, wv).backward(torch.from_numpy(dy))
    assert tgmm.LAUNCHES == before
    gx = tx.grad[:, ::2] + tx.grad[:, 1::2] if strided else tx.grad
    gw = tw.grad.transpose(1, 2) if strided else tw.grad
    if strided:
        assert not tx.grad[:, 1::2].any()  # the rows the view skips get no gradient
    err = 0.0
    for got, ref_grad in ((gx, want[0]), (gw, want[1])):
        ref_grad = np.asarray(ref_grad)
        assert got.shape == ref_grad.shape
        err = max(err, float(np.max(np.abs(got.numpy() - ref_grad)) / np.abs(ref_grad).max()))
    return err


@pytest.mark.parametrize("strided", [False, True])
@pytest.mark.parametrize("e,c,d,f", GMM_SHAPES[:3])
def test_gmm_gradient_matches_jax_grad(e, c, d, f, strided):
    """``ops.gmm``'s backward (``dx = dy @ wᵀ`` and ``dw = xᵀ @ dy``, two
    more grouped products) against ``jax.vjp`` of the reference's einsum on
    the same inputs and cotangent, fp32, on contiguous operands and on the
    MoE layer's kind of views (a row-strided x, a transposed w); no kernel
    launch on the CPU."""
    assert gmm_grad_err(e, c, d, f, strided) < GMM_TOL["float32"]


@pytest.mark.parametrize("e,c,d,f", [(3, 45, 40, 70), (2, 100, 70, 30), (3, 129, 33, 257)])
def test_gmm_pads_what_the_bf16_body_cannot_read(e, c, d, f):
    """The wrapper's copy for bf16 operands the kernel's bf16 body does not
    take (here a w whose row stride, F + 1, is no multiple of 8): zeros past
    D and F leave the product's first F columns unchanged. Contiguous
    operands with D and F multiples of 8 are read as they are."""
    rng = np.random.default_rng(2)
    x = torch.from_numpy(rng.normal(size=(e, 2 * c, d)).astype(np.float32)).bfloat16()[:, ::2]
    w = torch.from_numpy(rng.normal(size=(e, d, f + 1)).astype(np.float32)).bfloat16()[..., :f]
    assert not tgmm._fits_bf16_body(w)  # unit stride along F, its row stride F + 1
    dp, fp = d + -d % 8, f + -f % 8
    xp, wp = tgmm._padded(x, c, dp), tgmm._padded(w, dp, fp)
    assert xp.is_contiguous() and wp.is_contiguous() and wp.shape == (e, dp, fp)
    assert tgmm._fits_bf16_body(xp) and tgmm._fits_bf16_body(wp)
    assert torch.equal(xp[:, :, :d], x) and not xp[:, :, d:].any() and not wp[:, :, f:].any()
    want = torch.bmm(x.float(), w.float())
    got = torch.bmm(xp.float(), wp.float())[..., :f]
    assert torch.max(torch.abs(got - want)).item() <= 1e-5 * want.abs().max().item()
    fits = torch.zeros((e, 8, 16), dtype=torch.bfloat16)
    assert tgmm._fits_bf16_body(fits) and not tgmm._fits_bf16_body(fits[:, :, 1:9])


@pytest.mark.parametrize("e,c,d,f", [(3, 45, 40, 72), (2, 33, 1000, 1408), (60, 8, 64, 256)])
def test_gmm_reads_tma_describable_views_as_they_are(e, c, d, f):
    """The bf16 body reads x[:, ::2], contiguous operands and transposed
    views (unit stride along D for w, along C for x) through TMA maps of
    their own layout, without a copy; a w whose F is not a multiple of 8,
    and operands whose strides no map describes, are copied into
    zero-padded contiguous operands."""
    rng = np.random.default_rng(4)
    x = torch.from_numpy(rng.normal(size=(e, 2 * c, d)).astype(np.float32)).bfloat16()[:, ::2]
    w = torch.from_numpy(rng.normal(size=(e, d, f)).astype(np.float32)).bfloat16()
    wt = w.transpose(1, 2).contiguous().transpose(1, 2)  # unit stride along D
    # unit stride along C, a D stride of C rounded up to 8
    xt = torch.zeros((e, d, c + -c % 8), dtype=torch.bfloat16)[..., :c].transpose(1, 2)
    xt.copy_(x)
    for xa, wa in ((x, w), (x, wt), (xt, w), (xt, wt)):
        xs, ws = tgmm._tma_operands(xa, wa)
        assert xs is xa and ws is wa
    narrow = w[:, :, :f - 3]
    w_odd = torch.zeros((e, f, d + 1), dtype=torch.bfloat16)[..., :d].transpose(1, 2)
    for other in (narrow, w_odd):  # F off 8; unit stride along D, an F stride of D + 1
        xs, ws = tgmm._tma_operands(x, other)
        assert xs is x and ws.is_contiguous()
        assert ws.shape == (e, d, other.shape[2] + -other.shape[2] % 8)
        assert torch.equal(ws[..., :other.shape[2]], other) and not ws[..., other.shape[2]:].any()
    x_odd = torch.zeros((e, d, 2 * c + 1), dtype=torch.bfloat16)[..., :c].transpose(1, 2)
    xs, _ = tgmm._tma_operands(x_odd, w)  # unit stride along C, a D stride of 2C + 1
    assert xs.is_contiguous() and torch.equal(xs[..., :d], x_odd) and not xs[..., d:].any()


@pytest.mark.parametrize("view,layout", [
    ("contiguous", 0), ("rows ::2", 0), ("transposed", 1), ("transposed expert-strided", 1),
    ("expert-strided", 0), ("stride 12", None), ("transposed stride 12", None),
    ("offset start", None), ("column stride 2", None)])
def test_gmm_layout_flag_of_each_operand(view, layout):
    """``gmm._layout``: the layout the kernel is told for a bf16 operand (0:
    unit stride along its last axis, 1: along its middle axis), or None where
    no TMA map describes it and ``launch`` copies it."""
    base = torch.zeros((4, 48, 64), dtype=torch.bfloat16)
    t = {"contiguous": base, "rows ::2": base[:, ::2],
         "transposed": base.transpose(1, 2),
         "transposed expert-strided": base[::2].transpose(1, 2),
         "expert-strided": base[1::2],
         "stride 12": torch.zeros((4, 48, 12), dtype=torch.bfloat16)[..., :8],
         "transposed stride 12": torch.zeros((4, 48, 12), dtype=torch.bfloat16)[..., :8]
         .transpose(1, 2),
         "offset start": base.flatten()[1:1 + 4 * 48 * 56].view(4, 48, 56),
         "column stride 2": base[..., ::2]}[view]
    assert tgmm._layout(t) == layout
    assert tgmm._fits_bf16_body(t) == (layout is not None)


@pytest.mark.parametrize("e,c,d,f", [(3, 688, 64, 48), (2, 100, 72, 40), (4, 33, 16, 24)])
def test_gmm_backward_passes_transposed_views_as_they_are(monkeypatch, e, c, d, f):
    """On meta tensors (the path a shape-only trace takes), ``Gmm.backward``'s
    transposed views wᵀ and xᵀ reach the launch as they are: no operand is
    copied, dx's launch reads w at layout 1 (unit stride along D) and dy at
    0, dw's xᵀ at 1 and dy at 0. Two launches, dx then dw."""
    copies, seen = [], []
    padded, operands = tgmm._padded, tgmm._tma_operands
    monkeypatch.setattr(tgmm, "_padded", lambda *a: copies.append(a) or padded(*a))

    def recording(x, w):
        got = operands(x, w)
        seen.append((got, (x, w)))
        return got

    monkeypatch.setattr(tgmm, "_tma_operands", recording)
    x = torch.empty((e, c, d), dtype=torch.bfloat16, device="meta", requires_grad=True)
    w = torch.empty((e, d, f), dtype=torch.bfloat16, device="meta", requires_grad=True)
    y = tgmm.gmm(x, w)
    assert y.shape == (e, c, f) and len(seen) == 1
    dx, dw = torch.autograd.grad(y, (x, w), torch.empty_like(y))
    assert dx.shape == x.shape and dw.shape == w.shape and dx.dtype == dw.dtype == x.dtype
    assert not copies and len(seen) == 3
    for (got, passed) in seen:
        assert all(g is p for g, p in zip(got, passed))
    (dx_a, dx_b), (dw_a, dw_b) = seen[1][0], seen[2][0]
    assert (dx_b.shape, dw_a.shape) == ((e, f, d), (e, d, c))
    assert [tgmm._layout(t) for t in (dx_a, dx_b, dw_a, dw_b)] == [0, 1, 1, 0]


def test_capacity_matches_reference():
    for n in (1, 7, 512, 2048, 4096, 4097, 8192, 12345):
        for cfg in (CFG, ref_qwen2_moe.CONFIG):
            assert TM.capacity_for(n, _port(cfg)) == RM.capacity_for(n, cfg)


@pytest.mark.parametrize("capacity,e_start,e_count", [(None, 0, 6), (6, 0, 6), (4, 2, 3)])
def test_route_dispatch_combine_match_reference(capacity, e_start, e_count):
    """Router top-k, aux loss, the capacity buckets (with drops, and a local
    slice of the experts as EP would take) and the weighted combine, fp32."""
    rng = np.random.default_rng(2)
    n, d = 40, CFG.d_model
    x2d = rng.normal(size=(n, d)).astype(np.float32)
    wr = (rng.normal(size=(d, CFG.num_experts)) / np.sqrt(d)).astype(np.float32)
    cap = capacity or RM.capacity_for(n, CFG)
    jw, je, jaux = RM.route(jnp.asarray(x2d), jnp.asarray(wr), CFG)
    tw, te, taux = TM.route(torch.from_numpy(x2d), torch.from_numpy(wr), _port(CFG))
    assert np.array_equal(te.numpy(), np.asarray(je))
    assert np.max(np.abs(tw.numpy() - np.asarray(jw))) < ROUTE_TOL
    assert abs(float(taux) - float(jaux)) < ROUTE_TOL
    jbuf, jdest, jkeep = RM.dispatch(jnp.asarray(x2d), je, CFG.num_experts, cap, e_start,
                                     e_count)
    tbuf, tdest, tkeep = TM.dispatch(torch.from_numpy(x2d), te, CFG.num_experts, cap,
                                     e_start, e_count)
    assert np.array_equal(tdest.numpy(), np.asarray(jdest))
    assert np.array_equal(tkeep.numpy(), np.asarray(jkeep))
    assert np.array_equal(tbuf.numpy(), np.asarray(jbuf))
    if capacity is not None:
        assert not tkeep.all()  # some assignments are dropped
    y_buf = rng.normal(size=tuple(tbuf.shape)).astype(np.float32)
    want = RM.combine(jnp.asarray(y_buf), jdest, jkeep, jw, n, CFG.num_experts_per_tok)
    got = TM.combine(torch.from_numpy(y_buf), tdest, tkeep, tw, n, CFG.num_experts_per_tok)
    assert np.max(np.abs(got.numpy() - np.asarray(want))) < ROUTE_TOL


def test_ep_scheme_matches_reference_and_sharded_schemes_decompose():
    """The scheme choice equals the reference's; and the math each sharded
    scheme runs on a rank sums, over the model axis's ranks, to the
    single-device layer: EP's ranks each their E / M experts from
    ``e_start = rank * e_count``, TPE's each a slice of every expert's
    hidden dim (tests/test_torch_sharded.py runs both in a world)."""
    for size in (1, 2, 3, 4, 5):
        pc = SimpleNamespace(model_size=size)
        assert TM.ep_scheme(_port(CFG), pc) == RM.ep_scheme(CFG, pc)
    assert TM.ep_scheme(_port(CFG), None) == "ref"
    cfg = _port(CFG, compute_dtype="float32")
    params = TM.init(0, cfg, device="cpu")
    layer0 = {k: t[0] for k, t in params["layers"]["moe"].items() if k != "shared"}
    x = torch.from_numpy(np.random.default_rng(3).normal(size=(2, 5, CFG.d_model))
                         .astype(np.float32))
    want, aux = TM.moe_ffn(layer0, x, cfg)
    wr, wg, wu, wo = (layer0[k] for k in ("router", "wg", "wu", "wo"))
    for m in (2, 3):  # EP: 6 experts over 2 or 3 ranks
        ec = cfg.num_experts // m
        parts = [TM._moe_ffn_local(x, wr, wg[r * ec:(r + 1) * ec], wu[r * ec:(r + 1) * ec],
                                   wo[r * ec:(r + 1) * ec], cfg, r * ec, ec) for r in range(m)]
        assert torch.allclose(sum(o for o, _ in parts), want, atol=1e-5, rtol=0)
        assert all(torch.equal(a, aux) for _, a in parts)
    f = cfg.moe_d_ff // 4  # TPE: the hidden dim over 4 ranks
    parts = [TM._moe_ffn_local(x, wr, wg[..., r * f:(r + 1) * f], wu[..., r * f:(r + 1) * f],
                               wo[:, r * f:(r + 1) * f], cfg, 0, cfg.num_experts)[0]
             for r in range(4)]
    assert torch.allclose(sum(parts), want, atol=1e-5, rtol=0)


@functools.lru_cache(maxsize=None)
def _params():
    return draw_params(CFG, RM, 3)


@pytest.mark.parametrize("compute_dtype", ["float32", "bfloat16"])
def test_forward_and_aux_match_reference(compute_dtype):
    cfg = dataclasses.replace(CFG, compute_dtype=compute_dtype)
    toks = tokens(cfg.vocab_size, 16, seed=4)
    want, want_aux = jax.jit(lambda p, t: RM.forward(p, {"tokens": t}, cfg))(
        _params(), jnp.asarray(toks))
    want = np.asarray(want, np.float32)
    params = TM.params_from_reference(_params(), "cpu")
    before = tgmm.LAUNCHES
    logits, aux = api.forward(params, {"tokens": torch.from_numpy(toks)}, _port(cfg))
    assert tgmm.LAUNCHES == before
    assert logits.shape == want.shape and logits.dtype == torch.float32
    assert rel(logits.numpy(), want) < LOGIT_TOL[compute_dtype]
    assert aux.shape == () and aux.dtype == torch.float32
    assert abs(float(aux) - float(want_aux)) < (1e-6 if compute_dtype == "float32" else 1e-2)


def test_vjp_matches_reference():
    """H8: the port's MoE transformer differentiates (the expert products'
    backward is grouped products) and its parameter gradients, router and
    shared experts included, equal the reference's, fp32."""
    cfg = dataclasses.replace(CFG, compute_dtype="float32")
    errs = model_vjp(RM, TM, _params(), cfg, tokens(cfg.vocab_size, 16, seed=13), 14)
    assert max(errs.values()) < GRAD_TOL, errs


def test_decode_steps_match_reference():
    """Fill a bf16 cache from a P-token prompt with one multi-token decode
    step, then decode STEPS tokens (teacher-forced); every step's logits
    against the reference's, fp32 compute."""
    cfg = dataclasses.replace(CFG, compute_dtype="float32")
    toks = tokens(cfg.vocab_size, P + STEPS, seed=0)
    step = jax.jit(lambda p, c, t, i: RM.decode_step(p, c, t, i, cfg))
    jcache = RM.init_cache(cfg, B, MAX)
    jlogits, jcache = step(_params(), jcache, jnp.asarray(toks[:, :P]), 0)
    tcfg = _port(cfg)
    params = TM.params_from_reference(_params(), "cpu")
    tcache = api.init_cache(tcfg, B, MAX, device="cpu")
    tlogits, tcache = api.decode_step(params, tcache, torch.from_numpy(toks[:, :P]), 0, tcfg)
    assert tlogits.shape == (B, P, tcfg.vocab_size)
    assert rel(tlogits.numpy(), np.asarray(jlogits)) < DECODE_TOL
    for t in range(STEPS):
        jl, jcache = step(_params(), jcache, jnp.asarray(toks[:, P + t:P + t + 1]), P + t)
        tl, tcache = api.decode_step(params, tcache, torch.from_numpy(toks[:, P + t:P + t + 1]),
                                     P + t, tcfg)
        assert rel(tl[:, 0].numpy(), np.asarray(jl[:, 0])) < DECODE_TOL, f"step {t}"


def test_init_shapes_and_statistics():
    cfg = _port(CFG)
    ours = api.init(0, cfg, device="cpu")
    assert _shapes(ours) == _shapes(_params())
    moe = ours["layers"]["moe"]
    assert moe["router"].dtype == torch.float32 and moe["shared_gate"].dtype == torch.float32
    assert abs(moe["wo"].std().item() * np.sqrt(cfg.moe_d_ff) - 1) < 0.1
    assert not torch.equal(moe["wg"][0, 0], moe["wg"][0, 1])  # experts drawn apart
