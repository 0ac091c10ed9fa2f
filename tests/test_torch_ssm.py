"""The port's SSD chunk scan and Mamba2 LM against the JAX reference on the
CPU: the scan's plain version against the Pallas kernel (interpret mode,
as tests/test_kernels.py runs it), the sequential oracle and the model's
chunked path; then ``models.ssm`` forward and decode on the same
parameters. The CUDA kernel itself is tested on the card by
tests/test_torch_cuda.py.

Config: ``mamba2_370m.SMOKE``. Parameters, tokens and scan inputs come from
numpy seeds and go to both.
"""
import collections
import dataclasses
import functools
import sys
from pathlib import Path

import numpy as np
import pytest

torch = pytest.importorskip("torch")
import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

from repro.configs import mamba2_370m as ref_mamba  # noqa: E402
from repro.kernels import ref as jref  # noqa: E402
from repro.kernels.ssd_scan import ssd_scan as pallas_ssd_scan  # noqa: E402
from repro.models import ssm as RS  # noqa: E402
from repro_torch import configs as tconfigs  # noqa: E402
from repro_torch.config import ModelConfig  # noqa: E402
from repro_torch.kernels import ops, ref  # noqa: E402
from repro_torch.kernels import ssd_scan as tssd  # noqa: E402
from repro_torch.models import api, ssm as TS  # noqa: E402

sys.path.insert(0, str(Path(__file__).resolve().parents[1]))
import chip_smoke  # noqa: E402  (its phases run only under __main__)

# the plain scan against the Pallas kernel and the sequential oracle:
# tests/test_kernels.py's tolerance (fp32, the chunked and sequential forms
# sum in another order)
SCAN_TOL = 2e-3
# against the reference's own chunked path, the same algorithm in fp32:
# relative to max |y|
CHUNKED_TOL = 1e-5
# logits relative to max |reference logit|. fp32: sums in another order.
# bf16: the two frameworks round at other places (XLA keeps fused chains in
# fp32). The port's bf16 logits measure 2.41e-2 from the reference's here
# (2.63e-2 for the hybrid), about as far as the reference's own bf16 logits
# sit from its fp32 ones (2.39e-2, 2.83e-2), so no limit below that gap
# holds; a wrong scan, state or position moves logits by O(1)
LOGIT_TOL = {"float32": 1e-4, "bfloat16": 3e-2}
DECODE_TOL = 2e-3  # decode steps, fp32 compute, relative to max |logit|
# gradients, fp32: relative to the largest |reference gradient| of each
# input or parameter, or absolute below 1 (the same sums in another order)
GRAD_TOL = 1e-4

# tests/test_kernels.py's (b, s, h, p, g, n, chunk), plus a ragged tail
# with G > 1 and a chunk longer than S
SCAN_SHAPES = [
    (2, 64, 4, 16, 1, 32, 16), (1, 128, 4, 8, 2, 16, 32), (2, 96, 2, 32, 1, 64, 32),
    (1, 48, 8, 16, 4, 8, 48), (1, 37, 4, 16, 2, 16, 16), (2, 20, 2, 8, 1, 8, 64),
]
B, S, STEPS = 2, 12, 6


def scan_inputs(b, s, h, p, g, n, seed=0):
    """x, dt (softplus of a normal), A (-exp of a normal), B, C as numpy
    fp32, as tests/test_kernels.py draws them."""
    rng = np.random.default_rng(seed)
    x = rng.normal(size=(b, s, h, p)).astype(np.float32)
    dt = np.log1p(np.exp(rng.normal(size=(b, s, h)))).astype(np.float32)
    A = (-np.exp(rng.normal(size=(h,)))).astype(np.float32)
    Bm = rng.normal(size=(b, s, g, n)).astype(np.float32)
    Cm = rng.normal(size=(b, s, g, n)).astype(np.float32)
    return x, dt, A, Bm, Cm


def _t(*arrays):
    return [torch.from_numpy(a) for a in arrays]


@pytest.mark.parametrize("b,s,h,p,g,n,chunk", SCAN_SHAPES)
def test_plain_scan_matches_pallas_kernel_and_sequential_oracle(b, s, h, p, g, n, chunk):
    inputs = scan_inputs(b, s, h, p, g, n)
    before = tssd.LAUNCHES
    y, st = ops.ssd_scan(*_t(*inputs), chunk=chunk)  # the plain version on the CPU
    assert tssd.LAUNCHES == before
    assert y.shape == (b, s, h, p) and st.shape == (b, h, p, n) and st.dtype == torch.float32
    jy, jst = pallas_ssd_scan(*map(jnp.asarray, inputs), chunk=chunk, interpret=True)
    ry, rst = jref.ssd_scan_ref(*map(jnp.asarray, inputs), chunk)
    for want_y, want_st in ((jy, jst), (ry, rst)):
        assert np.max(np.abs(y.numpy() - np.asarray(want_y))) < SCAN_TOL
        assert np.max(np.abs(st.numpy() - np.asarray(want_st))) < SCAN_TOL
    # the port's sequential oracle is the reference's, step for step
    ty, tst = ref.ssd_scan_ref(*_t(*inputs), chunk)
    assert np.max(np.abs(ty.numpy() - np.asarray(ry))) < CHUNKED_TOL * np.abs(ry).max()
    assert np.max(np.abs(tst.numpy() - np.asarray(rst))) < CHUNKED_TOL * np.abs(rst).max()


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("b,s,h,p,g,n,chunk", SCAN_SHAPES)
def test_chunked_scan_matches_model_chunked_path(b, s, h, p, g, n, chunk, dtype):
    """ref.ssd_chunked against repro.models.ssm.ssd_chunked: the same
    chunking (min(chunk, S), zero-padded tail), x, B and C in ``dtype``."""
    x, dt, A, Bm, Cm = scan_inputs(b, s, h, p, g, n, seed=1)
    jd = jnp.dtype(dtype)
    jy, jst = RS.ssd_chunked(jnp.asarray(x, jd), jnp.asarray(dt), jnp.asarray(A),
                             jnp.asarray(Bm, jd), jnp.asarray(Cm, jd), chunk)
    td = getattr(torch, dtype)
    ty, tst = ref.ssd_chunked(torch.from_numpy(x).to(td), torch.from_numpy(dt),
                              torch.from_numpy(A), torch.from_numpy(Bm).to(td),
                              torch.from_numpy(Cm).to(td), chunk)
    assert ty.dtype == td
    jy = np.asarray(jy, np.float32)
    tol_y = CHUNKED_TOL if dtype == "float32" else 2 ** -8  # one bf16 rounding of y
    assert np.max(np.abs(ty.float().numpy() - jy)) <= tol_y * np.abs(jy).max()
    assert np.max(np.abs(tst.numpy() - np.asarray(jst))) <= CHUNKED_TOL * np.abs(jst).max()


def test_segsum_masks_above_the_diagonal_before_the_exp():
    x = torch.tensor([[-1.0, -2.0, -3.0]])
    out = ref.segsum(x)
    assert torch.equal(torch.isinf(out[0]), torch.ones(3, 3, dtype=torch.bool).triu(1))
    assert torch.allclose(out[0].tril(), torch.tensor([[0.0, 0, 0], [-2, 0, 0], [-5, -3, 0]]))
    assert torch.isfinite(torch.exp(out)).all()


# the kernel's launch plan at every scan shape chip_smoke.py runs, and at the
# configs' widths (mamba2-370m, zamba2-7b and their SMOKE cuts) at the
# served prefill's 8 x 1024: (b, s, h, p, n, chunk)
def _plan_shapes():
    shapes = [(b, s, h, p, n, q) for b, s, h, p, g, n, q in
              chip_smoke.SSD_SMALL + chip_smoke.SSD_EDGES
              + [chip_smoke.SERVE_SSD, chip_smoke.ZAMBA_SSD]]
    shapes.append((8, 1000) + chip_smoke.SERVE_SSD[2:4] + chip_smoke.SERVE_SSD[5:])
    for arch in ("mamba2_370m", "zamba2_7b"):
        for cfg in (tconfigs.get(arch), tconfigs.smoke(arch)):
            shapes.append((8, 1024, cfg.ssm_nheads, cfg.ssm_head_dim, cfg.ssm_state,
                           cfg.ssm_chunk))
    shapes.append((1, tssd.MAX_CHUNK, 1, tssd.MAX_P, tssd.MAX_N, tssd.MAX_CHUNK))
    return shapes


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("b,s,h,p,n,chunk", _plan_shapes())
def test_plan_gives_every_chunk_one_rank_and_fits_shared_memory(b, s, h, p, n, chunk, dtype):
    """``ssd_scan.plan``: every chunk of a (batch, head) is owned by exactly
    one rank of one group, no group is empty, the cluster is a power of two
    within its limit (at least 2 CTAs where there are 2 chunks, and no more
    than the chunks need), and a CTA's shared memory is what the kernel lays
    out and fits the H100's 232,448 bytes, on a full card and a small one."""
    for sms in (132, 16):
        pl = tssd.plan(b, s, h, p, n, chunk, dtype, sms)
        q = min(chunk, s)
        assert pl.chunk == q and pl.chunks == -(-s // q)
        cl = pl.cluster
        assert 1 <= cl <= tssd.MAX_CLUSTER and cl & (cl - 1) == 0
        assert cl >= min(2, pl.chunks) and (cl == 1 or cl // 2 < pl.chunks)
        # the kernel's rule: rank r of group g owns chunk g * cluster + r
        owned = collections.Counter(g * cl + r for g in range(pl.groups) for r in range(cl)
                                    if g * cl + r < pl.chunks)
        assert sorted(owned) == list(range(pl.chunks)) and set(owned.values()) == {1}
        assert (pl.groups - 1) * cl < pl.chunks <= pl.groups * cl
        assert pl.ctas == b * h * cl
        assert (pl.stages, pl.cbufs) in ((-(-q // tssd.TJ), 2), (-(-q // tssd.TJ), 1)) \
            + tssd.BUFFERS
        assert pl.resident == (pl.stages >= -(-q // tssd.TJ))
        assert pl.smem == tssd.smem_bytes(n, q, dtype, pl.stages, pl.cbufs) <= 232448
    # the served shapes take their tiles once (resident) in bf16
    if (b, s, h, p, n, chunk) in [(8, 1024, 32, 64, 128, 256), (2, 512, 112, 64, 64, 256)]:
        assert tssd.plan(b, s, h, p, n, chunk, torch.bfloat16).resident


def model_scan_inputs(b, s, h, p, g, n, seed=3):
    """Scan inputs in mamba2's dt and A ranges (dt = softplus(d + 0.5 normal)
    with softplus(d) log-uniform in [1e-3, 1e-1] per head, A uniform in
    [-16, -1], as ``models.ssm`` initialises them), under which the state
    carries across chunks; numpy fp32."""
    rng = np.random.default_rng(seed)
    x = rng.normal(size=(b, s, h, p)).astype(np.float32)
    d0 = np.exp(rng.uniform(np.log(1e-3), np.log(1e-1), size=(h,)))
    dt = np.log1p(np.exp(np.log(np.expm1(d0)) + 0.5 * rng.normal(size=(b, s, h))))
    A = -rng.uniform(1.0, 16.0, size=(h,))
    Bm = rng.normal(size=(b, s, g, n))
    Cm = rng.normal(size=(b, s, g, n))
    return [a.astype(np.float32) for a in (x, dt, A, Bm, Cm)]


@pytest.mark.parametrize("b,s,h,p,g,n,chunk", [(1, 300, 4, 16, 1, 16, 16),
                                               (2, 200, 4, 8, 2, 16, 16)])
def test_split_controls_fail_the_fp32_limit(b, s, h, p, g, n, chunk):
    """chip_smoke's two controls of the state passed between CTAs, built from
    the plain version alone: the scan run apart on the two sides of the first
    chunk boundary (rank 0's state never reaches rank 1) and of the first
    group boundary (the carry between groups dropped). Each must fail the
    fp32 limit the kernel is held to, so a kernel that drops either state
    cannot pass; the chunks here go to 2 groups of a cluster of 8."""
    inputs = _t(*model_scan_inputs(b, s, h, p, g, n))
    want_y, want_st = ref.ssd_chunked(*inputs, chunk)
    pl = tssd.plan(b, s, h, p, n, chunk, torch.float32)
    assert pl.groups >= 2
    limit = chip_smoke.SSD_TOL[torch.float32]
    for at in (chunk, pl.cluster * chunk):
        y, st = chip_smoke.ssd_split(*inputs, chunk, at)
        assert y.shape == want_y.shape and st.shape == want_st.shape
        assert max(chip_smoke.ssd_rel(y, st, want_y, want_st)) > 10 * limit
    # the undivided scan is within the limit of itself run in one piece
    y, st = ops.ssd_scan(*inputs, chunk=chunk)
    assert max(chip_smoke.ssd_rel(y, st, want_y, want_st)) <= limit


def test_operands_go_to_the_tma_maps_as_they_lie_or_padded():
    """``ssd_scan._operand``: the model's x and its B and C (views into one
    projection) go to the TMA maps as they lie, with their (batch, position,
    head) strides; a tensor whose strides or start are not on 16 bytes is
    copied into rows padded to 16 bytes with the same values."""
    b, s, h, p, g, n = 2, 40, 4, 16, 2, 8
    x = torch.randn(b, s, h, p)
    bc = torch.randn(b, s, 2 * g * n)
    for t in (x, bc[..., :g * n].reshape(b, s, g, n), bc[..., g * n:].reshape(b, s, g, n)):
        got, strides = tssd._operand(t)
        assert got is t and strides == t.stride()[:3]
    for t in (torch.randn(b, s, h, 6), torch.randn(b, s, h, 12)[..., 1:9],
              torch.randn(b, s, h, 12).bfloat16()):
        got, strides = tssd._operand(t)
        assert got is not t and torch.equal(got, t) and strides == got.stride()[:3]
        assert all(st * got.element_size() % 16 == 0 for st in strides)
        assert got.data_ptr() % 16 == 0 and got.stride(3) == 1


_chunked_vjp = jax.jit(lambda args, cts, chunk: jax.vjp(
    lambda *a: RS.ssd_chunked(*a, chunk), *args)[1](cts), static_argnames=("chunk",))


def scan_grad_err(b, s, h, p, g, n, chunk, with_state):
    """Over x, dt, A, B and C: max |port grad - jax.vjp grad| over max(1,
    max |jax.vjp grad|) of ``ops.ssd_scan``, fp32, with y's cotangent alone
    (the final state's gradient ``None``) or the state's too."""
    inputs = scan_inputs(b, s, h, p, g, n, seed=2)
    rng = np.random.default_rng(3)
    dy = rng.normal(size=(b, s, h, p)).astype(np.float32)
    dst = (rng.normal(size=(b, h, p, n)) if with_state else np.zeros((b, h, p, n)))
    dst = dst.astype(np.float32)
    want = _chunked_vjp(tuple(map(jnp.asarray, inputs)), (jnp.asarray(dy), jnp.asarray(dst)),
                        chunk=chunk)
    leaves = [t.requires_grad_(True) for t in _t(*inputs)]
    y, st = ops.ssd_scan(*leaves, chunk=chunk)
    outs, cts = ([y, st], _t(dy, dst)) if with_state else ([y], _t(dy))
    torch.autograd.backward(outs, cts)
    err = 0.0
    for got, ref_grad in zip(leaves, want):
        ref_grad = np.asarray(ref_grad)
        assert got.grad.shape == ref_grad.shape
        err = max(err, float(np.max(np.abs(got.grad.numpy() - ref_grad))
                             / max(1.0, np.abs(ref_grad).max())))
    return err


@pytest.mark.parametrize("with_state", [False, True])
@pytest.mark.parametrize("b,s,h,p,g,n,chunk", SCAN_SHAPES[:2] + SCAN_SHAPES[4:6])
def test_scan_gradient_matches_jax_grad(b, s, h, p, g, n, chunk, with_state):
    """``ops.ssd_scan``'s backward (on the CPU the written-out plain backward,
    ``ref.ssd_chunked_bwd``) for x, dt, A, B and C against ``jax.vjp`` of the
    reference model's
    ``ssd_chunked`` on the same inputs and cotangents, fp32: with y's
    cotangent alone (the final state unused, its gradient ``None``) and with
    the final state's as well."""
    assert scan_grad_err(b, s, h, p, g, n, chunk, with_state) < GRAD_TOL


# bf16: the written-out plain backward against autograd of the plain forward
# (ref.vjp), each gradient relative to its largest value: the two round at
# other places (the plain forward rounds nothing inside, its autograd rounds
# each gradient to the input's type)
BF16_GRAD_TOL = 2e-2


@pytest.mark.parametrize("b,s,h,p,g,n,chunk", SCAN_SHAPES[:2] + SCAN_SHAPES[4:6])
def test_plain_scan_backward_matches_autograd_in_bf16(b, s, h, p, g, n, chunk):
    x, dt, A, Bm, Cm = _t(*scan_inputs(b, s, h, p, g, n, seed=4))
    x, Bm, Cm = x.bfloat16(), Bm.bfloat16(), Cm.bfloat16()
    rng = np.random.default_rng(5)
    dy = torch.from_numpy(rng.normal(size=(b, s, h, p)).astype(np.float32)).bfloat16()
    dst = torch.from_numpy(rng.normal(size=(b, h, p, n)).astype(np.float32))
    got = ref.ssd_chunked_bwd(x, dt, A, Bm, Cm, dy, dst, chunk)
    want = ref.vjp(lambda *t: ref.ssd_chunked(*t, chunk), (x, dt, A, Bm, Cm), (True,) * 5,
                   (dy, dst))
    for gr, w in zip(got, want, strict=True):
        assert gr.dtype == w.dtype and gr.shape == w.shape
        assert ((gr.float() - w.float()).abs().max() / w.float().abs().max()).item() < BF16_GRAD_TOL


# ---------------------------------------------------------------------------
# The Mamba2 LM on the same parameters
# ---------------------------------------------------------------------------


def _port(cfg, **kw) -> ModelConfig:
    return ModelConfig(**dataclasses.asdict(dataclasses.replace(cfg, **kw)))


def draw_params(cfg, module, seed):
    """Numpy parameters in ``module``'s reference tree, drawn as its init
    draws them: unit-fan-in normals for the weights, 1 + 0.1·normal for the
    norm scales and D, log U(1, 16) for A_log, the inverse softplus of a
    log-uniform [1e-3, 0.1] for dt_bias, 0.1·normal for the conv biases."""
    rng = np.random.default_rng(seed)
    shapes = jax.eval_shape(lambda: module.init(jax.random.PRNGKey(0), cfg))

    def draw(path, leaf):
        name = path[-1].key
        if name in ("scale", "D"):
            return (1.0 + 0.1 * rng.normal(size=leaf.shape)).astype(np.float32)
        if name == "A_log":
            return np.log(rng.uniform(1.0, 16.0, size=leaf.shape)).astype(np.float32)
        if name == "dt_bias":
            dt0 = np.exp(rng.uniform(np.log(1e-3), np.log(0.1), size=leaf.shape))
            return (dt0 + np.log(-np.expm1(-dt0))).astype(np.float32)
        if name in ("conv_x_b", "conv_bc_b"):
            return (0.1 * rng.normal(size=leaf.shape)).astype(np.float32)
        return (rng.normal(size=leaf.shape) / np.sqrt(leaf.shape[-2])).astype(np.float32)

    return jax.tree_util.tree_map_with_path(draw, shapes)


def tokens(vocab, n, seed=7):
    return np.random.default_rng(seed).integers(0, vocab, size=(B, n)).astype(np.int32)


def rel(got, want):
    return np.max(np.abs(got - want)) / np.max(np.abs(want))


def reference_decode(module, params, toks, cfg, max_len):
    """The reference's decode over ``toks`` (B, n) one token at a time from
    a zero cache at index 0; each step's logits (n, B, V)."""
    step = jax.jit(lambda p, c, t, i: module.decode_step(p, c, t, i, cfg))
    cache = module.init_cache(cfg, toks.shape[0], max_len)
    out = []
    for i in range(toks.shape[1]):
        logits, cache = step(params, cache, jnp.asarray(toks[:, i:i + 1]), i)
        out.append(np.asarray(logits[:, 0], np.float32))
    return out


def port_decode(port_module, params, toks, cfg, max_len):
    cache = api.init_cache(cfg, toks.shape[0], max_len, device="cpu")
    out = []
    for i in range(toks.shape[1]):
        logits, cache = api.decode_step(params, cache, torch.from_numpy(toks[:, i:i + 1]), i,
                                        cfg)
        assert logits.shape == (toks.shape[0], 1, cfg.vocab_size)
        out.append(logits[:, 0].numpy())
    return out


@functools.lru_cache(maxsize=None)
def _params():
    return draw_params(ref_mamba.SMOKE, RS, 0)


@pytest.mark.parametrize("compute_dtype", ["float32", "bfloat16"])
def test_forward_matches_reference(compute_dtype):
    cfg = dataclasses.replace(ref_mamba.SMOKE, compute_dtype=compute_dtype)
    toks = tokens(cfg.vocab_size, 37)  # three chunks of 16, the last ragged
    want = np.asarray(jax.jit(lambda p, t: RS.forward(p, {"tokens": t}, cfg))(
        _params(), jnp.asarray(toks)), np.float32)
    params = TS.params_from_reference(_params(), "cpu")
    logits, aux = api.forward(params, {"tokens": torch.from_numpy(toks)}, _port(cfg))
    assert logits.shape == want.shape and logits.dtype == torch.float32
    assert float(aux) == 0.0
    assert rel(logits.numpy(), want) < LOGIT_TOL[compute_dtype]


def grad_err(flat_got: dict, want) -> dict:
    """Per leaf (by path): max |port grad - reference grad| over
    max(1, max |reference grad|); ``flat_got`` is keyed by path."""
    flat_want = _leaves(want)
    assert set(flat_got) == set(flat_want)
    out = {}
    for path, ref_grad in flat_want.items():
        ref_grad = np.asarray(ref_grad, np.float32)
        g = flat_got[path]
        assert g is not None and tuple(g.shape) == ref_grad.shape, path
        out[path] = float(np.max(np.abs(g.numpy() - ref_grad)) / max(1.0, np.abs(ref_grad).max()))
    return out


def _leaves(tree, path=""):
    if isinstance(tree, dict):
        return {k: v for key in tree for k, v in _leaves(tree[key], f"{path}/{key}").items()}
    return {path: tree}


def model_vjp(module, port_module, np_params, cfg, toks, seed):
    """The gradient of <logits, ct> with respect to every parameter, for a
    fixed random cotangent ct: ``jax.vjp`` of the reference forward, and
    ``backward`` through the port's forward on the converted parameters.
    Returns the per-leaf errors (``grad_err``)."""
    def ref_logits(p):
        out = module.forward(p, {"tokens": jnp.asarray(toks)}, cfg)
        return out[0] if isinstance(out, tuple) else out

    shape = jax.eval_shape(ref_logits, np_params).shape
    ct = np.random.default_rng(seed).normal(size=shape).astype(np.float32)
    (want,) = jax.jit(lambda p, c: jax.vjp(ref_logits, p)[1](c))(np_params, jnp.asarray(ct))
    params = port_module.params_from_reference(np_params, "cpu")
    for leaf in _leaves(params).values():
        leaf.requires_grad_(True)
    got, _ = api.forward(params, {"tokens": torch.from_numpy(toks)}, _port(cfg))
    got.backward(torch.from_numpy(ct))
    return grad_err({k: t.grad for k, t in _leaves(params).items()}, want)


def test_vjp_matches_reference():
    """H8: the port's Mamba2 LM differentiates (the scan's backward is the
    plain chunked scan's VJP) and its parameter gradients equal the
    reference's, fp32, over a ragged last chunk."""
    cfg = dataclasses.replace(ref_mamba.SMOKE, compute_dtype="float32")
    errs = model_vjp(RS, TS, _params(), cfg, tokens(cfg.vocab_size, 37, seed=11), 12)
    assert max(errs.values()) < GRAD_TOL, errs


def test_decode_steps_match_reference_and_forward():
    """STEPS decode steps from a zero cache against the reference's, fp32;
    the last one also against the port's own forward over those tokens."""
    cfg = dataclasses.replace(ref_mamba.SMOKE, compute_dtype="float32")
    toks = tokens(cfg.vocab_size, STEPS, seed=8)
    want = reference_decode(RS, _params(), toks, cfg, 0)
    params = TS.params_from_reference(_params(), "cpu")
    got = port_decode(TS, params, toks, _port(cfg), 0)
    for t in range(STEPS):
        assert rel(got[t], want[t]) < DECODE_TOL, f"step {t}"
    full, _ = api.forward(params, {"tokens": torch.from_numpy(toks)}, _port(cfg))
    assert rel(got[-1], full[:, -1].numpy()) < DECODE_TOL


def _shapes(tree, path=""):
    if isinstance(tree, dict):
        return {k: v for key in tree for k, v in _shapes(tree[key], f"{path}/{key}").items()}
    return {path: tuple(tree.shape)}


def test_init_shapes_and_statistics():
    cfg = _port(ref_mamba.SMOKE)
    ours = api.init(0, cfg, device="cpu")
    assert _shapes(ours) == _shapes(_params())
    layers = ours["layers"]
    softplus_bias = torch.nn.functional.softplus(layers["dt_bias"])
    assert softplus_bias.min() >= 1e-3 * 0.999 and softplus_bias.max() <= 0.1 * 1.001
    a = torch.exp(layers["A_log"])
    assert a.min() >= 1.0 and a.max() <= 16.0
    assert abs(layers["wx"].std().item() * np.sqrt(cfg.d_model) - 1) < 0.05
    assert not torch.equal(layers["wx"][0], layers["wx"][1])
    assert torch.equal(api.init(0, cfg, device="cpu")["layers"]["wo"], layers["wo"])
    cache = api.init_cache(cfg, 3, 0, device="cpu")
    assert cache["state"].shape == (cfg.num_layers, 3, cfg.ssm_nheads, cfg.ssm_head_dim,
                                    cfg.ssm_state)
    assert cache["state"].dtype == torch.float32
