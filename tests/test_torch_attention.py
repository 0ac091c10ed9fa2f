"""The port's flash_attention and attention cores against the JAX reference:
the kernel's plain version against the Pallas kernel run in interpret mode
(as tests/test_kernels.py runs it), the causal alignment with sq != skv
(ROADMAP H2), the model-layout dispatch, and the naive / chunked /
int8-chunked attention paths with ``q_offset``/``kv_len``. The CUDA kernel
itself is tested on the card by tests/test_torch_cuda.py.

Inputs come from numpy seeds.
"""
import numpy as np
import pytest

torch = pytest.importorskip("torch")
import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

from repro.kernels import ref as jref  # noqa: E402
from repro.kernels.flash_attention import flash_attention as pallas_flash  # noqa: E402
from repro.models import layers as RL  # noqa: E402
from repro.serving import kvcache as RK  # noqa: E402
from repro_torch.config import ModelConfig  # noqa: E402
from repro_torch.kernels import flash_attention as tflash  # noqa: E402
from repro_torch.kernels import ops  # noqa: E402
from repro_torch.kernels.ref import flash_attention_ref  # noqa: E402
from repro_torch.models import layers as TL  # noqa: E402
from repro_torch.serving import kvcache as TK  # noqa: E402

# tests/test_kernels.py's tolerances: the two sum in another order, and in
# bf16 the output is rounded to 8 bits of mantissa
TOL = {"float32": 2e-5, "bfloat16": 2e-2}
CORE_TOL = 1e-5  # fp32 attention cores, same algorithm, another summation order
GRAD_TOL = 1e-4  # fp32 gradients, absolute, inputs N(0, 1)

# tests/test_kernels.py's shapes: (b, h, kv, sq, skv, hd, causal)
SHAPES = [
    (1, 4, 4, 64, 64, 32, True),
    (2, 4, 2, 64, 64, 32, True),
    (1, 8, 1, 128, 128, 64, True),   # MQA
    (2, 4, 1, 96, 160, 32, False),   # cross/unaligned
    (1, 2, 2, 200, 200, 16, True),   # ragged blocks
]
# causal with sq != skv, where top-left and bottom-right alignment differ
CAUSAL_RAGGED = [(1, 4, 2, 96, 160, 32, True), (2, 4, 1, 160, 96, 16, True)]
# the head_dims of hubert-xlarge (80) and zamba2-7b (112), which are not
# powers of two, at ragged lengths
WIDE_HEADS = [(1, 4, 2, 72, 72, 80, True), (1, 2, 1, 40, 100, 112, False)]

# the reference's functions, compiled once per shape (eager dispatch of
# their scans and einsums costs more than the compile)
_naive = jax.jit(RL.naive_attention, static_argnames=("causal",))
_chunked = jax.jit(RL.chunked_attention, static_argnames=("causal", "chunk"))
_chunked_q = jax.jit(RL.chunked_attention_quantized, static_argnames=("chunk",))
_oracle = jax.jit(jref.flash_attention_ref, static_argnames=("causal",))
# RK.cache_update runs eagerly: under jit XLA turns the scale's division by
# 127 into another rounding, and the int8 parity below is bitwise


def _qkv(b, h, kv, sq, skv, hd, seed=0):
    rng = np.random.default_rng(seed)
    return (rng.normal(size=(b, h, sq, hd)).astype(np.float32),
            rng.normal(size=(b, kv, skv, hd)).astype(np.float32),
            rng.normal(size=(b, kv, skv, hd)).astype(np.float32))


def _pallas(q, k, v, causal, dtype):
    jd = jnp.dtype(dtype)
    out = pallas_flash(jnp.asarray(q, jd), jnp.asarray(k, jd), jnp.asarray(v, jd),
                       causal=causal, block_q=64, block_k=64, interpret=True)
    return np.asarray(out, np.float32)


def _plain(q, k, v, causal, dtype):
    td = getattr(torch, dtype)
    out = flash_attention_ref(torch.from_numpy(q).to(td), torch.from_numpy(k).to(td),
                              torch.from_numpy(v).to(td), causal=causal)
    assert out.dtype == td
    return out.float().numpy()


@pytest.mark.parametrize("shape,dtype",
                         [(s, d) for s in SHAPES + WIDE_HEADS for d in ("float32", "bfloat16")]
                         + [(s, "float32") for s in CAUSAL_RAGGED])
def test_plain_version_matches_pallas_kernel(shape, dtype):
    q, k, v = _qkv(*shape[:6])
    causal = shape[6]
    err = np.max(np.abs(_plain(q, k, v, causal, dtype) - _pallas(q, k, v, causal, dtype)))
    assert err < TOL[dtype]


@pytest.mark.parametrize("shape", CAUSAL_RAGGED)
def test_causal_alignment_is_top_left_as_the_model_path(shape):
    """ROADMAP H2: the Pallas kernel, the model's attention and the port
    align the causal mask top-left (k_pos <= q_pos); repro's jnp oracle
    aligns it bottom-right, which is another function when sq != skv."""
    b, h, kv, sq, skv, hd, _ = shape
    q, k, v = _qkv(b, h, kv, sq, skv, hd, seed=1)
    ours = _plain(q, k, v, True, "float32")
    # the model path, in its (B, S, H, hd) layout
    t = (0, 2, 1, 3)
    model = np.asarray(_naive(jnp.asarray(q.transpose(t)), jnp.asarray(k.transpose(t)),
                                          jnp.asarray(v.transpose(t)), causal=True)).transpose(t)
    assert np.max(np.abs(ours - model)) < TOL["float32"]
    oracle = np.asarray(_oracle(jnp.asarray(q), jnp.asarray(k), jnp.asarray(v), causal=True))
    assert np.max(np.abs(ours - oracle)) > 1e-2


@pytest.mark.parametrize("causal", [True, False])
def test_ops_flash_attention_takes_the_model_layout(causal):
    q, k, v = _qkv(2, 4, 2, 40, 40, 16, seed=2)
    t = (0, 2, 1, 3)
    before = tflash.LAUNCHES
    got = ops.flash_attention(torch.from_numpy(q.transpose(t)), torch.from_numpy(k.transpose(t)),
                              torch.from_numpy(v.transpose(t)), causal=causal)
    assert tflash.LAUNCHES == before  # CPU tensors take the plain version
    assert got.shape == (2, 40, 4, 16)
    want = _plain(q, k, v, causal, "float32").transpose(t)
    assert np.array_equal(got.numpy(), want)


def test_kernel_refuses_cpu_tensors():
    q, k, v = (torch.from_numpy(a) for a in _qkv(1, 2, 1, 8, 8, 16))
    with pytest.raises(ValueError, match="CUDA"):
        tflash.launch(q, k, v, causal=True)


# (b, h, kv, s, t, hd, causal) in the model's layout: self-attention, GQA with
# a ragged tile, causal with sq != skv both ways (top-left, as the model), and
# cross-attention
GRAD_SHAPES = [(2, 4, 2, 40, 40, 16, True), (1, 4, 1, 24, 40, 32, True),
               (1, 2, 2, 40, 24, 16, True), (2, 4, 2, 24, 40, 16, False)]
_naive_vjp = jax.jit(lambda q, k, v, do, causal: jax.vjp(
    lambda q, k, v: RL.naive_attention(q, k, v, causal=causal), q, k, v)[1](do),
    static_argnames=("causal",))


def attention_grad_err(b, h, kv, s, t, hd, causal):
    """max |port grad - jax.vjp grad| over q, k and v of
    ``ops.flash_attention`` against the reference model's attention, fp32."""
    rng = np.random.default_rng(b + s + t)
    q, k, v, do = (rng.normal(size=shape).astype(np.float32)
                   for shape in ((b, s, h, hd), (b, t, kv, hd), (b, t, kv, hd), (b, s, h, hd)))
    want = _naive_vjp(*map(jnp.asarray, (q, k, v, do)), causal=causal)
    leaves = [torch.from_numpy(a).requires_grad_(True) for a in (q, k, v)]
    before = tflash.LAUNCHES
    ops.flash_attention(*leaves, causal=causal).backward(torch.from_numpy(do))
    assert tflash.LAUNCHES == before
    err = 0.0
    for got, ref in zip(leaves, want):
        assert got.grad.shape == ref.shape
        err = max(err, float(np.max(np.abs(got.grad.numpy() - np.asarray(ref)))))
    return err


@pytest.mark.parametrize("b,h,kv,s,t,hd,causal", GRAD_SHAPES)
def test_gradient_matches_jax_grad(b, h, kv, s, t, hd, causal):
    """``ops.flash_attention``'s backward (the plain version's VJP,
    recomputed) against ``jax.vjp`` of the reference model's attention on
    the same inputs and cotangent, fp32; no kernel launch on the CPU."""
    assert attention_grad_err(b, h, kv, s, t, hd, causal) < GRAD_TOL


def _model_layout(seed, b=2, s=5, t=40, h=4, kv=2, hd=16):
    rng = np.random.default_rng(seed)
    return (rng.normal(size=(b, s, h, hd)).astype(np.float32),
            rng.normal(size=(b, t, kv, hd)).astype(np.float32),
            rng.normal(size=(b, t, kv, hd)).astype(np.float32))


@pytest.mark.parametrize("impl", ["naive", "chunked"])
@pytest.mark.parametrize("q_offset,kv_len,causal", [(0, None, True), (0, None, False),
                                                     (30, 35, True), (17, 18, True)])
def test_attention_cores_match_reference(impl, q_offset, kv_len, causal):
    q, k, v = _model_layout(3)
    if impl == "naive":
        want = _naive(jnp.asarray(q), jnp.asarray(k), jnp.asarray(v), causal=causal,
                      q_offset=q_offset, kv_len=kv_len)
        got = TL.naive_attention(torch.from_numpy(q), torch.from_numpy(k), torch.from_numpy(v),
                                 causal=causal, q_offset=q_offset, kv_len=kv_len)
    else:  # chunk 16 of 40 rows: two full chunks and a padded tail
        want = _chunked(jnp.asarray(q), jnp.asarray(k), jnp.asarray(v), causal=causal,
                        chunk=16, q_offset=q_offset, kv_len=kv_len)
        got = TL.chunked_attention(torch.from_numpy(q), torch.from_numpy(k), torch.from_numpy(v),
                                   causal=causal, chunk=16, q_offset=q_offset, kv_len=kv_len)
    assert np.max(np.abs(got.numpy() - np.asarray(want))) < CORE_TOL


def test_attention_core_sends_an_offset_to_the_chunked_path():
    """The kernel takes no q_offset: flash_pallas runs it only for a
    prefill that starts at position 0."""
    q, k, v = (torch.from_numpy(a) for a in _model_layout(6))
    cfg = ModelConfig(attn_impl="flash_pallas", attn_chunk=16)
    got = TL.attention_core(q, k, v, cfg, causal=True, q_offset=30)
    assert torch.equal(got, TL.chunked_attention(q, k, v, causal=True, chunk=16, q_offset=30))
    prefill = TL.attention_core(q, k, v, cfg, causal=True)
    assert torch.equal(prefill, ops.flash_attention(q, k, v, causal=True))


@pytest.mark.parametrize("q_offset,kv_len", [(30, 35), (39, 40)])
def test_quantized_cache_and_lazy_attention_match_reference(q_offset, kv_len):
    q, k, v = _model_layout(4)
    rcache = RK.cache_update(RK.init_cache(2, 2, 40, 16, "int8"), jnp.asarray(k), jnp.asarray(v), 0)
    tcache = TK.cache_update(TK.init_cache(2, 2, 40, 16, "int8", device="cpu"),
                             torch.from_numpy(k), torch.from_numpy(v), 0)
    for name in ("k", "v", "k_scale", "v_scale"):  # round half to even in both
        assert np.array_equal(tcache[name].numpy(), np.asarray(rcache[name])), name
    want = _chunked_q(jnp.asarray(q), rcache, chunk=8, q_offset=q_offset, kv_len=kv_len)
    got = TL.chunked_attention_quantized(torch.from_numpy(q), tcache, chunk=8,
                                         q_offset=q_offset, kv_len=kv_len)
    assert np.max(np.abs(got.numpy() - np.asarray(want))) < CORE_TOL
    rk, rv = RK.cache_kv(rcache)
    tk, tv = TK.cache_kv(tcache)
    assert np.array_equal(tk.float().numpy(), np.asarray(rk, np.float32))
    assert np.array_equal(tv.float().numpy(), np.asarray(rv, np.float32))


def test_cache_update_writes_in_place_and_refuses_overflow():
    _, k, v = _model_layout(5, t=3)
    cache = TK.init_cache(2, 2, 8, 16, "bfloat16", device="cpu")
    store = cache["k"]
    out = TK.cache_update(cache, torch.from_numpy(k), torch.from_numpy(v), 4)
    assert out["k"] is store
    want = RK.cache_update(RK.init_cache(2, 2, 8, 16), jnp.asarray(k), jnp.asarray(v), 4)
    assert np.array_equal(store.float().numpy(), np.asarray(want["k"], np.float32))
    with pytest.raises(ValueError, match="cannot write"):
        TK.cache_update(cache, torch.from_numpy(k), torch.from_numpy(v), 6)
