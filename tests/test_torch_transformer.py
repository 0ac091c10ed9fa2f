"""The port's dense transformer against the JAX reference on the same
parameters: forward logits (``flash_pallas`` and ``chunked``, fp32 and bf16
compute), the ``return_cache`` cache, and per-step decode over bf16, int8
and int8 + ``lazy_kv_dequant`` caches, the vlm and audio inputs; then the
port's own init, the serving steps and what is not ported yet.

Configs: ``qwen3_1_7b.SMOKE`` and the ``dense``/``gqa1`` configs of
tests/test_models.py (qk-norm; MQA with tied, scaled embeddings and GeGLU).
Parameters and tokens come from numpy seeds and go to both. On the CPU the
reference's ``flash_pallas`` falls through to its chunked path while the
port takes the flash_attention kernel's plain version: the same function,
summed in another order. Each reference function is compiled once per
config and reused by every test of this file.
"""
import dataclasses
import functools

import numpy as np
import pytest

torch = pytest.importorskip("torch")
import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

from repro.config import ModelConfig as RefModelConfig  # noqa: E402
from repro.configs import hubert_xlarge as ref_hubert  # noqa: E402
from repro.configs import pixtral_12b as ref_pixtral  # noqa: E402
from repro.configs import qwen3_1_7b as ref_qwen3  # noqa: E402
from repro.models import transformer as RT  # noqa: E402
from repro.serving import kvcache as RK  # noqa: E402
from repro_torch import configs as port_configs  # noqa: E402
from repro_torch.config import ModelConfig  # noqa: E402
from repro_torch.kernels import flash_attention as tflash  # noqa: E402
from repro_torch.models import api, transformer as TT  # noqa: E402
from repro_torch.serving import kvcache as TK  # noqa: E402
from repro_torch.train import steps  # noqa: E402

# relative to max |reference logit|: fp32 sums in another order; bf16
# compute rounds at other places in the two frameworks (XLA may also keep
# excess precision between ops), about 1e-2 apart at these sizes
LOGIT_TOL = {"float32": 1e-4, "bfloat16": 2e-2}
# the return_cache k/v, relative to their max |value|; they are stored in
# bf16, so one rounding that falls the other way costs a bf16 step
CACHE_TOL = {"float32": 1e-2, "bfloat16": 2e-2}
# decode in fp32 compute, relative to max |logit|: the cache holds bf16 (and
# every cache is read back as bf16), so an fp32 difference of 1e-7 can round
# one cached element the other way, which moves a logit by up to ~1e-3 of
# the largest one; otherwise the two agree to ~1e-6
DECODE_TOL = 2e-3

CFGS = {
    "qwen3_smoke": ref_qwen3.SMOKE,
    "dense": RefModelConfig(name="t-dense", family="dense", num_layers=2, d_model=64,
                            num_heads=4, num_kv_heads=2, d_ff=128, vocab_size=97,
                            use_qk_norm=True),
    "gqa1": RefModelConfig(name="t-gqa1", family="dense", num_layers=2, d_model=64,
                           num_heads=4, num_kv_heads=1, head_dim=32, d_ff=128, vocab_size=97,
                           act="gelu", tie_embeddings=True, embed_scale=True),
}
B, P, MAX, STEPS = 2, 16, 32, 6  # batch, prompt, cache length, decode steps


def _port(cfg, **kw) -> ModelConfig:
    return ModelConfig(**dataclasses.asdict(dataclasses.replace(cfg, **kw)))


def _cfg(name, compute_dtype="float32"):
    return dataclasses.replace(CFGS[name], compute_dtype=compute_dtype)


def _draw_params(cfg, seed):
    """Numpy parameters in the reference's tree: unit-fan-in normals for
    the weights, 1 + 0.1·normal for the norm scales."""
    rng = np.random.default_rng(seed)
    shapes = jax.eval_shape(lambda: RT.init(jax.random.PRNGKey(0), cfg))

    def draw(path, leaf):
        if path[-1].key == "scale":
            return (1.0 + 0.1 * rng.normal(size=leaf.shape)).astype(np.float32)
        return (rng.normal(size=leaf.shape) / np.sqrt(leaf.shape[-2])).astype(np.float32)

    return jax.tree_util.tree_map_with_path(draw, shapes)


@functools.lru_cache(maxsize=None)
def _params(name):
    return _draw_params(CFGS[name], sorted(CFGS).index(name))


def _tokens(name, n):
    """The first n of P + STEPS + 1 tokens per sequence (one numpy draw)."""
    toks = np.random.default_rng(7).integers(0, CFGS[name].vocab_size, size=(B, P + STEPS + 1))
    return toks[:, :n].astype(np.int32)


@functools.lru_cache(maxsize=None)
def _reference_forward(name, compute_dtype):
    """The reference's (logits, return_cache cache) over the P-token
    prompt, as numpy."""
    cfg = _cfg(name, compute_dtype)
    fwd = jax.jit(lambda p, t: RT.forward(p, {"tokens": t}, cfg, return_cache=True))
    logits, cache = fwd(_params(name), jnp.asarray(_tokens(name, P)))
    return np.asarray(logits, np.float32), {n: np.asarray(c, np.float32) for n, c in cache.items()}


@functools.partial(jax.jit, static_argnums=(4, 5))
def _reference_decode(params, pre_k, pre_v, toks, cfg, kv_dtype):
    """The reference's prefill cache (L, B, KV, P, hd) written into a
    preallocated cache with its cache_update, then one decode step per
    column of ``toks`` (teacher-forced); the steps' logits (STEPS, B, V)."""
    cache = jax.vmap(lambda c, k, v: RK.cache_update(c, k, v, 0))(
        RT.init_cache(cfg, B, MAX, kv_dtype), pre_k.transpose(0, 1, 3, 2, 4),
        pre_v.transpose(0, 1, 3, 2, 4))

    def body(cache, xs):
        t, tok = xs
        logits, cache = RT.decode_step(params, cache, tok[:, None], P + t, cfg)
        return cache, logits[:, 0]

    _, logits = jax.lax.scan(body, cache, (jnp.arange(toks.shape[1]), toks.T))
    return logits


def _rel(got, want):
    return np.max(np.abs(got - want)) / np.max(np.abs(want))


@pytest.mark.parametrize("impl", ["flash_pallas", "chunked"])
@pytest.mark.parametrize("compute_dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("name", sorted(CFGS))
def test_forward_and_cache_match_reference(name, compute_dtype, impl):
    want_logits, want_cache = _reference_forward(name, compute_dtype)
    cfg = _port(_cfg(name, compute_dtype), attn_impl=impl)
    params = TT.params_from_reference(_params(name), "cpu")
    before = tflash.LAUNCHES
    logits, cache = TT.forward(params, {"tokens": torch.from_numpy(_tokens(name, P))}, cfg,
                               return_cache=True)
    assert tflash.LAUNCHES == before  # the plain version on the CPU
    assert logits.shape == (B, P, cfg.vocab_size) and logits.dtype == torch.float32
    assert _rel(logits.numpy(), want_logits) < LOGIT_TOL[compute_dtype]
    for n in ("k", "v"):
        assert cache[n].dtype == torch.bfloat16
        assert cache[n].shape == (cfg.num_layers, B, cfg.num_kv_heads, P, cfg.resolved_head_dim)
        assert _rel(cache[n].float().numpy(), want_cache[n]) < CACHE_TOL[compute_dtype]


KINDS = {"bf16": ("bfloat16", False), "int8": ("int8", False), "int8_lazy": ("int8", True)}


@pytest.mark.parametrize("kind", sorted(KINDS))
@pytest.mark.parametrize("name", sorted(CFGS))
def test_decode_steps_match_reference(name, kind):
    """Prefill P tokens into a preallocated cache, then decode STEPS tokens
    (teacher-forced) and compare every step's logits; fp32 compute."""
    kv_dtype, lazy = KINDS[kind]
    cfg = dataclasses.replace(_cfg(name), lazy_kv_dequant=lazy)
    toks = _tokens(name, P + STEPS)
    np_params = _params(name)

    _, pre = _reference_forward(name, "float32")
    want = np.asarray(_reference_decode(
        np_params, jnp.asarray(pre["k"], jnp.bfloat16), jnp.asarray(pre["v"], jnp.bfloat16),
        jnp.asarray(toks[:, P:]), cfg, kv_dtype))

    tcfg = _port(cfg)
    params = TT.params_from_reference(np_params, "cpu")
    _, tpre = TT.forward(params, {"tokens": torch.from_numpy(toks[:, :P])}, tcfg,
                         return_cache=True)
    tcache = TK.cache_update(api.init_cache(tcfg, B, MAX, kv_dtype, device="cpu"),
                             tpre["k"].transpose(-3, -2), tpre["v"].transpose(-3, -2), 0)
    for t in range(STEPS):
        tok = torch.from_numpy(toks[:, P + t:P + t + 1])
        got, tcache = api.decode_step(params, tcache, tok, P + t, tcfg)
        assert got.shape == (B, 1, tcfg.vocab_size)
        assert _rel(got[:, 0].numpy(), want[t]) < DECODE_TOL, f"step {t}"


FRONTENDS = {"pixtral_smoke": ref_pixtral.SMOKE, "hubert_smoke": ref_hubert.SMOKE}


@pytest.mark.parametrize("name", sorted(FRONTENDS))
def test_frontend_families_match_reference(name):
    """The vlm input (patches through the connector, then the tokens) and
    the audio input (frames through in_proj, non-causal attention) on the
    flash_pallas path; fp32 compute."""
    cfg = dataclasses.replace(FRONTENDS[name], compute_dtype="float32")
    np_params = _draw_params(cfg, 10 + sorted(FRONTENDS).index(name))
    rng = np.random.default_rng(8)
    if cfg.frontend == "vision_patches":
        batch = {"patches": rng.normal(size=(B, cfg.num_patches, cfg.frontend_dim)),
                 "tokens": rng.integers(0, cfg.vocab_size, size=(B, P))}
    else:
        batch = {"frames": rng.normal(size=(B, P, cfg.frontend_dim))}
    batch = {n: a.astype(np.float32 if a.dtype.kind == "f" else np.int32)
             for n, a in batch.items()}
    want = np.asarray(jax.jit(lambda p, b: RT.forward(p, b, cfg))(np_params, batch))
    got = TT.forward(TT.params_from_reference(np_params, "cpu"),
                     {n: torch.from_numpy(a) for n, a in batch.items()},
                     _port(cfg, attn_impl="flash_pallas"))
    assert got.shape == want.shape
    assert _rel(got.numpy(), want) < LOGIT_TOL["float32"]


def test_first_decode_step_matches_forward_on_the_kernel_path():
    """Prefill on the flash_attention path, decode one token on the chunked
    path, and hold that step's logits against a forward over the prompt plus
    the token (a ragged prefill of P + 1): the port against itself, fp32.
    Decode reads k/v rounded to bf16 by the cache where the forward keeps
    fp32, hence the bf16 tolerance."""
    cfg = _port(_cfg("qwen3_smoke"), attn_impl="flash_pallas")
    params = TT.params_from_reference(_params("qwen3_smoke"), "cpu")
    run = port_configs.make_run("qwen3_1_7b", "decode_32k").replace(model=cfg)
    prefill, _, _ = steps.make_prefill_step(run)
    decode, _, _, _ = steps.make_decode_step(run)
    toks = torch.from_numpy(_tokens("qwen3_smoke", P + 1))
    _, pre = TT.forward(params, {"tokens": toks[:, :P]}, cfg, return_cache=True)
    cache = TK.cache_update(api.init_cache(cfg, B, MAX, device="cpu"),
                            pre["k"].transpose(-3, -2), pre["v"].transpose(-3, -2), 0)
    next_tok, logits, _ = decode(params, cache, toks[:, P:], P)
    full = prefill(params, {"tokens": toks})
    assert _rel(logits[:, 0].numpy(), full[:, P].numpy()) < LOGIT_TOL["bfloat16"]
    assert next_tok.dtype == torch.int32 and next_tok.shape == (B, 1)
    assert torch.equal(next_tok[:, 0], full[:, P].argmax(-1).to(torch.int32))


def _shapes(tree, path=""):
    if isinstance(tree, dict):
        return {k: v for key in tree for k, v in _shapes(tree[key], f"{path}/{key}").items()}
    return {path: tuple(tree.shape)}


@pytest.mark.parametrize("name", ["qwen3_smoke", "gqa1"])
def test_init_shapes_and_statistics(name):
    cfg = _port(CFGS[name])
    ours = api.init(0, cfg, device="cpu")
    assert _shapes(ours) == _shapes(_params(name))
    layers = ours["layers"]
    d = cfg.d_model
    for w, fan_in in ((layers["attn"]["wq"], d), (layers["mlp"]["wo"], cfg.d_ff),
                      (layers["attn"]["wo"], cfg.num_heads * cfg.resolved_head_dim)):
        assert abs(w.std().item() * np.sqrt(fan_in) - 1) < 0.05
    # every layer of the stack is drawn anew
    assert not torch.equal(layers["attn"]["wq"][0], layers["attn"]["wq"][1])
    assert abs(ours["embed"]["embedding"].std().item() / 0.02 - 1) < 0.05
    assert torch.equal(layers["attn_norm"]["scale"], torch.ones(cfg.num_layers, d))
    again = api.init(0, cfg, device="cpu")
    assert torch.equal(again["layers"]["mlp"]["wi_up"], layers["mlp"]["wi_up"])
    assert not torch.equal(api.init(1, cfg, device="cpu")["embed"]["embedding"],
                           ours["embed"]["embedding"])


@pytest.mark.parametrize("family", ["moe", "ssm", "hybrid"])
def test_later_families_raise(family):
    """The moe, ssm and hybrid families are served and trained now (their
    parity tests are tests/test_torch_{moe,ssm,hybrid,train}.py); what they
    still raise, as the dense family does, is a sharded (pc) forward, which
    comes with the parallel slice. A remat forward gives the plain one's
    logits."""
    arch = {"moe": "qwen2_moe_a2_7b", "ssm": "mamba2_370m", "hybrid": "zamba2_7b"}[family]
    cfg = port_configs.smoke(arch)
    params = api.init(0, cfg, device="cpu")
    batch = {"tokens": torch.zeros((1, 4), dtype=torch.long)}
    logits, aux = api.forward(params, batch, cfg)
    assert logits.shape == (1, 4, cfg.vocab_size) and aux.shape == ()
    with pytest.raises(NotImplementedError, match="parallel slice"):
        api.forward(params, batch, cfg, pc=object())
    assert torch.equal(api.forward(params, batch, cfg, remat="full")[0], logits)


def test_sharded_and_remat_paths_raise():
    cfg = _port(CFGS["dense"])
    params = TT.params_from_reference(_params("dense"), "cpu")
    batch = {"tokens": torch.from_numpy(_tokens("dense", 4))}
    for remat in ("full", "dots"):  # remat runs since the training slice
        assert torch.equal(TT.forward(params, batch, cfg, remat=remat),
                           TT.forward(params, batch, cfg))
    with pytest.raises(NotImplementedError, match="parallel slice"):
        TT.forward(params, batch, cfg, pc=object())
    with pytest.raises(NotImplementedError, match="parallel slice"):
        steps.make_decode_step(port_configs.make_run("qwen3_1_7b", "decode_32k"), pc=object())
