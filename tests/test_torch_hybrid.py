"""The port's Zamba2-style hybrid (Mamba2 groups with one shared attention
block, and a tail) against the JAX reference on the CPU, on the same
parameters: forward logits in fp32 and bf16 compute, and under
``attn_impl="flash_pallas"``, and decode steps from a zero cache.

Config: ``zamba2_7b.SMOKE`` (5 Mamba2 layers: 2 groups of 2, each followed
by the shared block, and a tail of 1). Parameters and tokens come from
numpy seeds and go to both.
"""
import dataclasses
import functools

import numpy as np
import pytest

torch = pytest.importorskip("torch")
import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

from repro.configs import zamba2_7b as ref_zamba  # noqa: E402
from repro.models import hybrid as RH  # noqa: E402
from repro_torch.kernels import flash_attention as tflash  # noqa: E402
from repro_torch.kernels import ops as kops  # noqa: E402
from repro_torch.kernels import ssd_scan as tssd  # noqa: E402
from repro_torch.models import api, hybrid as TH  # noqa: E402
from test_torch_ssm import (DECODE_TOL, GRAD_TOL, LOGIT_TOL, _port, _shapes,  # noqa: E402
                            draw_params, model_vjp, port_decode, reference_decode, rel,
                            tokens)

CFG = ref_zamba.SMOKE
STEPS, MAX = 6, 16


@functools.lru_cache(maxsize=None)
def _params():
    return draw_params(CFG, RH, 6)


@pytest.mark.parametrize("compute_dtype", ["float32", "bfloat16"])
def test_forward_matches_reference(compute_dtype):
    cfg = dataclasses.replace(CFG, compute_dtype=compute_dtype)
    toks = tokens(cfg.vocab_size, 37, seed=9)  # three chunks of 16, the last ragged
    want = np.asarray(jax.jit(lambda p, t: RH.forward(p, {"tokens": t}, cfg))(
        _params(), jnp.asarray(toks)), np.float32)
    params = TH.params_from_reference(_params(), "cpu")
    before = tssd.LAUNCHES
    logits, aux = api.forward(params, {"tokens": torch.from_numpy(toks)}, _port(cfg))
    assert tssd.LAUNCHES == before  # the plain version on the CPU
    assert logits.shape == want.shape and float(aux) == 0.0
    assert rel(logits.numpy(), want) < LOGIT_TOL[compute_dtype]


def test_forward_under_flash_pallas_matches_reference(monkeypatch):
    """The shared block's attention through ``ops.flash_attention`` (zamba2-7b
    runs head_dim 112, which the kernel takes), once per application, the
    plain version on the CPU; the reference's CPU path runs its chunked
    attention, the same function."""
    cfg = dataclasses.replace(CFG, compute_dtype="float32", attn_impl="flash_pallas")
    toks = tokens(cfg.vocab_size, 37, seed=9)
    want = np.asarray(jax.jit(lambda p, t: RH.forward(p, {"tokens": t}, cfg))(
        _params(), jnp.asarray(toks)), np.float32)
    calls = []
    flash = kops.flash_attention
    monkeypatch.setattr(kops, "flash_attention",
                        lambda *a, **kw: calls.append(1) or flash(*a, **kw))
    params = TH.params_from_reference(_params(), "cpu")
    before = tflash.LAUNCHES
    logits, _ = api.forward(params, {"tokens": torch.from_numpy(toks)}, _port(cfg))
    assert tflash.LAUNCHES == before  # the plain version on the CPU
    assert len(calls) == TH._plan(cfg)[0]  # once per shared-block application
    assert rel(logits.numpy(), want) < LOGIT_TOL["float32"]


def test_vjp_matches_reference():
    """H8: the port's hybrid differentiates under ``flash_pallas``, its
    Mamba2 layers' scans and its shared block's attention (the plain
    versions' VJPs on the CPU, where the reference takes its chunked
    attention), and its parameter gradients, the shared block's summed over
    its applications, equal the reference's, fp32."""
    cfg = dataclasses.replace(CFG, compute_dtype="float32", attn_impl="flash_pallas")
    errs = model_vjp(RH, TH, _params(), cfg, tokens(cfg.vocab_size, 37, seed=15), 16)
    assert max(errs.values()) < GRAD_TOL, errs


def test_decode_steps_match_reference_and_forward():
    """STEPS decode steps from a zero cache (SSM states and the shared
    block's bf16 kv caches) against the reference's, fp32 compute; the last
    one also against the port's own forward over those tokens, which keeps
    k/v in fp32 where decode reads them back from the bf16 cache, hence a
    bf16 tolerance there."""
    cfg = dataclasses.replace(CFG, compute_dtype="float32")
    toks = tokens(cfg.vocab_size, STEPS, seed=10)
    want = reference_decode(RH, _params(), toks, cfg, MAX)
    params = TH.params_from_reference(_params(), "cpu")
    got = port_decode(TH, params, toks, _port(cfg), MAX)
    for t in range(STEPS):
        assert rel(got[t], want[t]) < DECODE_TOL, f"step {t}"
    full, _ = api.forward(params, {"tokens": torch.from_numpy(toks)}, _port(cfg))
    assert rel(got[-1], full[:, -1].numpy()) < 2e-2


def test_init_and_cache_shapes_match_reference():
    cfg = _port(CFG)
    ours = api.init(0, cfg, device="cpu")
    assert _shapes(ours) == _shapes(_params())
    assert set(ours) == {"embed", "groups", "shared", "final_norm", "tail"}
    n_groups, per, tail = TH._plan(cfg)
    assert (n_groups, per, tail) == RH._plan(CFG) == (2, 2, 1)
    want = jax.eval_shape(lambda: RH.init_cache(CFG, 3, MAX))
    got = api.init_cache(cfg, 3, MAX, device="cpu")
    assert _shapes(got) == _shapes(want)
    assert not torch.equal(ours["groups"]["wx"][0, 0], ours["groups"]["wx"][1, 1])
