"""The port's training substrate against the JAX reference on the CPU: the
LM stream, the losses, the four optimizers and the schedule, the training
step of every family (plain, microbatched and with ``cast_params_once``),
remat, checkpointing (each implementation's checkpoints restore into the
other's state), the loop (resume after an injected failure, the straggler
watchdog) and the launcher. Inputs come from numpy seeds and go to both;
each test states its tolerance. The same step on the card is in
tests/test_torch_cuda.py and chip_smoke.py's train phase.
"""
import dataclasses
import json
import math
import os
import time
from unittest import mock

import numpy as np
import pytest

torch = pytest.importorskip("torch")
import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

from repro import configs as rconfigs  # noqa: E402
from repro import config as rconfig  # noqa: E402
from repro.common import tree_paths as ref_tree_paths  # noqa: E402
from repro.data import synthetic as rsyn  # noqa: E402
from repro.models import api as rapi  # noqa: E402
from repro.train import checkpoint as rckpt  # noqa: E402
from repro.train import optim as roptim  # noqa: E402
from repro.train.steps import make_train_step as ref_make_train_step  # noqa: E402
from repro_torch import config as tconfig  # noqa: E402
from repro_torch.common import global_norm, tree_from_numpy, tree_map, tree_paths  # noqa: E402
from repro_torch.data import synthetic as tsyn  # noqa: E402
from repro_torch.launch import train as tlaunch  # noqa: E402
from repro_torch.models import api as tapi  # noqa: E402
from repro_torch.train import checkpoint as tckpt  # noqa: E402
from repro_torch.train import optim as toptim  # noqa: E402
from repro_torch.train import steps as tsteps  # noqa: E402
from repro_torch.train.loop import LoopConfig, run_training  # noqa: E402
from test_torch_ssm import draw_params  # noqa: E402

# fp32: the same arithmetic in another order (XLA fuses, torch does not)
OPT_TOL = 1e-5  # per leaf / max(1, max |leaf|), 3 optimizer steps on the same grads
CE_TOL = 1e-5  # relative
# the training step, fp32: loss relative; each gradient leaf, and mu and nu,
# per leaf / that leaf's max
STEP_TOL = 1e-4
# cast_params_once in bf16: every product rounds to 8 bits of mantissa, at
# other places in the two frameworks. The loss and the gradient norm,
# relative:
BF16_TOL = 2e-2
# and the first step's gradients, mu and nu per leaf / that leaf's max, port
# bf16 against reference bf16: read at 2.5e-2 (dense) to 0.12 (moe, whose
# top-k flips) for the gradients, up to 0.187 for nu (moe's router,
# hybrid's conv bias). A planted fault, the clip lost on the bf16
# gradients, must fail it (_unclipped)
BF16_LEAF_TOL = 0.3
REMAT_TOL = 1e-6  # remat recomputes the same ops: gradients per leaf / max
ARCHS = {"dense": "qwen3_1_7b", "vlm": "pixtral_12b", "audio": "hubert_xlarge",
         "ssm": "mamba2_370m", "moe": "qwen2_moe_a2_7b", "hybrid": "zamba2_7b"}
B, S = 4, 32
TRAIN = dict(total_steps=50, warmup_steps=2, learning_rate=1e-3)


def _configs(family, **kw):
    rcfg = rconfigs.smoke(ARCHS[family]).scaled(**kw)
    return rcfg, tconfig.ModelConfig(**dataclasses.asdict(rcfg))


def _runs(rcfg, tcfg, **train):
    shape = dict(name="t", seq_len=S, global_batch=B, mode="train")
    train = dict(TRAIN, **train)
    return (rconfig.RunConfig(model=rcfg, shape=rconfig.ShapeConfig(**shape),
                              train=rconfig.TrainConfig(**train)),
            tconfig.RunConfig(model=tcfg, shape=tconfig.ShapeConfig(**shape),
                              train=tconfig.TrainConfig(**train)))


def _params(rcfg, seed: int = 0):
    """Parameters drawn with numpy in the reference's tree (as its init
    draws them, without compiling it): the reference's and the port's."""
    np_params = draw_params(rcfg, rapi.module_for(rcfg), seed)
    return jax.tree.map(jnp.asarray, np_params), tree_from_numpy(np_params, "cpu")


def _named_ref(tree) -> dict:
    return {p: np.asarray(leaf, np.float32) for p, leaf in ref_tree_paths(tree)}


def _named_port(tree) -> dict:
    return {p: leaf.detach().float().numpy() for p, leaf in tree_paths(tree)}


def _leaf_errs(got: dict, want: dict, floor: float = 1.0) -> dict:
    """Per leaf max |got - want| / max(floor, max |want|); a leaf that is 0
    in ``want`` (floor 0) must be 0 in ``got``."""
    assert got.keys() == want.keys()
    out = {}
    for k, w in want.items():
        err = float(np.max(np.abs(got[k] - w), initial=0.0))
        scale = max(floor, float(np.max(np.abs(w), initial=0.0)))
        out[k] = err / scale if scale > 0 else err
    return out


def _batch(cfg, step: int, seed: int = 0) -> dict:
    """Numpy inputs of one training batch: the LM stream for the token
    families; numpy draws for the vlm's patches and the audio frames (their
    labels with some -1, ignored)."""
    rng = np.random.default_rng([seed, step])
    if cfg.family == "audio":
        labels = rng.integers(-1, cfg.vocab_size, size=(B, S)).astype(np.int32)
        frames = rng.normal(size=(B, S, cfg.frontend_dim)).astype(np.float32)
        return {"frames": frames, "labels": labels}
    if cfg.family == "vlm":
        p = cfg.num_patches
        text = tsyn.LMStream(cfg.vocab_size, S - p, B, seed=seed).batch_at(step)
        patches = rng.normal(size=(B, p, cfg.frontend_dim)).astype(np.float32)
        labels = np.concatenate([np.full((B, p), -1, np.int32), text["labels"]], axis=1)
        return {"patches": patches, "tokens": text["tokens"], "labels": labels}
    return tsyn.LMStream(cfg.vocab_size, S, B, seed=seed).batch_at(step)


# ---------------------------------------------------------------------------
# Data
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("host", [0, 1])
def test_lm_stream_batches_are_bitwise_the_reference(host):
    ours = tsyn.LMStream(1000, 48, 3, seed=5, host=host)
    ref = rsyn.LMStream(1000, 48, 3, seed=5, host=host)
    shape = dict(name="t", seq_len=48, global_batch=6, mode="train")
    cfg = rconfigs.smoke("qwen3_1_7b")
    ours_for = tsyn.stream_for(tconfig.ModelConfig(**dataclasses.asdict(cfg)),
                               tconfig.ShapeConfig(**shape), seed=5, host=host,
                               per_host_batch=3)
    ref_for = rsyn.stream_for(cfg, rconfig.ShapeConfig(**shape), seed=5, host=host,
                              per_host_batch=3)
    for step in range(3):
        for got, want in ((ours.batch_at(step), ref.batch_at(step)),
                          (ours_for.batch_at(step), ref_for.batch_at(step))):
            for key in ("tokens", "labels"):
                assert got[key].dtype == want[key].dtype
                np.testing.assert_array_equal(got[key], want[key])
    assert not np.array_equal(ours.batch_at(0)["tokens"],
                              tsyn.LMStream(1000, 48, 3, seed=5, host=1 - host)
                              .batch_at(0)["tokens"])


def test_prefetcher_yields_the_stream_in_order():
    stream = tsyn.LMStream(300, 16, 2, seed=1)
    fetched = tsyn.Prefetcher(stream.batch_at(i) for i in range(4))
    got = list(fetched)
    assert len(got) == 4
    for i, batch in enumerate(got):
        np.testing.assert_array_equal(batch["tokens"], stream.batch_at(i)["tokens"])


# ---------------------------------------------------------------------------
# Losses
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_cross_entropy_matches_reference(dtype):
    rng = np.random.default_rng(2)
    logits = (3 * rng.normal(size=(3, 7, 41))).astype(np.float32)
    labels = rng.integers(0, 41, size=(3, 7)).astype(np.int32)
    labels[0, :3] = -1
    labels[2, -1] = -1
    want = float(rapi.cross_entropy(jnp.asarray(logits, dtype), jnp.asarray(labels)))
    got = tapi.cross_entropy(torch.from_numpy(logits).to(getattr(torch, dtype)),
                             torch.from_numpy(labels))
    assert got.dtype == torch.float32 and got.shape == ()
    assert abs(got.item() - want) <= CE_TOL * abs(want)
    none = np.full_like(labels, -1)  # nothing to count: 0, not nan
    assert tapi.cross_entropy(torch.from_numpy(logits), torch.from_numpy(none)).item() == 0.0


@pytest.mark.parametrize("family", ["dense", "moe"])
def test_loss_fn_matches_reference(family):
    """loss, ce and aux on converted parameters, fp32; the moe family's loss
    adds router_aux_coef x aux."""
    rcfg, tcfg = _configs(family, compute_dtype="float32")
    jparams, params = _params(rcfg)
    batch = _batch(rcfg, 0)
    batch["labels"][0, :5] = -1
    want_loss, want = rapi.loss_fn(jparams, {k: jnp.asarray(v) for k, v in batch.items()},
                                   rcfg)
    got_loss, got = tapi.loss_fn(params, {k: torch.from_numpy(v) for k, v in batch.items()},
                                 tcfg)
    assert got_loss is got["loss"]
    for key in ("loss", "ce", "aux"):
        assert abs(got[key].item() - float(want[key])) <= CE_TOL * max(1.0, abs(float(want[key])))
    if family == "moe":
        assert got["aux"].item() > 0
        assert got["loss"].item() == pytest.approx(
            got["ce"].item() + tcfg.router_aux_coef * got["aux"].item(), rel=1e-7)


# ---------------------------------------------------------------------------
# Optimizers
# ---------------------------------------------------------------------------


def test_lr_schedule_matches_reference():
    kw = dict(learning_rate=3e-3, warmup_steps=10, total_steps=100)
    ours = toptim.lr_schedule(tconfig.TrainConfig(**kw))
    ref = roptim.lr_schedule(rconfig.TrainConfig(**kw))
    for step in (0, 5, 10, 55, 100, 130):  # start, warmup, its end, middle, end, past it
        got = ours(torch.tensor(step, dtype=torch.int32))
        assert got.dtype == torch.float32
        assert got.item() == pytest.approx(float(ref(jnp.int32(step))), rel=1e-6, abs=1e-12)


def _opt_tree(rng, scale=1.0) -> dict:
    """A parameter-shaped tree: a layer-stacked (2, 128, 256) leaf
    (Adafactor factors it, with one RMS over both layers), a (2, 16) stacked
    vector (weight decay applies), a matrix below 128 and a vector."""
    shapes = {"stack": (2, 128, 256), "stacked_norm": (2, 16), "w": (64, 130),
              "b": (7,)}
    return {k: (scale * rng.normal(size=s)).astype(np.float32) for k, s in shapes.items()}


def optimizer_errs(name: str) -> tuple[dict, dict, dict]:
    """Three steps of optimizer ``name`` on the same gradients (large enough
    to be clipped) in both implementations: the per leaf errors / max(1,
    max) of the parameters and every state leaf, the port's state and the
    last step's metrics of both."""
    kw = dict(optimizer=name, learning_rate=1e-2, warmup_steps=2, total_steps=10,
              weight_decay=0.1, grad_clip=1.0)
    rng = np.random.default_rng(3)
    init = _opt_tree(rng)
    grads = [_opt_tree(rng, scale=0.5) for _ in range(3)]
    ref_opt = roptim.make_optimizer(rconfig.TrainConfig(**kw))
    ours_opt = toptim.make_optimizer(tconfig.TrainConfig(**kw))
    jparams = jax.tree.map(jnp.asarray, init)
    jstate = ref_opt.init(jparams)
    params = tree_from_numpy(init, "cpu")
    state = ours_opt.init(params)
    metrics = {}
    for g in grads:
        jparams, jstate, jm = ref_opt.step(jparams, jax.tree.map(jnp.asarray, g), jstate)
        params, state, m = ours_opt.step(params, tree_from_numpy(g, "cpu"), state)
        metrics = {k: (m[k].item(), float(jm[k])) for k in ("grad_norm", "lr")}
    errs = _leaf_errs(_named_port({"p": params, "o": state}),
                      _named_ref({"p": jparams, "o": jstate}))
    return errs, state, metrics


@pytest.mark.parametrize("name", ["adamw", "adafactor", "rmsprop", "sgd"])
def test_optimizer_matches_reference_after_three_steps(name):
    """The parameters and every state leaf after three steps on the same
    gradients, per leaf / max(1, max), and the metrics."""
    errs, state, metrics = optimizer_errs(name)
    assert max(errs.values()) < OPT_TOL, errs
    for got, want in metrics.values():
        assert got == pytest.approx(want, rel=1e-6)
    assert int(state["step"]) == 3 and state["step"].dtype == torch.int32
    if name == "adafactor":
        assert state["v"]["stack"]["vr"].shape == (2, 128)
        assert state["v"]["stack"]["vc"].shape == (2, 256)
        assert set(state["v"]["w"]) == {"v"}


def test_clip_by_global_norm_returns_fp32_for_bf16_grads():
    rng = np.random.default_rng(4)
    g = {"a": rng.normal(size=(8, 16)).astype(np.float32),
         "b": [rng.normal(size=(5,)).astype(np.float32)]}
    jclipped, jnorm = roptim.clip_by_global_norm(jax.tree.map(
        lambda x: jnp.asarray(x, jnp.bfloat16), g), 1.0)
    clipped, norm = toptim.clip_by_global_norm(tree_map(
        lambda t: t.bfloat16(), tree_from_numpy(g, "cpu")), 1.0)
    assert jax.tree.leaves(jclipped)[0].dtype == jnp.float32  # the reference promotes
    assert all(t.dtype == torch.float32 for _, t in tree_paths(clipped))
    assert norm.item() == pytest.approx(float(jnorm), rel=1e-6)
    errs = _leaf_errs(_named_port(clipped), _named_ref(jclipped))
    assert max(errs.values()) < 1e-6, errs


# ---------------------------------------------------------------------------
# The training step
# ---------------------------------------------------------------------------

# (model settings, train settings, tolerance of loss and grad norm, per leaf)
VARIANTS = {"fp32": (dict(compute_dtype="float32"), {}, STEP_TOL, STEP_TOL),
            "microbatches2": (dict(compute_dtype="float32"), dict(microbatches=2), STEP_TOL,
                              STEP_TOL),
            "cast_bf16": ({}, dict(cast_params_once=True), BF16_TOL, BF16_LEAF_TOL)}
# vlm and audio take the dense family's step (models.transformer) with other
# inputs: they run the fp32 variant
CASES = [(f, v) for f in ARCHS for v in VARIANTS if v == "fp32" or f not in ("vlm", "audio")]


def _unclipped(grads, max_norm):
    """A planted fault of ``optim.clip_by_global_norm``: the scale lost, as
    when it is applied to a bf16 gradient after its fp32 copy was taken."""
    return tree_map(lambda g: g.float(), grads), global_norm(grads)


def _port_steps(trun, params, batches) -> dict:
    """The port's optimizer state after ``make_train_step`` on each batch."""
    tstep = tsteps.make_train_step(trun)[0]
    state = {"params": params, "opt": toptim.make_optimizer(trun.train).init(params)}
    for batch in batches:
        state, _ = tstep(state, {k: torch.from_numpy(v) for k, v in batch.items()})
    return state["opt"]


def train_step_errs(family: str, variant: str) -> dict:
    """Three AdamW steps of ``make_train_step`` from the same parameters in
    both implementations: each step's loss error, relative, and the first
    step's gradient norm's; the first step's gradients per leaf / that
    leaf's max |gradient|, read as mu after that step (mu = (1 - beta1) x
    the clipped gradient, the clip's scale within 1e-6 on both sides); mu
    and nu after the three steps per leaf / that leaf's max. In bf16 also
    the same readings of a planted fault (``_unclipped``)."""
    model_kw, train_kw, _, _ = VARIANTS[variant]
    rcfg, tcfg = _configs(family, **model_kw)
    rrun, trun = _runs(rcfg, tcfg, **train_kw)
    rstep = jax.jit(ref_make_train_step(rrun, None)[0])
    tstep = tsteps.make_train_step(trun)[0]
    jparams, params = _params(rcfg)
    jstate = {"params": jparams, "opt": roptim.make_optimizer(rrun.train).init(jparams)}
    state = {"params": params, "opt": toptim.make_optimizer(trun.train).init(params)}
    init = tree_map(torch.clone, params)  # the step updates params in place
    batches = [_batch(rcfg, i) for i in range(3)]
    out = {"loss": []}
    want = {}
    for i, batch in enumerate(batches):
        jstate, jm = rstep(jstate, {k: jnp.asarray(v) for k, v in batch.items()})
        state, m = tstep(state, {k: torch.from_numpy(v) for k, v in batch.items()})
        assert set(m) == set(jm) and all(v.shape == () for v in m.values())
        out["loss"].append(abs(m["loss"].item() - float(jm["loss"])) / abs(float(jm["loss"])))
        if i == 0:
            out["grad_norm"] = (abs(m["grad_norm"].item() - float(jm["grad_norm"]))
                                / float(jm["grad_norm"]))
            want["grads"] = _named_ref(jstate["opt"]["mu"])
            out["grads"] = max(_leaf_errs(_named_port(state["opt"]["mu"]), want["grads"],
                                          floor=0.0).values())
    for key in ("mu", "nu"):
        want[key] = _named_ref(jstate["opt"][key])
        out[key] = max(_leaf_errs(_named_port(state["opt"][key]), want[key],
                                  floor=0.0).values())
    if variant == "cast_bf16":
        with mock.patch.object(toptim, "clip_by_global_norm", _unclipped):
            first = _port_steps(trun, tree_map(torch.clone, init), batches[:1])
            last = _port_steps(trun, init, batches)
        out["control"] = min(
            max(_leaf_errs(_named_port(got), want[key], floor=0.0).values())
            for got, key in ((first["mu"], "grads"), (last["mu"], "mu"), (last["nu"], "nu")))
    return out


@pytest.mark.parametrize("family,variant", CASES)
def test_train_step_matches_reference(family, variant):
    _, _, tol, leaf_tol = VARIANTS[variant]
    errs = train_step_errs(family, variant)
    assert max(errs["loss"]) <= tol and errs["grad_norm"] <= tol, errs
    assert max(errs[k] for k in ("grads", "mu", "nu")) < leaf_tol, errs
    assert errs.get("control", math.inf) > leaf_tol, errs


def test_value_and_grad_is_the_gradient_of_the_loss():
    """``steps.value_and_grad`` against autograd of ``api.loss_fn`` on
    parameters that require grad, and its microbatched form against the
    mean of the two halves' gradients."""
    _, tcfg = _configs("moe", compute_dtype="float32")
    _, trun = _runs(tcfg, tcfg)
    params = tapi.init(0, tcfg, device="cpu")
    batch = {k: torch.from_numpy(v) for k, v in _batch(tcfg, 0).items()}
    loss, metrics, grads = tsteps.value_and_grad(params, batch, trun)
    live = tree_map(lambda t: t.clone().requires_grad_(True), params)
    want_loss, _ = tapi.loss_fn(live, batch, tcfg)
    want_loss.backward()
    assert loss.item() == want_loss.item() and not loss.requires_grad
    assert set(metrics) == {"loss", "ce", "aux"}
    want = {p: t.grad.numpy() for p, t in tree_paths(live)}
    assert max(_leaf_errs(_named_port(grads), want, floor=0.0).values()) == 0.0
    halves = [tsteps.value_and_grad(params, {k: v[i::2] for k, v in batch.items()}, trun)
              for i in (0, 1)]
    k2 = dataclasses.replace(trun, train=dataclasses.replace(trun.train, microbatches=2))
    loss2, metrics2, grads2 = tsteps.value_and_grad(
        params, {k: torch.cat([v[0::2], v[1::2]]) for k, v in batch.items()}, k2)
    assert metrics2["aux"].item() == 0.0 and metrics2["ce"] is metrics2["loss"]
    assert loss2.item() == pytest.approx((halves[0][0] + halves[1][0]).item() / 2, rel=1e-6)
    mean = {p: (a.numpy() + b.numpy()) / 2 for (p, a), (_, b) in
            zip(tree_paths(halves[0][2]), tree_paths(halves[1][2]))}
    assert max(_leaf_errs(_named_port(grads2), mean, floor=0.0).values()) < 1e-6


def remat_errs(family: str, remat: str) -> tuple[float, dict]:
    """The loss's relative error and each gradient leaf's / that leaf's max,
    of the port's step under ``remat`` against the same step without it."""
    _, tcfg = _configs(family, compute_dtype="float32")
    params = tapi.init(0, tcfg, device="cpu")
    batch = {k: torch.from_numpy(v) for k, v in _batch(tcfg, 0).items()}
    _, trun = _runs(tcfg, tcfg)
    loss, _, want = tsteps.value_and_grad(params, batch, trun)
    got_loss, _, got = tsteps.value_and_grad(
        params, batch, dataclasses.replace(trun, train=dataclasses.replace(trun.train,
                                                                         remat=remat)))
    return (abs(got_loss.item() - loss.item()) / abs(loss.item()),
            _leaf_errs(_named_port(got), _named_port(want), floor=0.0))


@pytest.mark.parametrize("remat", ["full", "dots"])
@pytest.mark.parametrize("family", ["dense", "ssm", "moe", "hybrid"])
def test_remat_gives_the_gradients_of_none(family, remat):
    loss_err, errs = remat_errs(family, remat)
    assert loss_err < REMAT_TOL
    assert max(errs.values()) < REMAT_TOL, errs


# ---------------------------------------------------------------------------
# Checkpointing and the loop (tests/test_train.py's, on the port)
# ---------------------------------------------------------------------------

TINY = tconfig.ModelConfig(name="tiny", family="dense", num_layers=2, d_model=32,
                           num_heads=4, num_kv_heads=2, d_ff=64, vocab_size=64)


def _tiny(**train):
    run = tconfig.RunConfig(model=TINY, shape=tconfig.ShapeConfig("t", 16, 4, "train"),
                            train=tconfig.TrainConfig(total_steps=50, warmup_steps=2,
                                                      learning_rate=1e-2, **train))
    step = tsteps.make_train_step(run)[0]
    stream = tsyn.LMStream(TINY.vocab_size, 16, 4)

    def fresh_state():
        params = tapi.init(0, TINY, device="cpu")
        return {"params": params, "opt": toptim.make_optimizer(run.train).init(params)}

    return step, fresh_state, lambda i: {k: torch.from_numpy(v)
                                         for k, v in stream.batch_at(i).items()}


def _assert_equal_trees(a, b):
    pa, pb = tree_paths(a), tree_paths(b)
    assert [p for p, _ in pa] == [p for p, _ in pb]
    for (p, x), (_, y) in zip(pa, pb):
        assert x.dtype == y.dtype and torch.equal(x, y), p


def test_loss_decreases():
    step, fresh_state, batch_at = _tiny()
    state = fresh_state()
    losses = []
    for i in range(40):
        state, m = step(state, batch_at(i))
        losses.append(m["loss"].item())
    assert np.mean(losses[-5:]) < np.mean(losses[:5]) - 0.3, losses[:3] + losses[-3:]


def test_checkpoint_roundtrip_and_gc(tmp_path):
    step, fresh_state, batch_at = _tiny()
    state, _ = step(fresh_state(), batch_at(0))
    for s in [5, 10, 15, 20]:
        tckpt.save(str(tmp_path), s, state, keep=2)
    assert tckpt.all_steps(str(tmp_path)) == [15, 20]
    restored, got = tckpt.restore(str(tmp_path), fresh_state())
    assert got == 20
    _assert_equal_trees(restored, state)


def test_checkpoint_no_partial_visible(tmp_path):
    """Nothing but fully-renamed step dirs is ever listed."""
    tckpt.save(str(tmp_path), 1, {"x": torch.arange(10)})
    os.makedirs(tmp_path / "2.tmp", exist_ok=True)  # simulated torn write
    assert tckpt.all_steps(str(tmp_path)) == [1]
    assert tckpt.latest_step(str(tmp_path)) == 1


def test_async_save_writes_the_state_of_its_call(tmp_path):
    """The host snapshot is taken before ``save`` returns: a step that then
    updates the state in place does not reach the file."""
    step, fresh_state, batch_at = _tiny()
    state = fresh_state()
    snapshot = tree_map(torch.clone, state)
    pending = tckpt.save(str(tmp_path), 1, state, blocking=False)
    state, _ = step(state, batch_at(0))  # in place
    pending.join()
    restored, _ = tckpt.restore(str(tmp_path), fresh_state())
    _assert_equal_trees(restored, snapshot)
    assert not torch.equal(restored["params"]["layers"]["mlp"]["wo"],
                           state["params"]["layers"]["mlp"]["wo"])


def test_failure_injection_and_resume(tmp_path):
    step, fresh_state, batch_at = _tiny()
    seen = {}

    def recording(state, batch):  # the first call gets the restored state
        seen.setdefault("first", tree_map(torch.clone, state))
        return step(state, batch)

    saved = {}

    def snapshotting(state, batch):
        out = step(state, batch)
        saved[int(out[0]["opt"]["step"])] = tree_map(torch.clone, out[0])
        return out

    lcfg = LoopConfig(total_steps=30, ckpt_every=10, ckpt_dir=str(tmp_path),
                      fail_at_step=17, log_every=100, async_ckpt=False)
    with pytest.raises(RuntimeError, match="injected failure"):
        run_training(snapshotting, fresh_state(), batch_at, lcfg, log_fn=lambda s: None)
    # restart: same call, no fail; must resume from step 10, not 0, with the
    # state saved there, bitwise
    lcfg2 = dataclasses.replace(lcfg, fail_at_step=None)
    res = run_training(recording, fresh_state(), batch_at, lcfg2, log_fn=lambda s: None)
    assert res.resumed_from == 10
    assert res.final_step == 30
    assert tckpt.latest_step(str(tmp_path)) == 30
    _assert_equal_trees(seen["first"], saved[10])


def test_straggler_watchdog(tmp_path):
    step, fresh_state, batch_at = _tiny()
    calls = []

    def batch_slow(i):
        # step 20 is slow against the steps before it however loaded the
        # machine is: it sleeps 10 times their median (the gaps between
        # these calls, each a whole step), and at least 2 s
        if i == 20:
            time.sleep(max(2.0, 10 * float(np.median(np.diff(calls)))))
        calls.append(time.monotonic())
        return batch_at(i)

    lcfg = LoopConfig(total_steps=25, ckpt_every=100, ckpt_dir=str(tmp_path),
                      log_every=100, straggler_factor=3.0, async_ckpt=False)
    res = run_training(step, fresh_state(), batch_slow, lcfg, log_fn=lambda s: None)
    assert any(e["step"] == 20 for e in res.straggler_events)


def _dense_states():
    """The dense SMOKE config's state after one AdamW step in the reference,
    and the port's state of the same structure (zeros: restore fills it)."""
    rcfg, tcfg = _configs("dense", compute_dtype="float32")
    rrun, trun = _runs(rcfg, tcfg)
    jparams, _ = _params(rcfg, seed=1)
    jstate = {"params": jparams, "opt": roptim.make_optimizer(rrun.train).init(jparams)}
    jstate, _ = jax.jit(ref_make_train_step(rrun, None)[0])(
        jstate, {k: jnp.asarray(v) for k, v in _batch(rcfg, 0).items()})
    params = tapi.init(0, tcfg, device="cpu")
    return jstate, {"params": params, "opt": toptim.make_optimizer(trun.train).init(params)}


def test_reference_and_port_checkpoints_restore_into_each_other(tmp_path):
    """A checkpoint the reference writes restores into the port's state, and
    one the port writes into the reference's: the same array names, every
    leaf bitwise (fp32 and the int32 step)."""
    jstate, like = _dense_states()
    rckpt.save(str(tmp_path / "ref"), 1, jstate)
    ours, step = tckpt.restore(str(tmp_path / "ref"), like)
    assert step == 1
    want = {p: np.asarray(leaf) for p, leaf in ref_tree_paths(jstate)}
    got = {p: leaf.numpy() for p, leaf in tree_paths(ours)}
    assert got.keys() == want.keys()
    for p, w in want.items():
        assert got[p].dtype == w.dtype and np.array_equal(got[p], w), p
    tckpt.save(str(tmp_path / "port"), 2, ours)
    manifest = json.loads((tmp_path / "port" / "2" / "manifest.json").read_text())
    assert manifest["paths"] == [p for p, _ in ref_tree_paths(jstate)]
    back, step = rckpt.restore(str(tmp_path / "port"), jstate)
    assert step == 2
    for (p, x), (_, y) in zip(ref_tree_paths(back), ref_tree_paths(jstate)):
        assert x.dtype == y.dtype and np.array_equal(np.asarray(x), np.asarray(y)), p


def test_bf16_leaf_roundtrips_through_its_bits(tmp_path):
    rng = np.random.default_rng(6)
    state = {"w": torch.from_numpy(rng.normal(size=(5, 9)).astype(np.float32)).bfloat16(),
             "v": torch.from_numpy(rng.normal(size=(4,)).astype(np.float32)),
             "step": torch.tensor(3, dtype=torch.int32)}
    tckpt.save(str(tmp_path), 7, state)
    manifest = json.loads((tmp_path / "7" / "manifest.json").read_text())
    assert manifest["dtypes"] == {"step": "int32", "v": "float32", "w": "bfloat16"}
    with np.load(tmp_path / "7" / "arrays.npz") as data:
        assert data["w"].dtype == np.uint16
    restored, _ = tckpt.restore(str(tmp_path), tree_map(torch.zeros_like, state))
    _assert_equal_trees(restored, state)


# ---------------------------------------------------------------------------
# The launcher
# ---------------------------------------------------------------------------


def test_launcher_trains_a_smoke_config(tmp_path, capsys):
    tlaunch.main(["--arch", "qwen3-1.7b", "--smoke", "--steps", "3", "--seq", "16",
                  "--batch", "2", "--device", "cpu", "--ckpt", str(tmp_path / "ck")])
    assert "done: 3 steps" in capsys.readouterr().out
    assert tckpt.latest_step(str(tmp_path / "ck_qwen3_1_7b")) == 3
    # --mesh trains under torchrun (tests/test_torch_sharded.py); a world
    # of another size than the mesh's is refused before anything starts
    with mock.patch.dict(os.environ, {"WORLD_SIZE": "1"}):
        with pytest.raises(SystemExit, match="needs 8 ranks"):
            tlaunch.main(["--arch", "qwen3-1.7b", "--smoke", "--mesh", "2x4", "--device",
                          "cpu"])
    with pytest.raises(SystemExit, match="token-LM families"):
        tlaunch.main(["--arch", "hubert-xlarge", "--smoke", "--device", "cpu"])
