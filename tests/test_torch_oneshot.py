"""The port's oneshot (weight-sharing) search held against the JAX
package's, on oneshot_bench's small MobileNetV2 base (width 0.35, 4 blocks,
head 128, 32 px): the decision space and its arrays (bitwise), the
supernet's parameter shapes, its logits on converted parameters and one SGD
step against ``jax.value_and_grad`` (the gradient of every leaf against
that leaf's own largest, and two planted faults that this check must
fail), for all-IBN, all-fused and two mixed draws; and a short CPU search with and without a cost model in the loop.
fp32, on the CPU (where each 1×1 product takes the kernel's plain
version)."""
import dataclasses
import functools

import numpy as np
import pytest

torch = pytest.importorskip("torch")
import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

from repro.core import costmodel as RCM  # noqa: E402
from repro.core import oneshot as RO  # noqa: E402
from repro.core.space import concat  # noqa: E402
from repro.models import convnets as RC  # noqa: E402
from repro_torch.common import tree_leaves, tree_map  # noqa: E402
from repro_torch.core import costmodel as TCM  # noqa: E402
from repro_torch.core import has, simulator  # noqa: E402
from repro_torch.core import oneshot as TO  # noqa: E402
from repro_torch.core.reward import RewardConfig  # noqa: E402
from repro_torch.models import convnets as TC  # noqa: E402

LOGIT_TOL = 1e-4
LOSS_TOL = 1e-4
PARAM_TOL = 1e-4
GRAD_TOL = 1e-4  # per leaf, of that leaf's largest |gradient|

BASE = dataclasses.replace(RC.mobilenet_v2(num_classes=10, image_size=32, width=0.35),
                           head_filters=128)
BASE = dataclasses.replace(BASE, blocks=BASE.blocks[:4])
TBASE = eval(repr(BASE), {"ConvNetSpec": TC.ConvNetSpec, "BlockSpec": TC.BlockSpec})
N = len(BASE.blocks)
DRAWS = {  # (ks, exps, ops); block 0's expansion is always 1
    "all_ibn": ([7, 7, 7, 7], [1, 6, 6, 6], [0, 0, 0, 0]),
    "all_fused": ([3, 3, 3, 3], [1, 3, 3, 3], [1, 1, 1, 1]),
    "mixed_a": ([3, 5, 7, 5], [1, 3, 6, 3], [0, 1, 0, 1]),
    "mixed_b": ([7, 3, 5, 3], [1, 6, 3, 6], [1, 0, 1, 0]),
}
# the reference oneshot_search's result and history keys
# (src/repro/core/oneshot.py, the dicts it returns and appends)
RESULT_KEYS = ["best_arch", "best_hw", "best_vec", "has_space", "history", "nas_space",
               "supernet_params"]
HISTORY_KEYS = ["accuracy", "area_mm2", "latency_ms", "loss", "reward", "step", "valid"]


# the reference traced once for every draw: ks, exps and ops are arrays
_ref_forward = jax.jit(RO.supernet_forward, static_argnums=2)


@functools.partial(jax.jit, static_argnums=(3,))
def _ref_sgd_step(params, images, labels, base, ks, exps, ops, lr):
    def loss_fn(p):
        logits = RO.supernet_forward(p, images, base, ks, exps, ops)
        gold = jnp.take_along_axis(logits, labels[:, None], axis=-1)[:, 0]
        return jnp.mean(jax.nn.logsumexp(logits, axis=-1) - gold)

    loss, grads = jax.value_and_grad(loss_fn)(params)
    return loss, grads, jax.tree.map(lambda w, g: w - lr * g, params, grads)


@pytest.fixture(scope="module")
def np_params():
    """One parameter tree for both: the port's init from seed 0 as numpy
    arrays, which the reference takes as jnp arrays and the port converts
    back with ``params_from_reference``."""
    return tree_map(lambda t: t.numpy(), TO.init_supernet(0, TBASE, device="cpu"))


@pytest.fixture(scope="module")
def ref_params(np_params):
    return jax.tree.map(jnp.asarray, np_params)


def _inputs(batch=4, seed=0):
    rng = np.random.default_rng(seed)
    x = rng.normal(size=(batch, 32, 32, 3)).astype(np.float32)
    y = rng.integers(0, 10, size=batch).astype(np.int32)
    return x, y


def _draw(name):
    return tuple(np.array(a, np.int32) for a in DRAWS[name])


def test_space_decode_and_arrays_are_bitwise():
    ref_space, port_space = RO.oneshot_space(BASE), TO.oneshot_space(TBASE)
    assert port_space.arity == ref_space.arity
    rng = np.random.default_rng(7)
    for _ in range(20):
        vec = ref_space.sample(rng)
        assert repr(port_space.decode(vec)) == repr(ref_space.decode(vec))
        for got, want in zip(TO._vec_to_arrays(port_space, TBASE, vec),
                             RO._vec_to_arrays(ref_space, BASE, vec)):
            assert got.dtype == want.dtype and np.array_equal(got, want)
        assert np.array_equal(port_space.features(vec), ref_space.features(vec))


def test_init_supernet_has_the_reference_shapes():
    got = TO.init_supernet(0, TBASE, device="cpu")
    want = jax.eval_shape(lambda key: RO.init_supernet(key, BASE), jax.random.PRNGKey(0))
    assert sorted(got) == sorted(want)
    assert len(got["blocks"]) == len(want["blocks"]) == N
    for gb, wb in zip(got["blocks"], want["blocks"]):
        assert sorted(gb) == sorted(wb)
        for key in wb:
            for g, w in zip(tree_leaves(gb[key]), tree_leaves(wb[key])):
                assert tuple(g.shape) == w.shape and g.dtype == torch.float32, key
                assert w.dtype == jnp.float32
    for key in ("stem_w", "head_w", "classifier"):
        assert tuple(got[key].shape) == want[key].shape
    again = TO.init_supernet(0, TBASE, device="cpu")
    assert all(torch.equal(a, b) for a, b in zip(tree_leaves(got), tree_leaves(again)))


@pytest.mark.parametrize("draw", sorted(DRAWS))
def test_supernet_forward_matches_reference(np_params, ref_params, draw):
    ks, exps, ops = _draw(draw)
    x, _ = _inputs()
    want = np.asarray(_ref_forward(ref_params, jnp.asarray(x), BASE, jnp.asarray(ks),
                                   jnp.asarray(exps), jnp.asarray(ops)))
    tp = TO.params_from_reference(np_params, "cpu")
    got = TO.supernet_forward(tp, torch.from_numpy(x), TBASE, ks, exps, ops).numpy()
    assert got.shape == want.shape == (4, 10)
    assert np.max(np.abs(got - want)) <= LOGIT_TOL * np.abs(want).max()


def _grad_errs(got, want) -> list[float]:
    """Per leaf, max |got - want| over max |want|, where ``want`` is a
    numpy tree: 0 where both are all 0, inf where only ``want`` is."""
    def err(g, w):
        diff, scale = float(np.max(np.abs(g.numpy() - w))), float(np.abs(w).max())
        return diff / scale if scale else (0.0 if diff == 0 else float("inf"))

    return tree_leaves(tree_map(err, got, want))  # tree_map goes by key


def _sgd_step_both(np_params, ref_params, draw):
    """The reference's (loss, gradients, new params), as numpy, and the
    port's, on one draw and batch."""
    ks, exps, ops = _draw(draw)
    x, y = _inputs(seed=1)
    lr = 0.05
    loss, grads, new = _ref_sgd_step(ref_params, jnp.asarray(x), jnp.asarray(y), BASE,
                                     jnp.asarray(ks), jnp.asarray(exps), jnp.asarray(ops), lr)
    # jax orders dict keys; tree_map goes by key
    want = (float(loss), tree_map(np.asarray, grads), tree_map(np.asarray, new))
    tp = TO.params_from_reference(np_params, "cpu")
    images, labels = torch.from_numpy(x), torch.from_numpy(y).long()
    got_loss, got_grads = TO.loss_and_grads(tp, images, labels, TBASE, ks, exps, ops)
    got_new, step_loss = TO.train_step(tp, images, labels, TBASE, ks, exps, ops, lr)
    assert torch.equal(step_loss, got_loss)
    return want, (float(got_loss), got_grads, got_new), tp


@pytest.mark.parametrize("draw", sorted(DRAWS))
def test_sgd_step_matches_reference(np_params, ref_params, draw):
    (loss, grads, want), (got_loss, got_grads, got), tp = _sgd_step_both(
        np_params, ref_params, draw)
    assert abs(got_loss - loss) <= LOSS_TOL * max(1.0, abs(loss))
    errs = tree_map(lambda g, w: np.max(np.abs(g.numpy() - w)) / max(1.0, np.abs(w).max()),
                    got, want)
    assert max(tree_leaves(errs)) <= PARAM_TOL
    # each leaf's gradient against its own scale: a step's update (0.05 x
    # the gradient) is far below the parameters' rounding at 1e-4 of them
    assert max(_grad_errs(got_grads, grads)) <= GRAD_TOL
    # an unselected branch's weights take a zero gradient, as through jnp.where
    ops = _draw(draw)[2]
    for i in range(N):
        key = "expand_w" if ops[i] == 1 else "fused_w"
        assert torch.equal(got["blocks"][i][key], tp["blocks"][i][key])


def _plant(fault: str, monkeypatch) -> None:
    """Faults the gradient check must see: block 0's expand conv with no
    weight gradient (the kernel's dw left out), or the unselected branch
    taking the cotangent as well (the forward unchanged)."""
    if fault == "block0_expand_dw_dropped":
        pointwise, calls = TC._pointwise, []

        def faulty(x, w, act="none"):
            calls.append(w)
            # the same weight values, with no gradient through them
            return pointwise(x, w.detach() + 0 * w if len(calls) == 1 else w, act)

        monkeypatch.setattr(TC, "_pointwise", faulty)
    else:
        where = torch.where

        def leaky(cond, a, b):
            return where(cond, a.detach(), b.detach()) + (a - a.detach()) + (b - b.detach())

        monkeypatch.setattr(torch, "where", leaky)


@pytest.mark.parametrize("fault", ["block0_expand_dw_dropped", "unselected_branch_cotangent"])
def test_sgd_step_check_fails_a_planted_fault(np_params, ref_params, fault, monkeypatch):
    _plant(fault, monkeypatch)
    (loss, grads, _), (got_loss, got_grads, _), _ = _sgd_step_both(np_params, ref_params,
                                                                   "mixed_a")
    assert abs(got_loss - loss) <= LOSS_TOL * max(1.0, abs(loss))  # the forward holds
    assert max(_grad_errs(got_grads, grads)) > GRAD_TOL


def _converted_cost_model():
    nas_space = TO.oneshot_space(dataclasses.replace(TBASE, num_classes=10))
    fdim = nas_space.feature_dim + has.has_space().feature_dim
    p = RCM.init_mlp(jax.random.PRNGKey(3), fdim, RCM.CostModelConfig())
    return TCM.CostModel(params=TCM.params_from_reference(jax.tree.map(np.asarray, p), "cpu"),
                         mu=np.array([np.log(0.05), np.log(60.0)]), sigma=np.array([0.5, 0.2]),
                         feature_fn=lambda f: f)


@pytest.mark.parametrize("with_cost_model", [False, True])
def test_search_runs_on_cpu(with_cost_model):
    rcfg = RewardConfig(latency_target_ms=0.05, area_target_mm2=simulator.BASELINE_AREA_MM2)
    cfg = TO.OneshotConfig(steps=8, warmup_frac=0.5, batch=8, device="cpu")
    res = TO.oneshot_search(TBASE, rcfg, cfg,
                            cost_model=_converted_cost_model() if with_cost_model else None)
    assert sorted(res) == RESULT_KEYS
    assert [h["step"] for h in res["history"]] == [4, 5, 6, 7]
    for h in res["history"]:
        assert sorted(h) == HISTORY_KEYS
        assert 0.0 <= h["accuracy"] <= 1.0 and np.isfinite(h["loss"])
        assert h["valid"] == (h["latency_ms"] is not None)
        if with_cost_model:
            assert h["valid"] and h["latency_ms"] > 0 and h["area_mm2"] > 0
    joint = concat(res["nas_space"], res["has_space"])
    assert repr(joint.decode(res["best_vec"])) == repr((res["best_arch"], res["best_hw"]))
    assert all(t.device.type == "cpu" for t in tree_leaves(res["supernet_params"]))


def test_entry_point_defaults_to_the_card():
    assert TO.OneshotConfig().device == "cuda"
