"""The PyTorch ConvNets held against the JAX reference on converted params:
logits, one SGD step, XLA's "SAME" padding, and the layer-op export.

Inputs come from numpy seeds; the reference parameter tree is converted
with ``convnets.params_from_reference``. fp32, 32 px, batch 2, on the CPU
(where each 1×1 product takes the kernel's plain version).
"""
import dataclasses
import functools

import numpy as np
import pytest

torch = pytest.importorskip("torch")
import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

from repro.core import nas as ref_nas  # noqa: E402
from repro.models import convnets as RC  # noqa: E402
from repro_torch.core import nas as port_nas  # noqa: E402
from repro_torch.core import proxy as port_proxy  # noqa: E402
from repro_torch.models import convnets as TC  # noqa: E402

LOGIT_TOL = 1e-4
LOSS_TOL = 1e-5
PARAM_TOL = 1e-4


def _port_spec(spec):
    """The same spec built from the port's dataclasses (repr round trip)."""
    return eval(repr(spec), {"ConvNetSpec": TC.ConvNetSpec, "BlockSpec": TC.BlockSpec})


def _cut(spec, n_blocks):
    return dataclasses.replace(spec, blocks=spec.blocks[:n_blocks])


def _grouped_edgetpu():
    spec = RC.manual_edgetpu(10, 32)
    blocks = tuple(dataclasses.replace(b, groups=2) if b.op == "fused" else b
                   for b in spec.blocks)
    return _cut(dataclasses.replace(spec, blocks=blocks), 5)


def _tiny_decodes():
    space = ref_nas.tiny_space()
    rng = np.random.default_rng(3)
    return [space.decode(space.sample(rng)) for _ in range(2)]


CASES = {
    "mobilenet_v2": _cut(RC.mobilenet_v2(10, 32), 5),
    "efficientnet_b0": _cut(RC.efficientnet_b0(10, 32), 5),  # SE + swish
    "manual_edgetpu": _cut(RC.manual_edgetpu(10, 32), 6),    # fused
    "manual_edgetpu_groups2": _grouped_edgetpu(),
    "tiny0": _tiny_decodes()[0],
    "tiny1": _tiny_decodes()[1],
}


def _setup(spec, seed=0, batch=2):
    p = jax.jit(RC.init, static_argnums=1)(jax.random.PRNGKey(seed), spec)
    tp = TC.params_from_reference(jax.tree.map(np.asarray, p), device="cpu")
    rng = np.random.default_rng(seed)
    x = rng.normal(size=(batch, spec.image_size, spec.image_size, 3)).astype(np.float32)
    y = rng.integers(0, spec.num_classes, size=batch).astype(np.int32)
    return p, tp, x, y


@pytest.mark.parametrize("name", sorted(CASES))
def test_logits_match_reference(name):
    spec = CASES[name]
    p, tp, x, _ = _setup(spec)
    want = np.asarray(jax.jit(RC.forward, static_argnums=2)(p, jnp.asarray(x), spec))
    got = TC.forward(tp, torch.from_numpy(x), _port_spec(spec)).numpy()
    assert got.shape == want.shape
    assert np.max(np.abs(got - want)) < LOGIT_TOL


@functools.partial(jax.jit, static_argnums=(3, 4))
def _ref_step(p, x, y, spec, lr):
    def loss_fn(p):
        logits = RC.forward(p, x, spec)
        logz = jax.nn.logsumexp(logits, axis=-1)
        gold = jnp.take_along_axis(logits, y[:, None], axis=-1)[:, 0]
        return jnp.mean(logz - gold)

    loss, g = jax.value_and_grad(loss_fn)(p)
    return jax.tree.map(lambda w, gw: w - lr * gw, p, g), loss


@pytest.mark.parametrize("name", ["mobilenet_v2", "efficientnet_b0",
                                  "manual_edgetpu_groups2", "tiny0"])
def test_train_step_matches_reference(name):
    spec = CASES[name]
    p, tp, x, y = _setup(spec, seed=1)
    want_p, want_loss = _ref_step(p, jnp.asarray(x), jnp.asarray(y), spec, 0.05)
    got_p, got_loss = port_proxy.train_step(
        tp, torch.from_numpy(x), torch.from_numpy(y).long(), _port_spec(spec), 0.05)
    assert abs(float(got_loss) - float(want_loss)) < LOSS_TOL
    want_leaves = jax.tree.leaves(jax.tree.map(np.asarray, want_p))
    want_conv = TC.params_from_reference(jax.tree.map(np.asarray, want_p), "cpu")
    got_leaves = TC.tree_leaves(got_p)
    assert len(got_leaves) == len(want_leaves)
    for g, w in zip(got_leaves, TC.tree_leaves(want_conv)):
        assert g.shape == w.shape
        assert torch.max(torch.abs(g - w)).item() < PARAM_TOL


def test_same_pads_follow_xla():
    assert TC._same_pads(224, 3, 2) == (0, 1)    # the stem at 224 px
    assert TC._same_pads(112, 5, 2) == (1, 2)    # k=5 stride-2 depthwise
    assert TC._same_pads(32, 3, 1) == (1, 1)
    assert TC._same_pads(7, 3, 2) == (1, 1)      # odd size: symmetric
    assert TC._same_pads(4, 1, 1) == (0, 0)


@pytest.mark.parametrize("k,groups", [(3, 1), (5, 8)])
def test_stride2_even_conv_needs_asymmetric_padding(k, groups):
    rng = np.random.default_rng(7)
    c = 8
    x = rng.normal(size=(2, 8, 8, c)).astype(np.float32)
    w = rng.normal(size=(k, k, c // groups, 16 if groups == 1 else c)).astype(np.float32)
    want = np.asarray(jax.lax.conv_general_dilated(
        jnp.asarray(x), jnp.asarray(w), (2, 2), "SAME",
        dimension_numbers=("NHWC", "HWIO", "NHWC"), feature_group_count=groups))
    got = TC._conv(torch.from_numpy(x), torch.from_numpy(w), 2, groups).numpy()
    assert np.max(np.abs(got - want)) < 1e-4
    # what torch's symmetric padding=k//2 would give is a different function
    sym = torch.nn.functional.conv2d(
        torch.from_numpy(x).permute(0, 3, 1, 2),
        torch.from_numpy(w).permute(3, 2, 0, 1), stride=2, padding=k // 2,
        groups=groups).permute(0, 2, 3, 1).numpy()
    assert sym.shape == want.shape
    assert np.max(np.abs(sym - want)) > 1e-2


EXPORT_SPECS = [
    RC.mobilenet_v2(), RC.efficientnet_b0(), RC.manual_edgetpu(size="s"),
    RC.manual_edgetpu(size="m"), RC.mobilenet_v2(10, 32, width=0.35),
] + _tiny_decodes()


@pytest.mark.parametrize("i", range(len(EXPORT_SPECS)))
def test_layer_ops_and_counts_match_reference(i):
    spec = EXPORT_SPECS[i]
    port = _port_spec(spec)
    assert [dataclasses.astuple(o) for o in TC.layer_ops(port)] == \
        [dataclasses.astuple(o) for o in RC.layer_ops(spec)]
    assert TC.count_flops(port) == RC.count_flops(spec)
    assert TC.count_params(port) == RC.count_params(spec)


def test_model_constructors_match_reference():
    for fn in ("mobilenet_v2", "efficientnet_b0", "manual_edgetpu"):
        assert repr(getattr(TC, fn)()) == repr(getattr(RC, fn)())
    space_r, space_t = ref_nas.s3_evolved(), port_nas.s3_evolved()
    vecs = np.stack([space_r.sample(np.random.default_rng(s)) for s in range(8)])
    assert [repr(s) for s in space_t.decode_batch(vecs)] == \
        [repr(s) for s in space_r.decode_batch(vecs)]


def _shapes(tree, path=""):
    if isinstance(tree, dict):
        return {k: v for key in tree for k, v in _shapes(tree[key], f"{path}/{key}").items()}
    if isinstance(tree, list):
        return {k: v for i, t in enumerate(tree) for k, v in _shapes(t, f"{path}/{i}").items()}
    return {path: tuple(tree.shape)}


def test_init_shapes_and_statistics():
    spec = _port_spec(RC.mobilenet_v2(10, 32))
    ours = TC.init(0, spec, device="cpu")
    ref = jax.eval_shape(lambda: RC.init(jax.random.PRNGKey(0), RC.mobilenet_v2(10, 32)))
    assert _shapes(ours) == _shapes(ref)
    head = ours["head_w"]
    fan_in = head.shape[2]
    assert abs(head.std().item() / np.sqrt(2.0 / fan_in) - 1) < 0.05
    assert abs(ours["classifier"].std().item() / 0.01 - 1) < 0.05
    assert abs(ours["classifier"].mean().item()) < 1e-3
    assert torch.equal(ours["head_gn"]["scale"], torch.ones(spec.head_filters))
    again = TC.init(0, spec, device="cpu")
    other = TC.init(1, spec, device="cpu")
    assert all(torch.equal(a, b) for a, b in zip(TC.tree_leaves(ours),
                                                 TC.tree_leaves(again)))
    assert not torch.equal(ours["stem_w"], other["stem_w"])
