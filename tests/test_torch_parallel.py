"""The port's distribution substrate against the JAX reference, with no
process group: the sharding rules (``param_specs`` over every config's
parameter tree, ``cache_specs``, ``batch_specs``, ``logits_spec`` and the
optimizer-state specs) equal the reference's entry for entry on stand-in
meshes (an object whose ``shape`` is ``{axis: size}``, which both
``ParallelCtx``s read), ``ParallelCtx`` and ``from_mesh`` agree, specs
become DTensor placements in jax's major-to-minor order, and the int8
quantizer is bitwise the reference's. The spawned worlds (compressed
all-reduce, pipeline, sharded models, steps and checkpoints) are
tests/test_torch_sharded.py."""
import dataclasses
import functools
from types import SimpleNamespace

import numpy as np
import pytest

torch = pytest.importorskip("torch")
import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

from repro import configs as rconfigs  # noqa: E402
from repro.config import MeshConfig as RMeshConfig  # noqa: E402
from repro.config import ShapeConfig as RShapeConfig  # noqa: E402
from repro.parallel import compression as RC  # noqa: E402
from repro.parallel import ctx as rctx  # noqa: E402
from repro.parallel import sharding as RS  # noqa: E402
from repro.train import optim as roptim  # noqa: E402
from repro.train import steps as rsteps  # noqa: E402
from repro_torch import configs as tconfigs  # noqa: E402
from repro_torch.config import MeshConfig, ShapeConfig, TrainConfig  # noqa: E402
from repro_torch.parallel import compression as TC  # noqa: E402
from repro_torch.parallel import ctx as tctx  # noqa: E402
from repro_torch.parallel import sharding as TS  # noqa: E402
from repro_torch.train import optim as toptim  # noqa: E402
from repro_torch.train import steps as tsteps  # noqa: E402

ARCHS = sorted(rconfigs.ARCHS)
MESHES = {
    "16x16": ({"data": 16, "model": 16}, False),
    "2x16x16": ({"pod": 2, "data": 16, "model": 16}, True),
    "2x4": ({"data": 2, "model": 4}, False),
}
# one config of each decoder family (audio is encoder-only: no cache)
CACHE_ARCHS = ("qwen3_1_7b", "pixtral_12b", "qwen2_moe_a2_7b", "mamba2_370m", "zamba2_7b")


def _mesh(name):
    return SimpleNamespace(shape=dict(MESHES[name][0]))


def _ctxs(mesh, fsdp=True, tp=True):
    multi_pod = MESHES[mesh][1]
    return (rctx.from_mesh(_mesh(mesh), multi_pod, fsdp, tp),
            tctx.from_mesh(_mesh(mesh), multi_pod, fsdp, tp))


def _flat(tree, prefix=()):
    """{path: spec as a tuple} of a spec tree (either implementation's)."""
    if isinstance(tree, dict):
        out = {}
        for k, v in tree.items():
            out.update(_flat(v, prefix + (str(k),)))
        return out
    return {"/".join(prefix): tuple(tree)}


@functools.lru_cache(maxsize=None)
def _ref_params(arch):
    return rsteps.abstract_params(rconfigs.get(arch))


@functools.lru_cache(maxsize=None)
def _port_params(arch):
    return tsteps.abstract_params(tconfigs.get(arch))


@pytest.mark.parametrize("fsdp", [True, False])
@pytest.mark.parametrize("tp", [True, False])
@pytest.mark.parametrize("mesh", sorted(MESHES))
@pytest.mark.parametrize("arch", ARCHS)
def test_param_specs_equal_the_reference(arch, mesh, tp, fsdp):
    rpc, tpc = _ctxs(mesh, fsdp, tp)
    mcfg = dict(multi_pod=MESHES[mesh][1], fsdp_params=fsdp, tp=tp)
    want = _flat(RS.param_specs(_ref_params(arch), rconfigs.get(arch), rpc, RMeshConfig(**mcfg)))
    got = _flat(TS.param_specs(_port_params(arch), tconfigs.get(arch), tpc, MeshConfig(**mcfg)))
    assert got == want


@pytest.mark.parametrize("batch", [1, 256])
@pytest.mark.parametrize("shard_seq", [False, True])
@pytest.mark.parametrize("kv_dtype", ["bfloat16", "int8"])
@pytest.mark.parametrize("arch", CACHE_ARCHS)
def test_cache_specs_equal_the_reference(arch, kv_dtype, shard_seq, batch):
    rpc, tpc = _ctxs("16x16")
    rshape = RShapeConfig("d", 2048, batch, "decode")
    tshape = ShapeConfig("d", 2048, batch, "decode")
    want = RS.cache_specs(rsteps.abstract_cache(rconfigs.get(arch), rshape, kv_dtype),
                          rconfigs.get(arch), rpc, shard_seq)
    got = TS.cache_specs(tsteps.abstract_cache(tconfigs.get(arch), tshape, kv_dtype),
                         tconfigs.get(arch), tpc, shard_seq)
    assert _flat(got) == _flat(want)


@pytest.mark.parametrize("shape", ["train_4k", "prefill_32k", "decode_32k", "long_500k"])
@pytest.mark.parametrize("mesh", sorted(MESHES))
@pytest.mark.parametrize("arch", ["qwen3_1_7b", "pixtral_12b", "hubert_xlarge"])
def test_batch_and_logits_specs_equal_the_reference(arch, mesh, shape):
    rpc, tpc = _ctxs(mesh)
    rs, ts = rconfigs.SHAPES[shape], tconfigs.SHAPES[shape]
    want = RS.batch_specs(rsteps.input_specs(rconfigs.get(arch), rs), rpc)
    got = TS.batch_specs(tsteps.input_specs(tconfigs.get(arch), ts), tpc)
    assert _flat(got) == _flat(want)
    for divisible in (True, False):
        assert tuple(TS.logits_spec(tpc, divisible)) == tuple(RS.logits_spec(rpc, divisible))


@pytest.mark.parametrize("optimizer", ["adamw", "adafactor"])
@pytest.mark.parametrize("arch", ARCHS)
def test_opt_specs_equal_the_reference(arch, optimizer):
    rpc, tpc = _ctxs("16x16")
    rcfg, tcfg = rconfigs.get(arch), tconfigs.get(arch)
    rp = RS.param_specs(_ref_params(arch), rcfg, rpc, RMeshConfig())
    tp = TS.param_specs(_port_params(arch), tcfg, tpc, MeshConfig())
    ropt = roptim.make_optimizer(rconfigs.TrainConfig(optimizer=optimizer))
    topt = toptim.make_optimizer(TrainConfig(optimizer=optimizer))
    want = rsteps._opt_specs(jax.eval_shape(ropt.init, _ref_params(arch)), rp)
    got = tsteps._opt_specs(topt.init(_port_params(arch)), tp)
    assert _flat(got) == _flat(want)


@pytest.mark.parametrize("tp", [True, False])
@pytest.mark.parametrize("fsdp", [True, False])
@pytest.mark.parametrize("mesh", sorted(MESHES))
def test_parallel_ctx_matches_the_reference(mesh, fsdp, tp):
    rpc, tpc = _ctxs(mesh, fsdp, tp)
    for name in ("model_size", "act_model_axis", "batch_size", "data_axis", "all_axes",
                 "batch_axes", "model_axis", "fsdp_params", "tp"):
        assert getattr(tpc, name) == getattr(rpc, name), name
    assert tuple(tpc.batch_spec(None, "model")) == tuple(rpc.batch_spec(None, "model"))
    assert tctx.from_mesh(None) is None and rctx.from_mesh(None) is None


def test_specs_become_placements_major_to_minor():
    from torch.distributed.tensor import Partial, Replicate, Shard

    mesh = SimpleNamespace(mesh_dim_names=("pod", "data", "model"))
    P = tctx.P
    assert tctx.placements(P(("pod", "data"), None, "model"), mesh) == (
        Shard(0), Shard(0), Shard(2))
    assert tctx.placements(P(None, "data"), mesh, partial=("model",)) == (
        Replicate(), Shard(1), Partial())
    with pytest.raises(ValueError, match="mesh's order"):
        tctx.placements(P(("data", "pod")), mesh)
    with pytest.raises(ValueError, match="does not divide"):
        tctx.check_even((6, 4), P("data", None), SimpleNamespace(shape={"data": 4}))


@pytest.mark.parametrize("seed", range(4))
def test_int8_quantizer_is_bitwise_the_reference(seed):
    rng = np.random.default_rng(seed)
    x = (rng.normal(0, 1, (64, 48)) * 10.0 ** rng.integers(-3, 3)).astype(np.float32)
    x[0, 0] = 0.5 * np.abs(x).max()  # a value on a rounding tie's neighbourhood
    rq, rs = RC.quantize_int8(jnp.asarray(x))
    tq, ts = TC.quantize_int8(torch.from_numpy(x))
    assert np.array_equal(tq.numpy(), np.asarray(rq)) and tq.dtype == torch.int8
    assert ts.numpy().tobytes() == np.asarray(rs).tobytes()
    back = TC.dequantize_int8(tq, ts).numpy()
    assert back.tobytes() == np.asarray(RC.dequantize_int8(rq, rs)).tobytes()


def test_mesh_on_the_card_without_a_gpu_raises():
    from repro_torch.launch import mesh as M

    if torch.cuda.is_available():
        pytest.skip("this host has a GPU")
    with pytest.raises(RuntimeError, match="no GPU"):
        M.make_mesh((2, 4), ("data", "model"))
    with pytest.raises(RuntimeError, match="no GPU"):
        M.rank_device("cuda", 0, 8)
    assert M.backend_for(8, "cuda") == "gloo_staged" and M.backend_for(8, "cpu") == "gloo"
    assert M.host_device_counts() == 0


def test_dense_configs_shard_their_kv_heads_or_fuse_them():
    """The GQA guard as both implementations apply it: kv projections
    shard by kv heads where they divide the model axis, else on the fused
    kv*hd dim (gemma's MQA on 16), else not at all."""
    rpc, tpc = _ctxs("16x16")
    for arch in ("gemma_2b", "qwen3_1_7b", "mistral_nemo_12b"):
        cfg = dataclasses.replace(tconfigs.get(arch))
        got = TS.param_spec("layers/attn/wk", (cfg.num_layers, cfg.d_model,
                                               cfg.num_kv_heads * cfg.resolved_head_dim),
                            cfg, tpc, MeshConfig())
        want = RS.param_spec("layers/attn/wk", (cfg.num_layers, cfg.d_model,
                                                cfg.num_kv_heads * cfg.resolved_head_dim),
                             rconfigs.get(arch), rpc, RMeshConfig())
        assert tuple(got) == tuple(want) and got[-1] == "model"
