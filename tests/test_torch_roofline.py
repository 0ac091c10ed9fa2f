"""The port's shape-only init and pod roofline held against the JAX
reference: ``abstract_params`` / ``abstract_cache`` / ``input_specs`` leaf by
leaf against ``jax.eval_shape`` (all on the meta device), ``count_params``
exactly and ``model_flops`` bitwise for every config, the HLO collective
parser and the roofline terms on the same text and records, and
``PodRooflineBackend`` records bitwise over the whole of
``mesh_space(256)``."""
import dataclasses
import functools

import numpy as np
import pytest

torch = pytest.importorskip("torch")

from repro import configs as ref_configs  # noqa: E402
from repro.config import SHAPES as REF_SHAPES  # noqa: E402
from repro.config import ShapeConfig as RefShape  # noqa: E402
from repro.core import meshsearch as ref_mesh  # noqa: E402
from repro.hw import roofline as ref_hw  # noqa: E402
from repro.launch import hwspecs as ref_specs  # noqa: E402
from repro.launch import roofline as ref_roof  # noqa: E402
from repro.train import steps as ref_steps  # noqa: E402
from repro_torch import configs  # noqa: E402
from repro_torch.common import tree_leaves, tree_paths, tree_size  # noqa: E402
from repro_torch.config import SHAPES, ShapeConfig  # noqa: E402
from repro_torch.core import meshsearch  # noqa: E402
from repro_torch.hw import roofline as port_hw  # noqa: E402
from repro_torch.launch import hwspecs  # noqa: E402
from repro_torch.launch import roofline  # noqa: E402
from repro_torch.train import steps  # noqa: E402

CACHED = {"dense": "qwen3_1_7b", "vlm": "pixtral_12b", "ssm": "mamba2_370m",
          "moe": "qwen2_moe_a2_7b", "hybrid": "zamba2_7b"}
INPUT_FAMILIES = ["qwen3_1_7b", "pixtral_12b", "hubert_xlarge"]
MODES = ["train_4k", "prefill_32k", "decode_32k"]
MESH_CONFIGS = ["qwen3_1_7b", "mamba2_370m", "qwen2_moe_a2_7b"]

# A post-SPMD module slice shaped like tests/test_roofline.py's sample: one
# instruction per collective flavor, both replica_groups encodings, an async
# pair, a tuple-shaped result, and lines the parser must ignore.
HLO = """\
HloModule jit_train_step, entry_computation_layout={...}

%add (a: f32[], b: f32[]) -> f32[] {
  ROOT %sum = f32[] add(f32[] %a, f32[] %b)
}

ENTRY %main {
  %p0 = bf16[16,512]{1,0} parameter(0)
  %mm = f32[16,512]{1,0} dot(bf16[16,512] %p0, bf16[512,512] %w)
  %ar = f32[16,512]{1,0} all-reduce(f32[16,512] %mm), replica_groups=[4,16]<=[64], to_apply=%add
  %ag = bf16[64,1024]{1,0} all-gather(bf16[16,1024] %x), replica_groups=[16,4]<=[64], dimensions={0}
  %rs = f32[4,256]{1,0} reduce-scatter(f32[32,256] %y), replica_groups={{0,1,2,3,4,5,6,7}}, to_apply=%add
  %a2a = bf16[8,64,32]{2,1,0} all-to-all(bf16[8,64,32] %z), replica_groups={{0,1,2,3}}
  %cp = s8[4096]{0} collective-permute(s8[4096] %q), source_target_pairs={{0,1},{1,0}}
  %tup = (f32[8], bf16[8,8]) all-reduce(f32[8] %u, bf16[8,8] %v), replica_groups=[8,8]<=[64], to_apply=%add
  %ars = f32[2,2]{1,0} all-reduce-start(f32[2,2] %m), replica_groups=[1,2]<=[2], to_apply=%add
  %ard = f32[2,2]{1,0} all-reduce-done(f32[2,2] %ars)
  %agd = bf16[4]{0} all-gather-done(bf16[4] %ags)
}
"""


def _sig(t):
    """(shape, dtype name) of a jax ShapeDtypeStruct or a torch tensor."""
    return tuple(t.shape), str(t.dtype).removeprefix("torch.")


def _same_tree(port, ref):
    got = [(name, _sig(t)) for name, t in tree_paths(port)]
    want = [(name, _sig(t)) for name, t in tree_paths(ref)]
    assert got == want
    assert all(t.device.type == "meta" for t in tree_leaves(port))


@functools.lru_cache(maxsize=None)
def _ref_counts(arch):
    return ref_roof.count_params(ref_configs.get(arch))


def test_chip_spec_is_the_references():
    assert dataclasses.asdict(hwspecs.V5E) == dataclasses.asdict(ref_specs.V5E)
    assert hwspecs.PODS == ref_specs.PODS


@pytest.mark.parametrize("arch", configs.ARCHS)
def test_abstract_params_match_eval_shape(arch):
    port = steps.abstract_params(configs.get(arch))
    _same_tree(port, ref_steps.abstract_params(ref_configs.get(arch)))
    assert tree_size(port) == _ref_counts(arch)["total"]


@pytest.mark.parametrize("kv_dtype", ["bfloat16", "int8"])
@pytest.mark.parametrize("family", sorted(CACHED))
def test_abstract_cache_matches_eval_shape(family, kv_dtype):
    arch = CACHED[family]
    port = steps.abstract_cache(configs.get(arch), SHAPES["decode_32k"], kv_dtype)
    _same_tree(port, ref_steps.abstract_cache(ref_configs.get(arch),
                                              REF_SHAPES["decode_32k"], kv_dtype))


@pytest.mark.parametrize("mode", MODES)
@pytest.mark.parametrize("arch", INPUT_FAMILIES)
def test_input_specs_match_reference(arch, mode):
    got = steps.input_specs(configs.get(arch), SHAPES[mode])
    want = ref_steps.input_specs(ref_configs.get(arch), REF_SHAPES[mode])
    assert list(got) == list(want)
    assert {k: _sig(v) for k, v in got.items()} == {k: _sig(v) for k, v in want.items()}
    assert all(t.device.type == "meta" for t in got.values())


@pytest.mark.parametrize("arch", configs.ARCHS)
def test_count_params_and_model_flops_match_reference(arch):
    assert roofline.count_params(configs.get(arch)) == _ref_counts(arch)
    for name in SHAPES:
        got = roofline.model_flops(configs.get(arch), SHAPES[name])
        want = ref_roof.model_flops(ref_configs.get(arch), REF_SHAPES[name])
        assert np.float64(got).tobytes() == np.float64(want).tobytes(), name


def test_parse_collectives_matches_reference():
    got, want = roofline.parse_collectives(HLO), ref_roof.parse_collectives(HLO)
    assert got.to_dict() == want.to_dict()
    assert got.counts["all-reduce"] == 3  # the -done halves are not counted
    assert got.total_result == want.total_result


@pytest.mark.parametrize("arch,shape", [("qwen3_1_7b", "train_4k"),
                                        ("qwen2_moe_a2_7b", "prefill_32k"),
                                        ("zamba2_7b", "decode_32k")])
def test_roofline_terms_and_analyze_match_reference(arch, shape):
    coll = roofline.parse_collectives(HLO)
    cost = {"flops": 3.7e15, "bytes accessed": 2.9e11}
    assert roofline.roofline_terms(cost, coll) == \
        ref_roof.roofline_terms(cost, ref_roof.parse_collectives(HLO))
    small = hwspecs.ChipSpec(name="slow", peak_bf16_flops=1e12, hbm_bw=1e9, ici_link_bw=1e6)
    ref_small = ref_specs.ChipSpec(**dataclasses.asdict(small))
    assert roofline.roofline_terms(cost, coll, small) == \
        ref_roof.roofline_terms(cost, ref_roof.parse_collectives(HLO), ref_small)
    for record in ({"cost_analysis": cost, "collectives": coll.to_dict(), "num_devices": 64},
                   {"cost_analysis": {"flops": 0.0}, "collectives": coll.to_dict()}):
        got = roofline.analyze(record, configs.get(arch), SHAPES[shape])
        want = ref_roof.analyze(record, ref_configs.get(arch), REF_SHAPES[shape])
        assert got == want


@pytest.mark.parametrize("mode", MODES)
@pytest.mark.parametrize("arch", MESH_CONFIGS)
def test_pod_roofline_records_bitwise_over_the_mesh_space(arch, mode):
    space = meshsearch.mesh_space(256)
    ref_space = ref_mesh.mesh_space(256)
    assert [c.options for c in space.choices] == [c.options for c in ref_space.choices]
    port = port_hw.PodRooflineBackend(configs.get(arch), SHAPES[mode])
    ref = ref_hw.PodRooflineBackend(ref_configs.get(arch), REF_SHAPES[mode])
    assert port.cache_key() == ref.cache_key()
    counts = ref._param_count()
    assert port._param_count() == counts
    ref._param_count = lambda: counts  # the reference recounts every call
    hs = [space.to_dict(v) for v in np.ndindex(*space.arity)]
    got = port.estimate_batch([None] * len(hs), hs).records
    want = ref.estimate_batch([None] * len(hs), hs).records
    assert len(got) == 1080
    assert sum(r is None for r in want) < len(want)
    assert got == want
    assert repr(got) == repr(want)  # every float to its last bit, None for None


def test_pod_roofline_cache_key_tracks_the_shape():
    cfg = configs.get("qwen3_1_7b")
    shape = ShapeConfig("grid-train-4096", 4096, 256, "train")
    key = port_hw.PodRooflineBackend(cfg, shape, chips=64).cache_key()
    assert key == ref_hw.PodRooflineBackend(
        ref_configs.get("qwen3_1_7b"), RefShape("grid-train-4096", 4096, 256, "train"),
        chips=64).cache_key()
    assert key != port_hw.PodRooflineBackend(cfg, SHAPES["train_4k"], chips=64).cache_key()
