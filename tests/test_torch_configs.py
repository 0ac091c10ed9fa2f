"""The port's configuration dataclasses and architecture registry against
the reference's: every ``CONFIG`` and ``SMOKE`` field for field, the
per-cell overrides, ``make_run`` and ``applicable_shapes``."""
import dataclasses

import pytest

pytest.importorskip("torch")

from repro import config as ref_config  # noqa: E402
from repro import configs as ref_configs  # noqa: E402
from repro_torch import config as port_config  # noqa: E402
from repro_torch import configs as port_configs  # noqa: E402


def test_registry_matches_reference():
    assert port_configs.ARCHS == ref_configs.ARCHS
    assert port_configs.ALIASES == ref_configs.ALIASES
    assert port_config.SHAPES == {k: port_config.ShapeConfig(**dataclasses.asdict(v))
                                  for k, v in ref_config.SHAPES.items()}


@pytest.mark.parametrize("arch", ref_configs.ARCHS)
def test_configs_match_reference_field_for_field(arch):
    for which in ("get", "smoke"):
        ours, ref = getattr(port_configs, which)(arch), getattr(ref_configs, which)(arch)
        assert type(ours).__module__ == "repro_torch.config"
        assert dataclasses.asdict(ours) == dataclasses.asdict(ref), which
        assert ours.resolved_head_dim == ref.resolved_head_dim
        assert ours.subquadratic == ref.subquadratic and ours.decoder == ref.decoder
    assert port_configs.applicable_shapes(port_configs.get(arch)) == \
        ref_configs.applicable_shapes(ref_configs.get(arch))
    for shape in ref_config.SHAPES:
        assert port_configs.run_overrides(arch, shape) == ref_configs.run_overrides(arch, shape)
        ours, ref = port_configs.make_run(arch, shape), ref_configs.make_run(arch, shape)
        assert dataclasses.asdict(ours) == dataclasses.asdict(ref), shape


def test_aliases_resolve_to_the_same_config():
    assert port_configs.get("qwen3-1.7b") == port_configs.get("qwen3_1_7b")
    cfg = port_configs.get("qwen3-1.7b")
    assert (cfg.num_layers, cfg.d_model, cfg.num_heads, cfg.num_kv_heads, cfg.head_dim,
            cfg.d_ff, cfg.vocab_size) == (28, 2048, 16, 8, 128, 6144, 151936)
    assert cfg.attn_impl == "chunked"  # the reference's default; flash_pallas is asked for
