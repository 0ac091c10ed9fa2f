"""The plain reference against the program at the SMOKE sizes on the CPU,
both in float32: the forward's logits of each configuration (with the
experts' capacity dropping assignments), and three training steps (losses,
first clipped gradients and the change of every slice, through AdamW)."""
import dataclasses

import pytest
import torch

from bench import harness, program, weights
from bench.loops import train as train_loop
from bench.reference import judge
from bench.reference.numerics import Numerics
from bench.tests import smoke
from repro_torch.models import api


def _setup(name, tmp_path):
    import json

    conf = json.loads(smoke.smoke_conf(name, tmp_path).read_text())
    cfg = dataclasses.replace(program.model_config(conf), compute_dtype="float32")
    model = __import__(f"bench.reference.{conf['reference']}", fromlist=["x"])
    return conf, cfg, model


@pytest.mark.parametrize("name,seq", [("mamba2_370m", 200), ("qwen2_moe_a2_7b", 2100)])
def test_forward_matches_the_program(name, seq, tmp_path):
    conf, cfg, model = _setup(name, tmp_path)
    params = weights.make(program.param_layout(cfg), 11, "cpu")
    tokens = torch.randint(0, conf["vocab_size"], (1, seq), generator=torch.Generator().manual_seed(3))
    if name == "qwen2_moe_a2_7b":  # the capacity drops some assignments at this length
        assert seq * conf["num_experts_per_tok"] > conf["capacity_all_below"]
    with torch.no_grad():
        want, _ = api.forward(params, {"tokens": tokens}, cfg)
        h, _ = model.hidden(params, tokens, conf, Numerics("fp32"))
        got = model.head(params, h, Numerics("fp32"))
    err = (got - want.float()).abs().max() / want.abs().max()
    assert err < 1e-4, float(err)


@pytest.mark.parametrize("cell", ["mamba2_370m.train_4k", "qwen2_moe_a2_7b.train_4k"])
def test_training_steps_match_the_program(cell, tmp_path):
    spec = harness.load_spec(smoke.ROOT)
    c = harness.find_cell(spec, cell)
    mix = {**smoke.MIX["train"], **smoke.CELL[cell], "seq_len": 160}
    ctx, _, _ = harness.context(spec, c, 5, "cpu", smoke.smoke_conf(c["config"], tmp_path), mix)
    ctx.conf["compute_dtype"] = "float32"
    ctx.conf.setdefault("port_overrides", {})["compute_dtype"] = "float32"
    loop = train_loop.Loop(ctx)
    loop.setup()
    ref = loop.reference()
    got = judge.training(loop.prog, ref)
    assert got["loss_gap"] < 1e-5 and got["grad_gap"] < 1e-4 and got["change_gap"] < 1e-3, got
