"""The inputs a run draws from its seed: the same for one seed, other for
another, and the same work (the same batches every cycle) for every seed."""
import json
import math

import numpy as np
import pytest
import torch

from bench import harness, weights
from bench.loops import prefill, train
from bench.tests import smoke
from bench.traffic.lmstream import LMStream
from repro_torch.data.synthetic import LMStream as ProgramStream

BIG = 2**31 + 12345  # seeds run past 32 bits


def test_lmstream_is_the_programs_stream():
    for seed in (0, 5, BIG):
        a = LMStream(50280, 96, 4, seed=seed).batch_at(3)
        b = ProgramStream(50280, 96, 4, seed=seed).batch_at(3)
        assert all(np.array_equal(a[k], b[k]) for k in ("tokens", "labels"))


def _loop(mod, cell, seed, tmp_path):
    spec = harness.load_spec(smoke.ROOT)
    c = harness.find_cell(spec, cell)
    kind = "train" if "train" in cell else "prefill"
    ctx, _, _ = harness.context(spec, c, seed, "cpu", smoke.smoke_conf(c["config"], tmp_path),
                                dict(smoke.MIX[kind], **smoke.CELL[cell]))
    loop = mod.Loop(ctx)
    loop.inputs()
    return loop


def test_train_batches_repeat_for_a_seed_and_differ_between_seeds(tmp_path):
    a = _loop(train, "mamba2_370m.train_4k", BIG, tmp_path)
    b = _loop(train, "mamba2_370m.train_4k", BIG, tmp_path)
    c = _loop(train, "mamba2_370m.train_4k", BIG + 1, tmp_path)
    for i in range(4):
        assert torch.equal(a.batch_at(i)["tokens"], b.batch_at(i)["tokens"])
        assert not torch.equal(a.batch_at(i)["tokens"], c.batch_at(i)["tokens"])
    rows = torch.cat([a.batch_at(i)["tokens"] for i in range(a.checked)])
    assert len({tuple(r.tolist()) for r in rows}) == rows.shape[0]  # checked rows differ


def test_prefill_schedule_repeats_and_every_cycle_serves_the_same_batches(tmp_path):
    a = _loop(prefill, "qwen2_moe_a2_7b.prefill_mixed", BIG, tmp_path)
    b = _loop(prefill, "qwen2_moe_a2_7b.prefill_mixed", BIG, tmp_path)
    c = _loop(prefill, "qwen2_moe_a2_7b.prefill_mixed", 3, tmp_path)
    n = len(a.cycle)
    for j in range(3 * n):
        assert torch.equal(a.tokens_at(j), b.tokens_at(j))
        assert a.shape_at(j)[:2] == c.shape_at(j)[:2]  # the same shapes for every seed
    assert any(not torch.equal(a.tokens_at(j), c.tokens_at(j)) for j in range(n))
    for cycle in range(3):
        got = sorted(a.shape_at(cycle * n + i)[:2] for i in range(n))
        assert got == sorted(a.cycle)
    assert len({tuple(a.shape_at(cycle * n + i)[:2] for i in range(n)) for cycle in range(4)}) > 1


def test_prompt_lengths_follow_the_lognormal_by_hand():
    mix = json.loads((smoke.ROOT / "bench" / "traffic" / "prefill_mixed.json").read_text())
    counts = prefill.bucket_requests(mix)
    assert sum(counts) == mix["requests_per_cycle"]
    # the 1024 bucket holds lengths from sqrt(768 * 1024) to sqrt(1024 * 1536)
    phi = [0.5 * (1 + math.erf(math.log(e / 1020) / math.sqrt(2))) for e in (886.81, 1254.1)]
    assert counts[4] == round(64 * (phi[1] - phi[0]))
    assert counts == [8, 5, 7, 8, 9, 8, 7, 5, 3, 2, 2]
    batches = prefill.cycle_batches(dict(mix, batch_tokens=4096))
    assert (1, 8192) in batches and (2, 2048) in batches and (1, 2048) in batches
    assert all(b * s <= 4096 or b == 1 for b, s in batches)
    assert sum(b for b, s in batches if s == 2048) == 7


@pytest.mark.parametrize("path,shape", [(("layers", "wx"), (2, 8, 16)),
                                        (("layers", "A_log"), (2, 4)),
                                        (("embed", "embedding"), (32, 8))])
def test_weights_repeat_for_a_seed_and_differ_between_seeds(path, shape):
    a = weights.draw(path, shape, torch.float32, BIG, "cpu")
    assert torch.equal(a, weights.draw(path, shape, torch.float32, BIG, "cpu"))
    assert not torch.equal(a, weights.draw(path, shape, torch.float32, BIG + 1, "cpu"))


def test_weights_follow_the_published_ranges():
    a = -torch.exp(weights.draw(("layers", "A_log"), (4, 1000), torch.float32, 1, "cpu"))
    assert a.min() >= -16 and a.max() <= -1
    dt = torch.nn.functional.softplus(
        weights.draw(("layers", "dt_bias"), (4, 1000), torch.float32, 1, "cpu"))
    assert dt.min() >= 0.99e-3 and dt.max() <= 0.101
    w = weights.draw(("layers", "wo"), (2, 400, 300), torch.float32, 1, "cpu")
    assert abs(w.std().item() - 400 ** -0.5) < 2e-3
