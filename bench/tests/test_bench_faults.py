"""``correct`` comes out false when the timed path is broken underneath a
run (on the CPU at the SMOKE sizes, the harness's look for a card skipped,
the cells' own limits): a step that returns its state unchanged, a step
that leaves out half of its batch (the mean over the rest), a first token
altered where it is produced. And the control (the reference in the
program's place, fp8 products) reads well above the program."""
import copy

import pytest
import torch

from bench import control, harness, program
from bench.tests import smoke


def _broken_train(fault):
    real = program.train_step

    def make(run):
        step, init = real(run)

        def broken(state, batch):
            if fault == "state_unchanged":
                step(copy.deepcopy(state), batch)
                return state, {"loss": torch.zeros(())}
            # the second half's labels ignored: the loss is the mean over the rest
            labels = batch["labels"].clone()
            labels[labels.shape[0] // 2:] = -1
            return step(state, dict(batch, labels=labels))

        return broken, init

    return make


@pytest.mark.parametrize("cell", ["mamba2_370m.train_4k", "qwen2_moe_a2_7b.train_4k"])
@pytest.mark.parametrize("fault", ["state_unchanged", "half_batch"])
def test_a_broken_training_step_is_not_correct(cell, fault, tmp_path, monkeypatch):
    monkeypatch.setattr(program, "train_step", _broken_train(fault))
    result = smoke.run(cell, tmp_path)
    assert result["correct"] is False, result["checks"]


@pytest.mark.parametrize("cell", ["qwen2_moe_a2_7b.prefill_mixed"])
def test_an_altered_first_token_is_not_correct(cell, tmp_path, monkeypatch):
    real = program.prefill_step

    def make(cfg, batch, seq):
        step = real(cfg, batch, seq)

        def broken(params, inputs):
            logits = step(params, inputs)
            last = logits[:, -1]
            wrong = (last.argmax(-1) + 1) % last.shape[-1]
            last.scatter_(-1, wrong[:, None], last.max(-1, keepdim=True).values + 1)
            return logits

        return broken

    monkeypatch.setattr(program, "prefill_step", make)
    result = smoke.run(cell, tmp_path)
    assert result["correct"] is False, result["checks"]


@pytest.mark.parametrize("cell", ["mamba2_370m.train_4k", "qwen2_moe_a2_7b.prefill_mixed"])
def test_the_control_reads_well_above_the_program(cell, tmp_path):
    spec = harness.load_spec(smoke.ROOT)
    c = harness.find_cell(spec, cell)
    kind = "train" if "train" in cell else "prefill"
    got = control.readings(cell, 7, "cpu", conf_file=smoke.smoke_conf(c["config"], tmp_path),
                           mix_override=dict(smoke.MIX[kind], **smoke.CELL[cell]))["control"]
    sound = smoke.run(cell, tmp_path, seed=7)["checks"]
    assert any(got[k] >= 3 * v["value"] and got[k] > 0 for k, v in sound.items()), (got, sound)
