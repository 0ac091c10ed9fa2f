"""The port's entry points outside ``src/`` against the reference's, on the
CPU: ``scripts/torch_obs_report.py``, ``scripts/torch_make_serve_fixture.py``
(through ``tests/test_torch_serve.py``) and the five ``examples/torch_*.py``.
The reference scripts run in this process (the reference examples once
per module); every port entry point runs with ``--device cpu``.

* ``torch_obs_report``: on copies of one directory traced by
  ``scripts/torch_sweep.py --quick --device cpu --trace``, its text and its
  ``--json`` equal the reference script's (but for the merged trace's
  path); on an empty directory both exit 2 with the same message.
* ``torch_scenario_sweep`` and ``torch_codesign_mesh --arch qwen3-1.7b
  --samples 24`` print what the reference examples print.
* ``torch_serve_lm``'s ``generate`` on the reference example's weights
  (converted by ``params_from_reference``) and prompts, teacher-forced on
  the reference loop's tokens: every step's logits within ``SERVE_TOL`` of
  the reference's, and its argmax the reference's token wherever the
  reference's top-two gap exceeds twice that.
* ``torch_train_lm`` with its config narrowed learns in 60 steps and
  resumes from 60 when run again to 80 on the same ``--ckpt``.
* ``torch_quickstart`` at 4 samples of 5 training steps runs to its end,
  and every 1×1 product it computes is one that ``chip_smoke.py``'s kernel
  phase holds on the card (``quickstart_shapes``).
* Without a GPU every entry point that computes raises unless given
  ``--device cpu``.
"""
import contextlib
import dataclasses
import functools
import importlib.util
import io
import json
import shutil
import subprocess
import sys
from pathlib import Path

import numpy as np
import pytest

torch = pytest.importorskip("torch")
import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

from repro.core import nas as ref_nas  # noqa: E402
from repro.models import api as ref_api  # noqa: E402
from repro_torch.kernels import ref as kref  # noqa: E402
from repro_torch.config import ModelConfig  # noqa: E402
from repro_torch.models import transformer as TT  # noqa: E402

ROOT = Path(__file__).resolve().parents[1]
sys.path.insert(0, str(ROOT))
import chip_smoke  # noqa: E402  (its phases run only under __main__)

# relative to max |reference logit|, per decode step: bf16 compute rounds at
# other places in the two frameworks (about 1e-2 apart, as in
# tests/test_torch_transformer.py), and an int8 cache entry that rounds the
# other way moves a logit by a step of the quantizer
SERVE_TOL = 3e-2


def _load(rel: str):
    path = ROOT / rel
    spec = importlib.util.spec_from_file_location(path.stem, path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def _run_reference(rel: str, argv: list[str]) -> tuple[str, str, int]:
    """(stdout, stderr, exit code) of the reference script ``rel`` run in
    this process with ``argv``; its ``main`` reads ``sys.argv``."""
    mod = _load(rel)
    out, err, code = io.StringIO(), io.StringIO(), 0
    saved = sys.argv
    sys.argv = [rel, *argv]
    try:
        with contextlib.redirect_stdout(out), contextlib.redirect_stderr(err):
            mod.main()
    except SystemExit as e:
        code = e.code
    finally:
        sys.argv = saved
    return out.getvalue(), err.getvalue(), code


def _run_port(rel: str, argv: list[str], capsys) -> tuple[str, str, int]:
    capsys.readouterr()
    code = 0
    try:
        _load(rel).main(argv)
    except SystemExit as e:
        code = e.code
    got = capsys.readouterr()
    return got.out, got.err, code


# ---------------------------------------------------------------------------
# torch_obs_report
# ---------------------------------------------------------------------------


@pytest.fixture(scope="module")
def traced_run(tmp_path_factory):
    root = tmp_path_factory.mktemp("traced")
    with contextlib.redirect_stdout(io.StringIO()):
        _load("scripts/torch_sweep.py").main(
            ["--quick", "--device", "cpu", "--trace", str(root / "run")])
    return root / "run"


@pytest.mark.parametrize("as_json", [False, True], ids=["text", "json"])
def test_obs_report_equals_the_references(traced_run, tmp_path, capsys, as_json):
    ref_dir, port_dir = tmp_path / "ref", tmp_path / "port"
    shutil.copytree(traced_run, ref_dir)
    shutil.copytree(traced_run, port_dir)
    flags = ["--json"] if as_json else []
    want, _, want_code = _run_reference("scripts/obs_report.py", [str(ref_dir), *flags])
    got, _, got_code = _run_port("scripts/torch_obs_report.py", [str(port_dir), *flags],
                                 capsys)
    assert got_code == want_code == 0
    if as_json:
        want, got = json.loads(want), json.loads(got)
        assert got.pop("trace") == str(port_dir / "trace.json")
        assert want.pop("trace") == str(ref_dir / "trace.json")
        assert got["spans"] and got == want
    else:
        assert "merged trace:" in got
        assert got.replace(str(port_dir), "DIR") == want.replace(str(ref_dir), "DIR")


def test_obs_report_on_an_empty_dir_exits_2_as_the_reference(tmp_path, capsys):
    empty = tmp_path / "empty"
    empty.mkdir()
    want = _run_reference("scripts/obs_report.py", [str(empty)])
    got = _run_port("scripts/torch_obs_report.py", [str(empty)], capsys)
    assert got == want
    assert want[2] == 2 and want[1].startswith("no trace.jsonl* files under")


# ---------------------------------------------------------------------------
# the search examples
# ---------------------------------------------------------------------------

SEARCH_EXAMPLES = {
    "scenario_sweep": [],
    "codesign_mesh": ["--arch", "qwen3-1.7b", "--samples", "24"],
}


@functools.cache
def _reference_example(name: str) -> str:
    out, _, code = _run_reference(f"examples/{name}.py", SEARCH_EXAMPLES[name])
    assert code == 0
    return out


@pytest.mark.parametrize("name", sorted(SEARCH_EXAMPLES))
def test_search_example_prints_the_references(name, capsys):
    got, _, code = _run_port(f"examples/torch_{name}.py",
                             [*SEARCH_EXAMPLES[name], "--device", "cpu"], capsys)
    assert code == 0
    assert got == _reference_example(name)
    if name == "codesign_mesh":
        assert "mfu 1.000" in got.splitlines()[2]  # the reference's own print


def test_quickstart_runs_to_its_end(monkeypatch, capsys):
    qs = _load("examples/torch_quickstart.py")
    monkeypatch.setattr(qs, "SAMPLES", 4)
    monkeypatch.setattr(qs, "TRAIN_STEPS", 5)
    products, plain = set(), kref.ibn_pointwise_ref

    def recording(x, w, b, act):  # what the kernel would compute on the card
        products.add((*x.shape, w.shape[1], x.dtype))
        return plain(x, w, b, act)

    monkeypatch.setattr(kref, "ibn_pointwise_ref", recording)
    res = qs.main(["--device", "cpu"])
    held = chip_smoke.products_of(chip_smoke.quickstart_shapes())
    assert products and {p[3] for p in products} == {torch.float32}
    assert {p[:3] for p in products} <= held
    lines = capsys.readouterr().out.splitlines()
    space = ref_nas.tiny_space()
    assert lines[0] == (f"search space: {space.name}, {space.num_decisions} decisions, "
                        f"cardinality {space.cardinality:.2e}")
    assert len(res.history) == 4
    assert lines[2] == f"evaluated 4 samples in {res.wall_s:.0f}s"
    assert lines[-1].startswith("   BlockSpec(") or lines[-1].startswith("no sample met")


# ---------------------------------------------------------------------------
# torch_serve_lm
# ---------------------------------------------------------------------------


@functools.cache
def _reference_serve():
    """The reference example's weights, prompts, greedy tokens and every
    step's logits (its loop, as ``examples/serve_lm.py`` runs it)."""
    from repro.config import ModelConfig as RefModelConfig

    sl = _load("examples/torch_serve_lm.py")
    cfg = RefModelConfig(**dataclasses.asdict(sl.CONFIG))  # a copy, field for field
    params = ref_api.init(jax.random.PRNGKey(0), cfg)
    prompts = jax.random.randint(jax.random.PRNGKey(1), (sl.BATCH, sl.PROMPT_LEN), 0,
                                 cfg.vocab_size)
    cache = ref_api.init_cache(cfg, sl.BATCH, sl.MAX_LEN, kv_dtype=sl.KV_DTYPE)
    decode = jax.jit(lambda p, c_, t, i: ref_api.decode_step(p, c_, t, i, cfg))
    tok, generated, steps = prompts[:, :1], [], []
    for t in range(sl.PROMPT_LEN + sl.GEN_LEN - 1):
        logits, cache = decode(params, cache, tok, jnp.int32(t))
        steps.append(np.asarray(logits[:, -1]))
        if t + 1 < sl.PROMPT_LEN:
            tok = prompts[:, t + 1:t + 2]
        else:
            tok = jnp.argmax(logits[:, -1:], axis=-1).astype(jnp.int32)
            generated.append(np.asarray(tok))
    return (jax.tree.map(np.asarray, params), np.array(prompts),
            np.concatenate(generated, axis=1), np.stack(steps))


def test_serve_lm_matches_the_reference_loop_teacher_forced():
    sl = _load("examples/torch_serve_lm.py")
    np_params, prompts, want_tokens, want_logits = _reference_serve()
    params = TT.params_from_reference(np_params, "cpu")
    tokens, logits = sl.generate(params, sl.CONFIG, torch.from_numpy(prompts),
                                 forced=torch.from_numpy(want_tokens))
    assert tokens.shape == want_tokens.shape == (sl.BATCH, sl.GEN_LEN)
    assert logits.shape == want_logits.shape
    for t in range(len(want_logits)):
        err = np.abs(logits[t].float().numpy() - want_logits[t]).max()
        assert err <= SERVE_TOL * np.abs(want_logits[t]).max(), f"step {t}"
    gen = want_logits[sl.PROMPT_LEN - 1:]  # the steps whose argmax is a generated token
    top2 = np.sort(gen, axis=-1)[..., -2:]
    clear = (top2[..., 1] - top2[..., 0]) > 2 * SERVE_TOL * np.abs(gen).max(-1)
    assert clear.sum() > 0
    assert (tokens.numpy().T[clear] == want_tokens.T[clear]).all()


# ---------------------------------------------------------------------------
# torch_train_lm
# ---------------------------------------------------------------------------


def test_train_lm_learns_and_resumes(monkeypatch, tmp_path, capsys):
    tl = _load("examples/torch_train_lm.py")
    monkeypatch.setattr(tl, "CONFIG", ModelConfig(
        name="lm-narrow", family="dense", num_layers=2, d_model=64, num_heads=4,
        num_kv_heads=2, d_ff=256, vocab_size=tl.CONFIG.vocab_size, use_qk_norm=True))
    argv = ["--seq", "32", "--batch", "2", "--device", "cpu", "--ckpt", str(tmp_path)]
    first = tl.main(["--steps", "60", *argv])  # the example asserts that it learned
    assert first.final_step == 60 and first.resumed_from is None
    again = tl.main(["--steps", "80", *argv])
    assert again.resumed_from == 60 and again.final_step == 80
    assert [m["step"] for m in again.metrics_history] == [60, 79]
    out = capsys.readouterr().out
    assert "[loop] resumed from checkpoint step 60" in out
    assert "over 80 steps" in out


# ---------------------------------------------------------------------------
# the card by default
# ---------------------------------------------------------------------------

COMPUTING = {
    "scripts/torch_make_serve_fixture.py": ["--out", "{tmp}/fixture.jsonl"],
    "examples/torch_quickstart.py": [],
    "examples/torch_scenario_sweep.py": [],
    "examples/torch_codesign_mesh.py": [],
    "examples/torch_serve_lm.py": [],
    "examples/torch_train_lm.py": ["--ckpt", "{tmp}/ckpt"],
}


@pytest.mark.parametrize("rel", sorted(COMPUTING))
def test_entry_point_raises_without_a_gpu_unless_asked_for_the_cpu(rel, tmp_path, capsys):
    if torch.cuda.is_available():
        pytest.skip("holds what happens on a host without a GPU")
    argv = [a.format(tmp=tmp_path) for a in COMPUTING[rel]]
    with pytest.raises(RuntimeError, match="device 'cuda' was asked for"):
        _load(rel).main(argv)
    assert capsys.readouterr().out == ""  # it computed nothing first
    assert list(tmp_path.iterdir()) == []


def test_obs_report_runs_as_a_command(tmp_path):
    """``torch_obs_report.py`` as a command: its ``__main__`` guard runs
    ``main``, and the exit code and message are the script's."""
    out = subprocess.run([sys.executable, "scripts/torch_obs_report.py", str(tmp_path)],
                         cwd=ROOT, capture_output=True, text=True, timeout=120)
    assert out.returncode == 2
    assert out.stderr.strip() == f"no trace.jsonl* files under {tmp_path}"
