"""The port's sharded paths in one spawned 8-rank gloo world on the CPU
(tests/torch_sharded_world.py), against the JAX reference run unsharded on
the same numpy parameters and batches, as tests/test_sharded.py holds the
reference's own sharded paths over 8 host devices:

* the sharded forward of all six families' smoke configs on a (2, 4)
  (data, model) mesh, FSDP on every parameter that divides, fp32, within
  1e-4 of max |logit| (moe: the reference test's capacity-8 configs, EP with
  4 experts and TPE with 6);
* the sharded train step (dense with 2 microbatches, moe, ssm; AdamW):
  loss within 1e-5 relative, first-step gradients within 1e-4 of each
  leaf's max, parameters after 3 steps within 1e-4 of max(1, leaf max);
* six sharded dense decode steps after a 4-token prompt over a bf16 cache
  placed by ``cache_specs``, within the decode limit of
  tests/test_torch_transformer.py;
* a sharded checkpoint restored onto (4, 2) and onto one device, bitwise;
* ``compressed_psum`` over the model axis's 4 ranks, 8 steps with error
  feedback, bitwise against the reference's ``jax.vmap`` form;
* ``pipeline_apply`` over 8 stages against the reference's own
  ``pipeline_apply`` on 8 host devices (a JAX subprocess), within 1e-5.

The moe family's router loss is averaged over the ranks' token shards, as
in the reference's ``shard_map`` body, so its train step is held against
the reference's gradients of each data shard's half of the batch, averaged
(the sharded moe forward is held against the whole batch: capacity 8 drops
no token at these sizes). The launcher runs under ``torchrun`` on a 2x2
mesh. The world has one deadline: a hang fails the module's tests."""
import dataclasses
import os
import pickle
import subprocess
import sys
import textwrap
from pathlib import Path

import numpy as np
import pytest

torch = pytest.importorskip("torch")
import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

from repro.config import MeshConfig as RMeshConfig  # noqa: E402
from repro.config import ModelConfig as RModelConfig  # noqa: E402
from repro.config import RunConfig as RRunConfig  # noqa: E402
from repro.config import ShapeConfig as RShapeConfig  # noqa: E402
from repro.config import TrainConfig as RTrainConfig  # noqa: E402
from repro.configs import (hubert_xlarge, mamba2_370m, pixtral_12b, qwen3_1_7b,  # noqa: E402
                           zamba2_7b)
from repro.models import api as rapi  # noqa: E402
from repro.models import hybrid as RH, moe as RM, ssm as RSSM, transformer as RT  # noqa: E402
from repro.parallel.compression import compressed_psum  # noqa: E402
from repro.train.optim import make_optimizer as ref_optimizer  # noqa: E402
from repro.train.steps import make_train_step as ref_train_step  # noqa: E402
from repro_torch.launch.mesh import run_world  # noqa: E402
from test_torch_ssm import draw_params  # noqa: E402

ROOT = Path(__file__).resolve().parents[1]
B, S = 4, 16
LOGIT_TOL = 1e-4
LOSS_TOL, GRAD_TOL, PARAM_TOL = 1e-5, 1e-4, 1e-4
DECODE_TOL = 2e-3  # a bf16 cache element may round the other way (test_torch_transformer)
PIPE_TOL = 1e-5
TRAIN_STEPS, PSUM_STEPS = 3, 8
WORLD_DEADLINE_S = 420


def _f32(cfg):
    return dataclasses.replace(cfg, compute_dtype="float32")


def _moe(n_experts, layers):
    return RModelConfig(name=f"moe{n_experts}", family="moe", num_layers=layers, d_model=32,
                        num_heads=4, num_kv_heads=4, d_ff=64, vocab_size=64,
                        num_experts=n_experts, num_experts_per_tok=2, moe_d_ff=32,
                        capacity_factor=8.0, compute_dtype="float32")


FORWARD = {
    "dense": (_f32(qwen3_1_7b.SMOKE), RT),
    "vlm": (_f32(pixtral_12b.SMOKE), RT),
    "audio": (_f32(hubert_xlarge.SMOKE), RT),
    "moe_ep": (_moe(4, 2), RM),
    "moe_tpe": (_moe(6, 1), RM),
    "ssm": (_f32(mamba2_370m.SMOKE), RSSM),
    "hybrid": (_f32(zamba2_7b.SMOKE), RH),
}
TRAIN = {"dense": 2, "moe_ep": 1, "ssm": 1}  # family -> microbatches


def _batch(cfg, seed, labels=False):
    rng = np.random.default_rng(seed)
    out = {}
    if cfg.frontend == "audio_frames":
        out["frames"] = rng.normal(size=(B, S, cfg.frontend_dim)).astype(np.float32)
    elif cfg.frontend == "vision_patches":
        out["patches"] = rng.normal(size=(B, cfg.num_patches, cfg.frontend_dim)).astype(
            np.float32)
        out["tokens"] = rng.integers(0, cfg.vocab_size, (B, S - cfg.num_patches)).astype(
            np.int32)
    else:
        out["tokens"] = rng.integers(0, cfg.vocab_size, (B, S)).astype(np.int32)
    if labels:
        out["labels"] = rng.integers(0, cfg.vocab_size, (B, S)).astype(np.int32)
    return out


def _params(name):
    cfg, module = FORWARD[name]
    return jax.tree.map(np.asarray, draw_params(cfg, module, sorted(FORWARD).index(name)))


def _inputs():
    fwd = {name: {"cfg": dataclasses.asdict(cfg), "params": _params(name),
                  "batch": _batch(cfg, i)}
           for i, (name, (cfg, _)) in enumerate(FORWARD.items())}
    train = {name: {"cfg": fwd[name]["cfg"], "params": fwd[name]["params"],
                    "batch": _batch(FORWARD[name][0], 100 + i, labels=True),
                    "microbatches": k}
             for i, (name, k) in enumerate(TRAIN.items())}
    rng = np.random.default_rng(5)
    dense = FORWARD["dense"][0]
    return {
        "forward": fwd, "train": train, "train_steps": TRAIN_STEPS, "reshard": "dense",
        "decode": {"cfg": fwd["dense"]["cfg"], "params": fwd["dense"]["params"],
                   "tokens": rng.integers(0, dense.vocab_size, (B, 10)).astype(np.int32),
                   "prompt": 4, "max_len": 16},
        "psum": rng.normal(0, 1, (4, 32, 32)).astype(np.float32), "psum_steps": PSUM_STEPS,
        "pipeline": {"ws": (rng.normal(size=(8, 16, 16)) * 0.3).astype(np.float32),
                     "xs": rng.normal(size=(6, 4, 16)).astype(np.float32)},
    }


def run_the_world(d: Path):
    """(inputs, the 8 ranks' results), the world's inputs written to ``d``."""
    inp = _inputs()
    with open(d / "inputs.pkl", "wb") as f:
        pickle.dump(inp, f)
    sys.path.insert(0, str(Path(__file__).parent))
    import torch_sharded_world

    return inp, run_world(torch_sharded_world.main, 8, "cpu", str(d),
                          timeout_s=WORLD_DEADLINE_S)


@pytest.fixture(scope="module")
def world(tmp_path_factory):
    """(inputs, the 8 ranks' results): the world runs once per module."""
    return run_the_world(tmp_path_factory.mktemp("world"))


def rel(got, want):
    return float(np.max(np.abs(got - want)) / np.max(np.abs(want)))


def _ref_batch(batch):
    return {k: jnp.asarray(v) for k, v in batch.items()}


def forward_errs(world, name):
    """(logits / max |logit|, |aux - want|) of one family's sharded forward:
    the moe want is the mean of each data shard's router loss."""
    inp, res = world
    cfg = FORWARD[name][0]
    case = inp["forward"][name]
    fwd = jax.jit(lambda p, b: rapi.forward(p, b, cfg))
    want, aux = fwd(case["params"], _ref_batch(case["batch"]))
    got = res[0]["forward"][name]
    assert got["logits"].shape == want.shape
    if cfg.family == "moe":
        aux = np.mean([fwd(case["params"], _ref_batch({k: v[i * 2:(i + 1) * 2]
                                                       for k, v in case["batch"].items()}))[1]
                       for i in range(2)])
    return rel(got["logits"], np.asarray(want)), abs(got["aux"] - float(aux))


@pytest.mark.parametrize("name", list(FORWARD))
def test_sharded_forward_matches_reference(world, name):
    logit_err, aux_err = forward_errs(world, name)
    assert logit_err < LOGIT_TOL
    if FORWARD[name][0].family == "moe":
        assert aux_err < 1e-5
    else:
        assert aux_err == 0.0 and world[1][0]["forward"][name]["aux"] == 0.0


def _reference_train(name, case):
    """(first-step loss, first-step gradients, parameters after
    TRAIN_STEPS) of the reference, unsharded."""
    cfg = FORWARD[name][0]
    run = RRunConfig(model=cfg, shape=RShapeConfig("t", S, B, "train"),
                     train=RTrainConfig(total_steps=10, warmup_steps=1,
                                        microbatches=case["microbatches"]),
                     mesh=RMeshConfig(fsdp_min_size=1))
    batch = _ref_batch(case["batch"])
    # the shares whose gradients the step averages: the microbatches, or
    # for moe each data shard's rows (its router loss is per shard)
    k = 2 if cfg.family == "moe" else case["microbatches"]
    shares = [{n: t[i * (B // k):(i + 1) * (B // k)] for n, t in batch.items()}
              for i in range(k)]
    grad = jax.jit(jax.value_and_grad(lambda p, b: rapi.loss_fn(p, b, cfg)[0]))
    params = jax.tree.map(jnp.asarray, case["params"])
    losses, grads = zip(*(grad(params, b) for b in shares))
    loss = float(np.mean([float(x) for x in losses]))
    g0 = jax.tree.map(lambda *g: sum(g) / k, *grads)
    opt = ref_optimizer(run.train)
    state = {"params": params, "opt": opt.init(params)}
    if cfg.family == "moe":
        def step(state, _):
            gs = [jax.grad(lambda p, b: rapi.loss_fn(p, b, cfg)[0])(state["params"], b)
                  for b in shares]
            p, o, _ = opt.step(state["params"], jax.tree.map(lambda *g: sum(g) / k, *gs),
                               state["opt"])
            return {"params": p, "opt": o}, None
        step = jax.jit(step)
    else:
        step = jax.jit(ref_train_step(run, None)[0])
    for _ in range(TRAIN_STEPS):
        state, _ = step(state, batch)
    return loss, g0, state["params"]


def _paths(tree):
    from repro.common import tree_paths

    return {p: np.asarray(v, np.float32) for p, v in tree_paths(tree)}


def train_errs(world, name):
    """(loss relative, the worst gradient leaf / its max, the worst
    parameter leaf after TRAIN_STEPS / max(1, its max)) of one family's
    sharded train step."""
    inp, res = world
    got = res[0]["train"][name]
    loss, grads, params = _reference_train(name, inp["train"][name])
    want_g = _paths(grads)
    assert set(got["grads"]) == set(want_g)
    grad_err = 0.0
    for path, want in want_g.items():
        scale = np.max(np.abs(want))
        diff = np.max(np.abs(got["grads"][path] - want))
        grad_err = max(grad_err, diff / scale if scale else diff)
    param_err = max(np.max(np.abs(got["params"][path] - want)) / max(1.0, np.max(np.abs(want)))
                    for path, want in _paths(params).items())
    return abs(got["loss"] - loss) / abs(loss), float(grad_err), float(param_err)


@pytest.mark.parametrize("name", list(TRAIN))
def test_sharded_train_step_matches_reference(world, name):
    loss_err, grad_err, param_err = train_errs(world, name)
    assert loss_err < LOSS_TOL
    assert grad_err < GRAD_TOL
    assert param_err < PARAM_TOL


def dry_run_trace(world, name):
    """The dry run's shape-only trace (``launch.dryrun._measure``) of one
    train case's step as rank 0 of a fake (2, 4) CPU world; and at world 1."""
    from repro_torch.config import ModelConfig
    from repro_torch.launch import dryrun
    from repro_torch.launch.mesh import make_mesh
    from repro_torch.parallel.ctx import from_mesh

    sys.path.insert(0, str(Path(__file__).parent))
    import torch_sharded_world

    case = world[0]["train"][name]
    run = torch_sharded_world.train_run(ModelConfig(**case["cfg"]), case["microbatches"], B, S)
    with dryrun.fake_world(8):
        got = dryrun._measure(run, from_mesh(make_mesh((2, 4), ("data", "model"),
                                                       device="cpu")))
    return got, dryrun._measure(run, None, device="cpu")


@pytest.mark.parametrize("name", list(TRAIN))
def test_dry_run_trace_reads_what_the_worlds_step_did(world, name):
    """The trace of the train step reads what rank 0 of the gloo world read
    on its real step: the collectives per kind that DTensor's CommDebugMode
    counted on the first step, and the FLOPs, bytes and collectives (count,
    result and wire bytes) that the dry run's own counter read on the
    second. The 8 ranks do at least the unsharded step's FLOPs between them
    (DTensor replicates some products over the ranks: PERF.md)."""
    from repro_torch.launch import dryrun

    got, alone = dry_run_trace(world, name)
    real = world[1][0]["train"][name]
    assert got["coll_counts"] == {dryrun.COLLECTIVES[k]: v
                                  for k, v in real["comm_counts"].items()}
    for key in ("flops", "bytes", "coll_counts", "coll_result", "coll_wire"):
        assert got[key] == real["step_counts"][key], key
    assert got["flops"] > 0 and 8 * got["flops"] >= alone["flops"]


def decode_err(world):
    """The worst step of the sharded decode, / max |logit|."""
    inp, res = world
    case = inp["decode"]
    cfg = FORWARD["dense"][0]
    toks, p = case["tokens"], case["prompt"]
    step = jax.jit(lambda prm, c, t, i: rapi.decode_step(prm, c, t, i, cfg))
    cache = rapi.init_cache(cfg, B, case["max_len"], "bfloat16")
    got = res[0]["decode"]
    assert len(got) == 1 + toks.shape[1] - p
    want, cache = step(case["params"], cache, jnp.asarray(toks[:, :p]), 0)
    errs = [rel(got[0], np.asarray(want))]
    for j, i in enumerate(range(p, toks.shape[1])):
        want, cache = step(case["params"], cache, jnp.asarray(toks[:, i:i + 1]), i)
        errs.append(rel(got[j + 1], np.asarray(want)))
    return max(errs)


def test_sharded_decode_matches_reference(world):
    assert decode_err(world) < DECODE_TOL


def test_sharded_checkpoint_restores_onto_other_meshes_bitwise(world):
    _, res = world
    for r in res:
        assert r["reshard"] == {"step": TRAIN_STEPS, "mesh42": 0.0, "one": 0.0,
                                "placed": True}


def psum_mismatches(world):
    """Outputs and errors of ``compressed_psum`` that differ from the
    reference's in any bit, over the ranks and steps."""
    inp, res = world
    gs = jnp.asarray(inp["psum"])

    def body(g, e):
        out, new_e = compressed_psum({"g": g}, "i", {"g": e})
        return out["g"], new_e["g"]

    e = jnp.zeros_like(gs)
    want_out, want_err = [], []
    for t in range(PSUM_STEPS):
        out, e = jax.vmap(body, axis_name="i")(gs * (t + 1), e)
        want_out.append(np.asarray(out))
        want_err.append(np.asarray(e))
    bad = 0
    for r in res:
        m = r["psum"]["model_rank"]
        for t in range(PSUM_STEPS):
            bad += r["psum"]["outs"][t].tobytes() != want_out[t][m].tobytes()
            bad += r["psum"]["errs"][t].tobytes() != want_err[t][m].tobytes()
    return bad


def test_compressed_psum_is_bitwise_the_reference(world):
    assert psum_mismatches(world) == 0


_PIPE = textwrap.dedent("""
    import os, sys
    os.environ["XLA_FLAGS"] = "--xla_force_host_platform_device_count=8"
    import jax, jax.numpy as jnp, numpy as np
    from repro.launch.mesh import make_mesh
    from repro.parallel.pipeline import pipeline_apply
    ws, xs = np.load(sys.argv[1]), np.load(sys.argv[2])
    out = pipeline_apply(lambda p, x: jnp.tanh(x @ p["w"]), {"w": jnp.asarray(ws)},
                         jnp.asarray(xs), make_mesh((8,), ("stage",)))
    np.save(sys.argv[3], np.asarray(out))
""")


def pipeline_err(world, tmp: Path):
    """The worst rank's pipeline output against the reference's own
    ``pipeline_apply`` on 8 host devices (a JAX subprocess), absolute."""
    inp, res = world
    for name in ("ws", "xs"):
        np.save(tmp / f"{name}.npy", inp["pipeline"][name])
    env = dict(os.environ, PYTHONPATH=str(ROOT / "src"), JAX_PLATFORMS="cpu")
    out = subprocess.run([sys.executable, "-c", _PIPE, str(tmp / "ws.npy"),
                          str(tmp / "xs.npy"), str(tmp / "out.npy")],
                         env=env, capture_output=True, text=True, timeout=300)
    assert out.returncode == 0, out.stderr[-3000:]
    want = np.load(tmp / "out.npy")
    seq = inp["pipeline"]["xs"]
    for w in inp["pipeline"]["ws"]:
        seq = np.tanh(seq @ w)
    assert np.max(np.abs(want - seq)) < PIPE_TOL  # the reference is the sequential product
    assert all(r["pipeline"].shape == want.shape for r in res)
    return max(float(np.max(np.abs(r["pipeline"] - want))) for r in res)


def test_pipeline_matches_the_reference_pipeline(world, tmp_path):
    # every rank holds the last stage's outputs
    assert pipeline_err(world, tmp_path) < PIPE_TOL


def test_launcher_trains_over_a_mesh_under_torchrun(tmp_path):
    env = dict(os.environ, PYTHONPATH=str(ROOT / "src"), OMP_NUM_THREADS="1")
    out = subprocess.run(
        [sys.executable, "-m", "torch.distributed.run", "--standalone", "--nproc-per-node",
         "4", "-m", "repro_torch.launch.train", "--arch", "qwen3-1.7b", "--smoke",
         "--steps", "3", "--seq", "16", "--batch", "4", "--mesh", "2x2", "--device", "cpu",
         "--ckpt", str(tmp_path / "ck")],
        cwd=tmp_path, env=env, capture_output=True, text=True, timeout=240)
    assert out.returncode == 0, out.stderr[-4000:]
    assert "backend gloo" in out.stdout and out.stdout.count("done: 3 steps") == 1
    assert sorted(os.listdir(tmp_path / "ck_qwen3_1_7b")) == ["3"]
