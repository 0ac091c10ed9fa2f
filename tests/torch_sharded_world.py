"""What each rank of tests/test_torch_sharded.py's 8-rank gloo world runs on
the CPU (imported by the spawned ranks, so it imports no jax and nothing of
the reference). ``main(rank, in_dir)`` reads the inputs the parent wrote
into ``in_dir`` (the reference's parameters and the batches, as numpy),
runs every sharded check over meshes (2, 4), (4, 2) and (8,), and returns
numpy results: rank 0 the whole ones, every rank what only it holds."""
from __future__ import annotations

import contextlib
import os
import pickle

import numpy as np
import torch
from torch.distributed.tensor.debug import CommDebugMode

from repro_torch.common import tree_from_numpy, tree_map, tree_paths
from repro_torch.config import MeshConfig, ModelConfig, RunConfig, ShapeConfig, TrainConfig
from repro_torch.launch import dryrun
from repro_torch.launch.mesh import make_mesh
from repro_torch.models import api
from repro_torch.parallel import compression, pipeline, sharding
from repro_torch.parallel.ctx import from_mesh
from repro_torch.train import checkpoint, steps
from repro_torch.train.optim import make_optimizer

# every parameter is FSDP-sharded where a dim divides, however small
MESH_CFG = MeshConfig(fsdp_min_size=1)


def load(in_dir: str) -> dict:
    with open(os.path.join(in_dir, "inputs.pkl"), "rb") as f:
        return pickle.load(f)


def full(x) -> np.ndarray:
    return (x.full_tensor() if hasattr(x, "full_tensor") else x).detach().float().numpy()


def full_tree(tree) -> dict:
    return {p: full(t) for p, t in tree_paths(tree)}


def train_run(cfg: ModelConfig, microbatches: int, batch: int, seq: int) -> RunConfig:
    return RunConfig(model=cfg, shape=ShapeConfig("t", seq, batch, "train"),
                     train=TrainConfig(total_steps=10, warmup_steps=1,
                                       microbatches=microbatches),
                     mesh=MESH_CFG)


def forward(pc, case: dict) -> dict:
    cfg = ModelConfig(**case["cfg"])
    params = tree_from_numpy(case["params"], "cpu")
    params = sharding.distribute_tree(
        params, sharding.param_specs(params, cfg, pc, MESH_CFG), pc.mesh)
    batch = {k: torch.from_numpy(v) for k, v in case["batch"].items()}
    logits, aux = api.forward(params, batch, cfg, pc)
    return {"logits": full(logits), "aux": float(full(aux))}


def train(pc, case: dict, n_steps: int) -> tuple[dict, dict]:
    """First-step loss and gradients, then the parameters after
    ``n_steps`` sharded train steps; and the final sharded state."""
    cfg = ModelConfig(**case["cfg"])
    run = train_run(cfg, case["microbatches"], *case["batch"]["tokens"].shape)
    step, sspecs, bspecs = steps.make_train_step(run, pc)
    params = tree_from_numpy(case["params"], "cpu")
    state = {"params": params, "opt": make_optimizer(run.train).init(params)}
    state = sharding.distribute_tree(state, sspecs, pc.mesh)
    batch = sharding.distribute_tree(
        {k: torch.from_numpy(v) for k, v in case["batch"].items()}, bspecs, pc.mesh)
    loss, _, grads = steps.value_and_grad(state["params"], batch, run, pc)
    out = {"loss": float(full(loss)), "grads": full_tree(grads)}
    # the collectives of the first step as DTensor's CommDebugMode reads
    # them, and the second step as the dry run's counter reads it
    comm, counter = CommDebugMode(), dryrun.StepCounter()
    for i in range(n_steps):
        with comm if i == 0 else counter if i == 1 else contextlib.nullcontext():
            state, metrics = step(state, batch)
    out["comm_counts"] = {str(k).split(".")[-1]: v for k, v in comm.get_comm_counts().items()}
    out["step_counts"] = counter.result()
    out["params"] = full_tree(state["params"])
    out["metrics"] = {k: float(v) for k, v in metrics.items()}
    return out, (state, sspecs)


def decode(pc, case: dict) -> list:
    cfg = ModelConfig(**case["cfg"])
    toks = case["tokens"]
    b = toks.shape[0]
    run = RunConfig(model=cfg, shape=ShapeConfig("d", case["max_len"], b, "decode"),
                    mesh=MESH_CFG)
    step, pspecs, cspecs, _ = steps.make_decode_step(run, pc)
    params = sharding.distribute_tree(tree_from_numpy(case["params"], "cpu"), pspecs,
                                      pc.mesh)
    cache = sharding.distribute_tree(
        api.init_cache(cfg, b, case["max_len"], "bfloat16", device="cpu"), cspecs, pc.mesh)
    p = case["prompt"]
    out = []
    _, logits, cache = step(params, cache, torch.from_numpy(toks[:, :p]), 0)
    out.append(full(logits))
    for i in range(p, toks.shape[1]):
        _, logits, cache = step(params, cache, torch.from_numpy(toks[:, i:i + 1]), i)
        out.append(full(logits))
    return out


def reshard(state, sspecs, ckpt_dir: str, mesh42) -> dict:
    """Save the sharded state, restore it onto (4, 2) and onto one device:
    the largest difference of each from the state (0 when bitwise)."""
    checkpoint.save(ckpt_dir, 3, state)
    want = {p: t.full_tensor() for p, t in tree_paths(state)}
    onto = sharding.shardings(state, sspecs, mesh42)
    moved, step = checkpoint.restore(ckpt_dir, state, shardings=onto)
    plain = tree_map(lambda t: torch.zeros(t.shape, dtype=t.dtype), state)
    alone, _ = checkpoint.restore(ckpt_dir, plain)
    res = {"step": step, "mesh42": 0.0, "one": 0.0, "placed": True}
    wanted = dict(zip((p for p, _ in tree_paths(state)), checkpoint._along(state, onto)))
    for (p, a), (_, b) in zip(tree_paths(moved), tree_paths(alone)):
        res["placed"] &= a.device_mesh is mesh42 and tuple(a.placements) == wanted[p][1]
        res["mesh42"] = max(res["mesh42"], _diff(a.full_tensor(), want[p]))
        res["one"] = max(res["one"], _diff(b, want[p]))
    return res


def _diff(a: torch.Tensor, b: torch.Tensor) -> float:
    if a.dtype != b.dtype:
        return float("inf")
    return float((a.double() - b.double()).abs().max()) if a.numel() else 0.0


def psum(mesh24, gs: np.ndarray, n_steps: int) -> dict:
    group = mesh24.get_group("model")
    r = mesh24.get_local_rank("model")
    err = None
    outs, errs = [], []
    for t in range(n_steps):
        g = {"g": torch.from_numpy(gs[r] * (t + 1))}
        out, err = compression.compressed_psum(g, group, err)
        outs.append(out["g"].numpy().copy())
        errs.append(err["g"].numpy().copy())
    return {"model_rank": r, "outs": outs, "errs": errs}


def pipe(mesh8, ws: np.ndarray, xs: np.ndarray) -> np.ndarray:
    sid = mesh8.get_local_rank("stage")
    mine = {"w": torch.from_numpy(ws[sid:sid + 1])}  # only this stage's slice
    return pipeline.pipeline_apply(lambda p, x: torch.tanh(x @ p["w"]), mine,
                                   torch.from_numpy(xs), mesh8).numpy()


def main(rank: int, in_dir: str) -> dict:
    inp = load(in_dir)
    mesh24 = make_mesh((2, 4), ("data", "model"), device="cpu")
    mesh42 = make_mesh((4, 2), ("data", "model"), device="cpu")
    mesh8 = make_mesh((8,), ("stage",), device="cpu")
    pc = from_mesh(mesh24)
    res = {"forward": {name: forward(pc, case) for name, case in inp["forward"].items()}}
    res["train"] = {}
    for name, case in inp["train"].items():
        res["train"][name], last = train(pc, case, inp["train_steps"])
        if name == inp["reshard"]:
            res["reshard"] = reshard(*last, os.path.join(in_dir, "ckpt"), mesh42)
    res["decode"] = decode(pc, inp["decode"])
    res["psum"] = psum(mesh24, inp["psum"], inp["psum_steps"])
    res["pipeline"] = pipe(mesh8, inp["pipeline"]["ws"], inp["pipeline"]["xs"])
    if rank:  # the whole results once; every rank's own pieces
        res = {"psum": res["psum"], "reshard": res["reshard"],
               "pipeline": res["pipeline"]}
    return res
