"""Mesh construction over ``torch.distributed``. Counterpart of
``repro/launch/mesh.py``.

Functions, so importing this module touches no process group. Every mesh
is a ``DeviceMesh`` over the default process group, whose world size must
equal the mesh's size; ``init_world`` starts that group. The reference's
``mesh_context`` (``jax.set_mesh``) has no counterpart: a DTensor carries
its mesh, and the ``ParallelCtx`` carries it into the model code.

The backend follows one rule, never a failure: NCCL when every rank has a
GPU of its own; when ranks share a card (NCCL refuses two ranks on one
device), gloo with every CUDA tensor of a collective staged through host
memory, explicitly and counted (``parallel.staging``); plain gloo on the
CPU.
"""
from __future__ import annotations

import datetime
import logging
import os
import pickle
import tempfile
import time
import traceback

import torch
import torch.distributed as dist
import torch.multiprocessing as mp
from torch.distributed.device_mesh import init_device_mesh

from repro_torch.parallel import staging


def host_device_counts() -> int:
    return torch.cuda.device_count()


def backend_for(world_size: int, device: str) -> str:
    """"nccl" when ``device`` is the card and the host has a GPU for each of
    ``world_size`` ranks; "gloo_staged" (``parallel.staging``) when they
    share the card; "gloo" on the CPU."""
    if torch.device(device).type != "cuda":
        return "gloo"
    return "nccl" if host_device_counts() >= world_size else staging.NAME


def rank_device(device: str, rank: int, world_size: int) -> torch.device:
    """The device rank ``rank`` computes on: its own GPU under NCCL, the
    first GPU when ranks share one, or the CPU."""
    if torch.device(device).type != "cuda":
        return torch.device("cpu")
    if not torch.cuda.is_available():
        raise RuntimeError("device 'cuda' was asked for, and this host has no GPU")
    if backend_for(world_size, device) == "nccl":
        return torch.device("cuda", rank)
    return torch.device("cuda", 0)


def init_world(rank: int, world_size: int, device: str, *, store=None,
               init_method: str | None = None, timeout_s: float = 300.0) -> str:
    """Start the default process group for ``rank`` of ``world_size`` with
    the backend ``backend_for`` names, and make the rank's device current.
    Returns the backend."""
    backend = backend_for(world_size, device)
    dev = rank_device(device, rank, world_size)
    if backend == staging.NAME:
        staging.register()
    if dev.type == "cuda":
        torch.cuda.set_device(dev)
    kw = dict(backend=backend, rank=rank, world_size=world_size,
              timeout=datetime.timedelta(seconds=timeout_s))
    if store is not None:
        kw["store"] = store
    elif init_method is not None:
        kw["init_method"] = init_method
    dist.init_process_group(**kw)
    return backend


def make_mesh(shape: tuple[int, ...], axes: tuple[str, ...], *, device: str = "cuda"):
    """A mesh of ``shape`` named ``axes`` over the default process group,
    on the card unless ``device="cpu"``."""
    dev = torch.device(device).type
    if dev == "cuda" and not torch.cuda.is_available():
        raise RuntimeError("device 'cuda' was asked for, and this host has no GPU")
    return init_device_mesh(dev, tuple(shape), mesh_dim_names=tuple(axes))


def make_production_mesh(*, multi_pod: bool = False, device: str = "cuda"):
    """Single pod: 16×16 = 256 ranks, axes (data, model). Multi-pod: 2 pods
    × 256 = 512, axes (pod, data, model)."""
    shape = (2, 16, 16) if multi_pod else (16, 16)
    axes = ("pod", "data", "model") if multi_pod else ("data", "model")
    return make_mesh(shape, axes, device=device)


def run_world(fn, world_size: int, device: str, *args, timeout_s: float = 300.0,
              threads: int | None = 1) -> list:
    """``fn(rank, *args)`` on each of ``world_size`` spawned ranks, in a world
    started by ``init_world`` (rendezvous through a ``FileStore`` in a
    temporary directory): the list of the ranks' results, in rank order.
    ``fn`` must be a module-level function and its results picklable.

    Every rank has a deadline: a rank still running after ``timeout_s`` (a
    hang), or any rank that fails, ends the whole world, and this raises
    with the failed ranks' tracebacks. ``threads`` sets each rank's torch
    threads."""
    ctx = mp.get_context("spawn")
    with tempfile.TemporaryDirectory(prefix="repro-torch-world-") as d:
        procs = [ctx.Process(target=_rank_entry, daemon=True,
                             args=(fn, r, world_size, device, d, threads, timeout_s, args))
                 for r in range(world_size)]
        for p in procs:
            p.start()
        deadline = time.monotonic() + timeout_s
        try:
            while any(p.is_alive() for p in procs):
                if any(p.exitcode not in (None, 0) for p in procs):
                    break
                if time.monotonic() > deadline:
                    hung = [r for r, p in enumerate(procs) if p.is_alive()]
                    raise TimeoutError(f"ranks {hung} of {world_size} still running "
                                       f"after {timeout_s:.0f} s")
                time.sleep(0.2)
        finally:
            for p in procs:
                if p.is_alive():
                    p.kill()
            for p in procs:
                p.join()
        errors = []
        for r, p in enumerate(procs):
            err = os.path.join(d, f"{r}.err")
            if os.path.exists(err):
                with open(err) as f:
                    errors.append(f"rank {r}:\n{f.read()}")
            elif p.exitcode != 0:
                errors.append(f"rank {r}: exit code {p.exitcode}")
        if errors:
            raise RuntimeError("world failed:\n" + "\n".join(errors))
        out = []
        for r in range(world_size):
            with open(os.path.join(d, f"{r}.out"), "rb") as f:
                out.append(pickle.load(f))
        return out


def _rank_entry(fn, rank, world_size, device, d, threads, timeout_s, args):
    if threads is not None:
        torch.set_num_threads(threads)
    # DTensor's hints on fusing sequential reductions, once per call per rank
    logging.getLogger("torch.distributed.tensor").setLevel(logging.ERROR)
    try:
        store = dist.FileStore(os.path.join(d, "store"), world_size)
        init_world(rank, world_size, device, store=store, timeout_s=timeout_s)
        try:
            result = fn(rank, *args)
        finally:
            dist.destroy_process_group()
        with open(os.path.join(d, f"{rank}.out"), "wb") as f:
            pickle.dump(result, f)
    except BaseException:
        with open(os.path.join(d, f"{rank}.err"), "w") as f:
            f.write(traceback.format_exc())
        raise SystemExit(1)
