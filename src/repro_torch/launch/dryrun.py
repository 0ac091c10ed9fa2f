"""Dry run: trace every (architecture × input shape × mesh) cell's step,
shape only, as one rank of the production mesh, and record its FLOPs,
bytes, collectives and memory for the roofline table. Counterpart of
``repro/launch/dryrun.py``.

    python -m repro_torch.launch.dryrun --arch qwen3-1.7b --shape train_4k
    python -m repro_torch.launch.dryrun --all --both-meshes [--out results/dryrun]

The reference lowers and compiles each step for 512 fake XLA host devices
(its first lines set ``XLA_FLAGS`` before JAX starts); this module sets no
environment. A cell starts a world of ``num_devices`` ranks over a fake
process group (``fake_world``: collectives that move nothing), builds the
production mesh on it (16×16, or 2×16×16), and runs the step that
``train.steps`` builds with that ``ParallelCtx`` as rank 0, under
``FakeTensorMode``: parameters, optimizer state, cache and batch are fake
tensors (shapes, dtypes and strides, no storage) placed by the step's spec
trees. ``--device cuda`` (the default) traces fake CUDA tensors, on which
the kernels K2–K4 run their custom ops' fake implementations, as the card
would run the kernels; ``--device cpu`` traces the plain versions on a CPU
mesh, whose gloo has no all-to-all, so DTensor shards some ops otherwise
than on the card: plan with ``cuda`` records.

``StepCounter``, a dispatch mode under DTensor, reads what the rank's own
local tensors do, op by op:

* ``flops``: ``torch.utils.flop_counter``'s formulas (the kernels' ops
  count what their plain versions count);
* ``bytes``: every op's tensor inputs and outputs (an in-place op's output
  once), views excepted: eager PyTorch runs each op as its own kernel;
* collectives: every functional collective, by HLO name, its local result
  bytes and group size, and its wire bytes by ``roofline.wire_bytes``, the
  ring model ``roofline.parse_collectives`` uses;
* memory: the arguments' and outputs' bytes, and the peak of the bytes the
  step allocated and still holds, as ``temp_size_in_bytes``.

The same counter read on a real run (the card, or a gloo world) gives the
numbers the trace predicts: ``chip_smoke.py`` holds the two against each
other.

A trace runs every layer, so a record's ``cost_analysis`` and
``collectives`` are the full trace's counts. The reference's loop
calibration (``reconstruct``: XLA counts a scanned loop body once) is kept
with its algebra unchanged, and a single-pod record carries its result as
``reconstruction`` (``--no-calibrate`` skips it): alone it gives back the
trace's counts, but on a mesh DTensor picks each op's sharding by its
shapes, so there they are not affine in layers and microbatches. XLA's
``generated_code_size_in_bytes`` and ``compile_s`` have no counterpart;
``lower_s`` is the trace's wall time.
"""
from __future__ import annotations

import argparse
import contextlib
import dataclasses
import json
import os
import threading
import time
import traceback
import weakref

import torch
import torch.distributed as dist
from torch.distributed.tensor import DTensor
from torch.distributed.tensor._utils import compute_local_shape_and_global_offset
from torch.utils import _pytree as pytree
from torch.utils._python_dispatch import TorchDispatchMode
from torch.utils.flop_counter import flop_registry

from repro_torch import configs
from repro_torch.common import tree_map
from repro_torch.config import SHAPES, RunConfig
from repro_torch.launch import roofline
from repro_torch.launch.mesh import make_production_mesh
from repro_torch.parallel import ctx as pctx
from repro_torch.parallel import sharding
from repro_torch.train import steps as steps_lib
from repro_torch.train.optim import make_optimizer

#: functional collectives (``torch.ops._c10d_functional``, and DTensor's
#: ``torch.ops._dtensor.shard_dim_alltoall``, its all-to-all on a mesh
#: whose backend has one) by the HLO name the reference's records use
COLLECTIVES = {
    "all_reduce": "all-reduce", "all_reduce_coalesced": "all-reduce",
    "all_gather_into_tensor": "all-gather",
    "all_gather_into_tensor_coalesced": "all-gather",
    "reduce_scatter_tensor": "reduce-scatter",
    "reduce_scatter_tensor_coalesced": "reduce-scatter",
    "all_to_all_single": "all-to-all", "shard_dim_alltoall": "all-to-all",
}
_COMM_NAMESPACES = ("_c10d_functional", "_c10d_functional_autograd", "c10d")
#: ops of those namespaces that move nothing: a wait on a collective, and
#: the wrapper a real run puts around one's result
_COMM_WAITS = ("wait_tensor", "_wrap_tensor_autograd")

_LOCAL = threading.local()


def _in_bookkeeping() -> bool:
    return getattr(_LOCAL, "bookkeeping", 0) > 0


def _bookkeeping(fn, host: bool):
    """``fn`` marked as DTensor's own bookkeeping, which ``StepCounter``
    leaves out; with ``host``, run on real tensors (outside any fake mode):
    it reads index tensors back as values."""
    from torch._subclasses.fake_tensor import unset_fake_temporarily

    def marked(*args, **kwargs):
        _LOCAL.bookkeeping = getattr(_LOCAL, "bookkeeping", 0) + 1
        try:
            with unset_fake_temporarily() if host else contextlib.nullcontext():
                return fn(*args, **kwargs)
        finally:
            _LOCAL.bookkeeping -= 1

    return marked


#: DTensor's modules that ask whether a compiler is tracing
_TRACING_ASKED = ("_collective_utils", "_decompositions", "_dispatch", "_redistribute",
                  "_sharding_prop", "placement_types")


@contextlib.contextmanager
def _as_a_real_run():
    """While it is open, DTensor does under a fake mode what it does in a
    real run. Its bookkeeping is marked (``_bookkeeping``): the sharding
    propagation of an op (its strategies, and its global output shape, the
    op run once on fake global-shaped tensors, which no rank runs) and the
    index arithmetic of a dim split over several mesh axes (small index
    tensors read back as values). And it does not take the fake mode for a
    compiler's trace, for which it plans sharding and redistributions
    afresh, where a real run takes them from its caches (a cached plan can
    take other collectives)."""
    import importlib

    from torch.distributed.tensor import _utils, placement_types
    from torch.distributed.tensor._sharding_prop import ShardingPropagator

    targets = [(ShardingPropagator, "propagate_op_sharding_non_cached", False),
               (ShardingPropagator, "_propagate_tensor_meta_non_cached", False),
               (placement_types._StridedShard, "local_shard_size_and_offset", True),
               (_utils, "_get_shard_size_and_offsets", True),
               (_utils, "_get_first_offset", True)]
    saved = [(owner, name, getattr(owner, name)) for owner, name, _ in targets]
    for owner, name, host in targets:
        setattr(owner, name, _bookkeeping(getattr(owner, name), host))
    for mod in _TRACING_ASKED:
        mod = importlib.import_module(f"torch.distributed.tensor.{mod}")
        if hasattr(mod, "_are_we_tracing"):
            saved.append((mod, "_are_we_tracing", mod._are_we_tracing))
            mod._are_we_tracing = _not_tracing
    try:
        yield
    finally:
        for owner, name, orig in saved:
            setattr(owner, name, orig)


def _not_tracing() -> bool:
    return False


def _nbytes(t: torch.Tensor) -> int:
    return t.numel() * t.element_size()


def _tensors(tree) -> list[torch.Tensor]:
    return [t for t in pytree.tree_leaves(tree) if isinstance(t, torch.Tensor)]


def _group_size(name: str) -> int:
    return dist.distributed_c10d._resolve_process_group(name).size()


class StepCounter(TorchDispatchMode):
    """What one rank's local ops do while it is open (see the module
    docstring): ``flops``, ``bytes``, ``coll_counts``/``coll_result``/
    ``coll_wire`` by HLO collective name, and with ``arguments`` and
    ``outputs`` called around the step, ``memory_analysis()``. An op on a
    DTensor is handed to DTensor, whose local ops come back here."""

    def __init__(self):
        super().__init__()
        self.flops = 0
        self.bytes = 0
        self.coll_counts: dict = {}
        self.coll_result: dict = {}
        self.coll_wire: dict = {}
        self._args: dict[int, int] = {}  # storage id -> bytes
        self._live: dict[int, int] = {}
        self.live = self.peak = 0
        self.output_bytes = self.alias_bytes = 0
        self._patches = contextlib.ExitStack()

    def __enter__(self):
        self._patches.enter_context(_as_a_real_run())
        return super().__enter__()

    def __exit__(self, *exc):
        try:
            return super().__exit__(*exc)
        finally:
            self._patches.close()

    # -- memory -----------------------------------------------------------

    @staticmethod
    def _storages(tree) -> dict[int, torch.UntypedStorage]:
        out = {}
        for t in _tensors(tree):
            if isinstance(t, DTensor):
                t = t.to_local()
            st = t.untyped_storage()
            out[id(st)] = st
        return out

    def arguments(self, tree) -> None:
        """The step's arguments: live before and through the step."""
        for key, st in self._storages(tree).items():
            self._args[key] = st.nbytes()

    def outputs(self, tree) -> None:
        """The step's outputs: their bytes, and those that alias an
        argument's storage."""
        for key, st in self._storages(tree).items():
            self.output_bytes += st.nbytes()
            if key in self._args:
                self.alias_bytes += st.nbytes()

    def memory_analysis(self) -> dict:
        return {"argument_size_in_bytes": sum(self._args.values()),
                "output_size_in_bytes": self.output_bytes,
                "temp_size_in_bytes": self.peak,
                "alias_size_in_bytes": self.alias_bytes}

    def _free(self, key: int) -> None:
        self.live -= self._live.pop(key, 0)

    def _allocated(self, outs) -> None:
        for t in outs:
            st = t.untyped_storage()
            key = id(st)
            if key in self._args or key in self._live:
                continue
            self._live[key] = st.nbytes()
            self.live += st.nbytes()
            weakref.finalize(st, self._free, key)
        self.peak = max(self.peak, self.live)

    # -- dispatch ---------------------------------------------------------

    def __torch_dispatch__(self, func, types, args=(), kwargs=None):
        kwargs = kwargs or {}
        if any(issubclass(t, DTensor) for t in types):
            return NotImplemented
        out = func(*args, **kwargs)
        if _in_bookkeeping():
            return out
        outs = _tensors(out)
        if not outs or func.is_view:
            return out
        name = func._opname
        if func.namespace in _COMM_NAMESPACES or name in COLLECTIVES:
            if name in _COMM_WAITS:
                return out
            if name not in COLLECTIVES:
                raise NotImplementedError(f"the dry run does not count {func}")
            self._collective(COLLECTIVES[name], outs, kwargs.get("group_name", args[-1]))
        ins = _tensors((args, kwargs))
        seen = {id(t) for t in ins}
        self.bytes += sum(_nbytes(t) for t in ins) + sum(
            _nbytes(t) for t in outs if id(t) not in seen)
        formula = flop_registry.get(func._overloadpacket)
        if formula is not None:
            self.flops += formula(*args, **kwargs, out_val=out)
        self._allocated(outs)
        return out

    def _collective(self, op: str, outs, group: str) -> None:
        b = sum(_nbytes(t) for t in outs)
        g = _group_size(group)
        self.coll_counts[op] = self.coll_counts.get(op, 0) + 1
        self.coll_result[op] = self.coll_result.get(op, 0) + b
        self.coll_wire[op] = self.coll_wire.get(op, 0) + roofline.wire_bytes(op, b, g)

    def result(self) -> dict:
        """The reference's measurement keys."""
        return {"flops": float(self.flops), "bytes": float(self.bytes),
                "coll_wire": dict(self.coll_wire), "coll_counts": dict(self.coll_counts),
                "coll_result": dict(self.coll_result)}


# ---------------------------------------------------------------------------
# The fake world and the trace
# ---------------------------------------------------------------------------


@contextlib.contextmanager
def fake_world(world_size: int):
    """A default process group of ``world_size`` ranks over the fake
    backend (every collective returns at once and moves nothing), as rank
    0; destroyed on exit. Raises if a process group is already started, so
    a real world is never touched."""
    from torch.testing._internal.distributed.fake_pg import FakeStore

    if dist.is_initialized():
        raise RuntimeError("a process group is already started; the dry run's fake world "
                           "needs a process of its own")
    dist.init_process_group("fake", store=FakeStore(), rank=0, world_size=world_size)
    try:
        yield
    finally:
        dist.destroy_process_group()


@dataclasses.dataclass(frozen=True)
class _Leaf:
    """One argument of the step: its meta stand-in and, on a mesh, its
    placements and this rank's local shape."""
    meta: torch.Tensor
    placements: tuple = ()
    local: tuple = ()


def placed(tree, specs, mesh):
    """``tree``'s meta tensors as the ``_Leaf``s that ``trace`` takes,
    placed by ``specs`` on ``mesh`` (no mesh: whole). The local shapes are
    computed here, outside any fake mode: DTensor reads the mesh's
    coordinates as values."""
    if mesh is None:
        return tree_map(_Leaf, tree)

    def one(path, t, spec):
        pctx.check_even(t.shape, spec, mesh)
        pl = pctx.placements(spec, mesh)
        local, _ = compute_local_shape_and_global_offset(t.shape, mesh, pl)
        return _Leaf(t, pl, tuple(local))

    return sharding.tree_map_with_path_str(one, tree, specs)


def _materialised(tree, mesh, device: str):
    """Fake tensors on ``device`` for the ``_Leaf``s of ``tree``: this
    rank's shards as DTensors on ``mesh``, or whole (call under a
    FakeTensorMode)."""

    def one(leaf):
        if not isinstance(leaf, _Leaf):
            return leaf
        t = leaf.meta
        if mesh is None:
            return torch.empty(t.shape, dtype=t.dtype, device=device)
        local = torch.empty(leaf.local, dtype=t.dtype, device=device)
        return DTensor.from_local(local, mesh, leaf.placements, run_check=False, shape=t.shape,
                                  stride=sharding.contiguous_strides(t.shape))

    return tree_map(one, tree)


def _lower(run: RunConfig, pc):
    """The step of this run and its arguments as ``_Leaf`` trees, placed by
    the step's spec trees on ``pc``'s mesh. Returns (step, args)."""
    mode = run.shape.mode
    cfg = run.model
    mesh = None if pc is None else pc.mesh
    aparams = steps_lib.abstract_params(cfg)
    abatch = steps_lib.input_specs(cfg, run.shape)
    if mode == "train":
        step, state_specs, bspecs = steps_lib.make_train_step(run, pc)
        astate = {"params": aparams, "opt": make_optimizer(run.train).init(aparams)}
        return step, (placed(astate, state_specs, mesh), placed(abatch, bspecs, mesh))
    if mode == "prefill":
        step, pspecs, bspecs = steps_lib.make_prefill_step(run, pc)
        return step, (placed(aparams, pspecs, mesh), placed(abatch, bspecs, mesh))
    step, pspecs, cspecs, bspecs = steps_lib.make_decode_step(run, pc)
    acache = steps_lib.abstract_cache(cfg, run.shape, run.serve.kv_dtype)
    tokens = placed({"tokens": abatch["tokens"]}, bspecs, mesh)["tokens"]
    # the step's work is the same at every position of the cache: the last
    return step, (placed(aparams, pspecs, mesh), placed(acache, cspecs, mesh), tokens,
                  run.shape.seq_len - 1)


def _measure(run: RunConfig, pc, want_mem: bool = False, device: str = "cuda") -> dict:
    """One shape-only trace of the step (see the module docstring): the
    reference's measurement keys, ``lower_s`` (the trace's wall time) and
    with ``want_mem`` the ``memory_analysis``. ``pc``'s mesh sets the
    device; ``device`` does without one."""
    step, leaves = _lower(run, pc)
    return trace(step, leaves, None if pc is None else pc.mesh, device, want_mem)


def trace(fn, leaves, mesh, device: str, want_mem: bool = False) -> dict:
    """``fn(*args)`` traced shape only as rank 0 of ``mesh`` (or alone),
    ``args`` fake tensors on the mesh's device (or ``device``) for the
    ``_Leaf`` trees (``leaves``, from ``placed``), under a ``StepCounter``:
    its ``result()``, ``lower_s`` and with ``want_mem`` its
    ``memory_analysis``."""
    from torch._subclasses.fake_tensor import FakeTensorMode

    if mesh is not None:
        device = mesh.device_type
    with FakeTensorMode():
        args = _materialised(leaves, mesh, device)
        counter = StepCounter()
        counter.arguments(args)
        t0 = time.monotonic()
        with counter:
            out = fn(*args)
        lower_s = time.monotonic() - t0
        counter.outputs(out)
        del out, args
    res = dict(counter.result(), lower_s=lower_s)
    if want_mem:
        res["memory_analysis"] = counter.memory_analysis()
    return res


# ---------------------------------------------------------------------------
# The reference's loop calibration (its algebra, unchanged)
# ---------------------------------------------------------------------------


def _combine_dicts(ds: list[dict], coeffs: list[float]) -> dict:
    keys = set()
    for d in ds:
        keys |= set(d)
    out = {}
    for k in keys:
        # intermediate results may legitimately be negative (corrections);
        # the final totals are clamped in reconstruct()
        out[k] = sum(c * d.get(k, 0.0) for c, d in zip(coeffs, ds))
    return out


def _calib_run(run: RunConfig, layers: int, micro: int, every: int | None = None):
    """A reduced, fully-unrolled variant for cost calibration."""
    cfg = run.model
    kw = dict(num_layers=layers, unroll_scans=True)
    if every is not None:
        kw["hybrid_attn_every"] = every
    # cap unrolled chunk-scan lengths (keeps calibration compiles tractable;
    # FLOPs are unchanged — only the chunking granularity moves)
    s = run.shape.seq_len
    if s // cfg.attn_chunk > 128:
        kw["attn_chunk"] = -(-s // 128)
    if cfg.ssm_state and s // cfg.ssm_chunk > 128:
        kw["ssm_chunk"] = -(-s // 128)
    new_model = cfg.scaled(**kw)
    new_train = dataclasses.replace(run.train, microbatches=micro)
    return dataclasses.replace(run, model=new_model, train=new_train)


def _lc(ms: list[dict], coeffs: list[float]) -> dict:
    """Linear combination over measurement vectors (flops, bytes, wire)."""
    return {
        "flops": sum(c * m["flops"] for c, m in zip(coeffs, ms)),
        "bytes": sum(c * m["bytes"] for c, m in zip(coeffs, ms)),
        "coll_wire": _combine_dicts(
            [m["coll_wire"] for m in ms], coeffs
        ),
    }


def reconstruct(run: RunConfig, pc, verbose: bool = True, device: str = "cuda") -> dict:
    """Calibrate + reconstruct true per-step totals (flops / bytes / wire).

    Cost structure (affine in L, k, and L*k):
        f(L, k) = base + k*mb + L*act + k*L*w
    where ``act`` is token-total-proportional per-layer work (invariant in k —
    microbatches split the same tokens) and ``w`` is per-layer per-microbatch
    fixed work (FSDP weight all-gathers, weight reads). Hybrids split the
    layer terms into mamba vs shared-attention components (6-point system).
    A trace runs every layer, so the totals equal the full trace's.
    """
    cfg = run.model
    mode = run.shape.mode
    k = run.train.microbatches if mode == "train" else 1
    is_hybrid = cfg.family == "hybrid"

    def meas(layers, micro, every=None):
        r = _calib_run(run, layers, micro, every)
        m = _measure(r, pc, device=device)
        if verbose:
            print(
                f"  [calib] L={layers} k={micro} every={every}: "
                f"{m['flops']:.3e}F {m['bytes']:.3e}B ({m['lower_s']:.0f}s)",
                flush=True,
            )
        return m

    zero = {"flops": 0.0, "bytes": 0.0, "coll_wire": {}}
    if not is_hybrid:
        m11 = meas(1, 1)
        m21 = meas(2, 1)
        if mode == "train" and k > 1:
            m12 = meas(1, 2)
            m22 = meas(2, 2)
            w = _lc([m22, m12, m21, m11], [1, -1, -1, 1])
            act = _lc([m21, m11, w], [1, -1, -1])
            mb = _lc([m12, m11, w], [1, -1, -1])
            base = _lc([m11, mb, act, w], [1, -1, -1, -1])
        else:
            w = zero
            act = _lc([m21, m11], [1, -1])
            mb = zero
            base = _lc([m11, act], [1, -1])
        L = cfg.num_layers
        total = _lc([base, mb, act, w], [1, k, L, k * L])
    else:
        m111 = meas(1, 1, every=1)
        m221 = meas(2, 1, every=2)
        m211 = meas(2, 1, every=1)
        if mode == "train" and k > 1:
            m112 = meas(1, 2, every=1)
            m222 = meas(2, 2, every=2)
            m212 = meas(2, 2, every=1)
            a1 = _lc([m221, m111], [1, -1])       # am + wm
            a2 = _lc([m222, m112], [1, -1])       # am + 2wm
            wm = _lc([a2, a1], [1, -1])
            am = _lc([a1, wm], [1, -1])
            b1 = _lc([m211, m221], [1, -1])       # aa + wa
            b2 = _lc([m212, m222], [1, -1])       # aa + 2wa
            wa = _lc([b2, b1], [1, -1])
            aa = _lc([b1, wa], [1, -1])
            mb = _lc([m112, m111, wm, wa], [1, -1, -1, -1])
            base = _lc([m111, mb, am, wm, aa, wa], [1, -1, -1, -1, -1, -1])
        else:
            am = _lc([m221, m111], [1, -1])
            aa = _lc([m211, m221], [1, -1])
            wm = zero
            wa = zero
            mb = zero
            base = _lc([m111, am, aa], [1, -1, -1])
        n_m = cfg.num_layers
        n_a = cfg.num_layers // cfg.hybrid_attn_every
        total = _lc(
            [base, mb, am, wm, aa, wa],
            [1, k, n_m, k * n_m, n_a, k * n_a],
        )
    return {
        "flops": float(max(total["flops"], 0.0)),
        "bytes accessed": float(max(total["bytes"], 0.0)),
        "wire_bytes": {kk: float(max(v, 0.0))
                       for kk, v in total["coll_wire"].items()},
    }


# ---------------------------------------------------------------------------
# Cells and the CLI
# ---------------------------------------------------------------------------


def dryrun_cell(
    arch: str,
    shape_name: str,
    multi_pod: bool = False,
    extra_overrides: dict | None = None,
    calibrate: bool = True,
    verbose: bool = True,
    device: str = "cuda",
) -> dict:
    """Trace one cell (and its calibration variants) in a fake world of its
    own; the reference's record."""
    cfg = configs.get(arch)
    applicability = configs.applicable_shapes(cfg)[shape_name]
    base = {
        "arch": arch,
        "shape": shape_name,
        "mesh": "2x16x16" if multi_pod else "16x16",
        "num_devices": 512 if multi_pod else 256,
    }
    if applicability != "ok":
        return dict(base, status=applicability)

    run = configs.make_run(arch, shape_name, multi_pod=multi_pod,
                           **(extra_overrides or {}))
    with fake_world(base["num_devices"]):
        mesh = make_production_mesh(multi_pod=multi_pod, device=device)
        pc = pctx.from_mesh(mesh, multi_pod=multi_pod, fsdp=run.mesh.fsdp_params,
                            tp=run.mesh.tp)
        real = _measure(run, pc, want_mem=True)
        record = dict(
            base,
            status="ok",
            lower_s=real["lower_s"],
            memory_analysis=real["memory_analysis"],
            raw_cost={"flops": real["flops"], "bytes accessed": real["bytes"]},
            raw_collectives={
                "counts": real["coll_counts"],
                "result_bytes": real["coll_result"],
                "wire_bytes": real["coll_wire"],
            },
            config={
                "microbatches": run.train.microbatches,
                "remat": run.train.remat,
                "kv_dtype": run.serve.kv_dtype,
                "fsdp": run.mesh.fsdp_params,
                "optimizer": run.train.optimizer,
                "attn_impl": run.model.attn_impl,
                "shard_cache_seq": run.serve.shard_cache_seq,
            },
        )
        if not multi_pod:
            # the trace's counts are the step's (it runs every layer); the
            # reference's reconstruction is kept beside them: on a mesh
            # DTensor picks each op's sharding by its shapes, so the counts
            # are not affine in layers and microbatches (PERF.md)
            if calibrate:
                record["reconstruction"] = reconstruct(run, pc, verbose=verbose)
            record["cost_analysis"] = {
                "flops": real["flops"],
                "bytes accessed": real["bytes"],
            }
            record["collectives"] = {
                "counts": real["coll_counts"],
                "result_bytes": real["coll_result"],
                "wire_bytes": real["coll_wire"],
            }
            record["roofline"] = roofline.analyze(record, run.model, run.shape)
    if verbose:
        mm = record["memory_analysis"]
        msg = (
            f"[dryrun] {arch} {shape_name} {record['mesh']}: "
            f"args={mm.get('argument_size_in_bytes', 0)/2**30:.2f}GiB "
            f"temp={mm.get('temp_size_in_bytes', 0)/2**30:.2f}GiB "
            f"(trace {record['lower_s']:.1f}s)"
        )
        if "roofline" in record:
            rl = record["roofline"]
            msg += (
                f" compute={rl['compute_s']*1e3:.2f}ms mem={rl['memory_s']*1e3:.2f}ms"
                f" coll={rl['collective_s']*1e3:.2f}ms dom={rl['dominant']}"
                f" useful={rl['useful_flops_ratio']:.3f}"
                f" roofline_frac={rl['roofline_fraction']:.3f}"
            )
        print(msg, flush=True)
    return record


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--arch", type=str, default=None)
    ap.add_argument("--shape", type=str, default=None,
                    choices=list(SHAPES) + [None])
    ap.add_argument("--multi-pod", action="store_true")
    ap.add_argument("--both-meshes", action="store_true")
    ap.add_argument("--all", action="store_true")
    ap.add_argument("--out", type=str, default="results/dryrun")
    ap.add_argument("--no-calibrate", action="store_true")
    ap.add_argument("--skip-existing", action="store_true")
    ap.add_argument("--device", default="cuda", choices=("cuda", "cpu"),
                    help="the fake tensors' device: cuda traces the kernels' fake "
                         "implementations, cpu the plain versions (default cuda)")
    args = ap.parse_args(argv)

    os.makedirs(args.out, exist_ok=True)
    archs = configs.ARCHS if (args.all or not args.arch) else [args.arch]
    shapes = list(SHAPES) if (args.all or not args.shape) else [args.shape]
    meshes = [False, True] if args.both_meshes else [args.multi_pod]

    failures = []
    for arch in archs:
        for shape in shapes:
            for mp in meshes:
                tag = f"{configs.ALIASES.get(arch, arch)}_{shape}_" + (
                    "multi" if mp else "single")
                path = os.path.join(args.out, tag + ".json")
                if args.skip_existing and os.path.exists(path):
                    print(f"[dryrun] skip existing {tag}", flush=True)
                    continue
                try:
                    rec = dryrun_cell(arch, shape, multi_pod=mp,
                                      calibrate=not args.no_calibrate, device=args.device)
                except Exception as e:  # a failure here is a bug in the system
                    traceback.print_exc()
                    rec = {
                        "arch": arch, "shape": shape,
                        "mesh": "2x16x16" if mp else "16x16",
                        "status": f"FAILED: {type(e).__name__}: {e}",
                    }
                    failures.append(tag)
                with open(path, "w") as f:
                    json.dump(rec, f, indent=1)
    if failures:
        print(f"[dryrun] FAILURES: {failures}", flush=True)
        raise SystemExit(1)
    print("[dryrun] all cells OK", flush=True)


if __name__ == "__main__":
    main()
