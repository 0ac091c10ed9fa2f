"""ParallelCtx: the static description of how a model call is distributed,
over a ``torch.distributed`` DeviceMesh. Counterpart of
``repro/parallel/ctx.py``.

Threaded from the launcher into model code. ``None`` means one device (the
smoke tests, the reference paths). A spec is a ``P``: one entry per tensor
dim, each a mesh axis name, a tuple of names (the dim split over several
axes, major to minor) or ``None``; ``placements`` turns it into DTensor
placements, one per mesh dim, and ``constrain`` redistributes a DTensor
onto it (the counterpart of ``with_sharding_constraint``).
"""
from __future__ import annotations

import dataclasses
from typing import Any, Optional

import torch
from torch.distributed.tensor import DTensor, Partial, Replicate, Shard
from torch.distributed.tensor.experimental import local_map


class P(tuple):
    """A partition spec: ``P("data", None, "model")``, as jax's
    ``PartitionSpec`` spells it, and equal entry for entry to it."""

    def __new__(cls, *entries):
        return super().__new__(cls, entries)

    def __repr__(self) -> str:
        return f"P{tuple.__repr__(self)}"


def mesh_shape(mesh) -> dict[str, int]:
    """``{axis name: size}`` of a DeviceMesh, or of a stand-in whose
    ``shape`` is already that dict (the spec tests' production meshes)."""
    shape = mesh.shape
    if isinstance(shape, dict):
        return dict(shape)
    return dict(zip(mesh.mesh_dim_names, shape))


@dataclasses.dataclass(frozen=True)
class ParallelCtx:
    mesh: Any
    batch_axes: tuple[str, ...] = ("data",)
    model_axis: str = "model"
    fsdp_params: bool = True
    # tp=False turns the model axis into a second data axis (TP degree 1)
    tp: bool = True

    @property
    def shape(self) -> dict[str, int]:
        return mesh_shape(self.mesh)

    @property
    def model_size(self) -> int:
        return self.shape[self.model_axis] if self.tp else 1

    @property
    def act_model_axis(self):
        """Axis name for model-sharded activations/logits (None if TP off)."""
        return self.model_axis if self.tp else None

    @property
    def batch_size(self) -> int:
        n = 1
        for a in self.batch_axes:
            n *= self.shape[a]
        return n

    @property
    def data_axis(self) -> str:
        """The primary intra-pod data axis (used for FSDP weight gathering)."""
        return self.batch_axes[-1]

    @property
    def all_axes(self) -> tuple[str, ...]:
        return tuple(self.batch_axes) + (self.model_axis,)

    @property
    def batch_entry(self):
        """The spec entry of a batch-sharded dim: one axis name, or the
        tuple of them when there are several."""
        return self.batch_axes if len(self.batch_axes) > 1 else self.batch_axes[0]

    def batch_spec(self, *trailing) -> P:
        return P(self.batch_entry, *trailing)

    def batch_for(self, n: int):
        """The spec entry of an activation's batch dim of size ``n``: the DP
        axes where ``n`` divides their extent, else None. A DP extent of 1
        shards nothing, and leaves the dim replicated (DTensor cannot view
        a size-1 dim sharded)."""
        return self.batch_entry if self.batch_size > 1 and n % self.batch_size == 0 else None


def from_mesh(mesh, multi_pod: bool = False, fsdp: bool = True, tp: bool = True):
    if mesh is None:
        return None
    batch_axes = ("pod", "data") if multi_pod else ("data",)
    if not tp:
        batch_axes = batch_axes + ("model",)
    return ParallelCtx(mesh=mesh, batch_axes=batch_axes, fsdp_params=fsdp, tp=tp)


def _names(entry) -> tuple[str, ...]:
    if entry is None:
        return ()
    return tuple(entry) if isinstance(entry, tuple) else (entry,)


def placements(spec, mesh, partial=(), op: str = "sum") -> tuple:
    """DTensor placements of ``spec`` on ``mesh``, one per mesh dim: a
    tensor dim named by mesh axes is ``Shard`` of that dim on each of them,
    an axis in ``partial`` a pending reduction (``Partial(op)``), the rest
    ``Replicate``. A dim split over several axes names them in mesh order
    (jax's major-to-minor), which DTensor's nested ``Shard``s of one dim
    reproduce."""
    names = tuple(mesh.mesh_dim_names)
    out = [Partial(op) if a in partial else Replicate() for a in names]
    for d, entry in enumerate(spec):
        axes = _names(entry)
        idx = [names.index(a) for a in axes]
        if idx != sorted(idx):
            raise ValueError(f"spec entry {entry} is not in the mesh's order {names}")
        for i in idx:
            if isinstance(out[i], (Shard, Partial)):
                raise ValueError(f"mesh axis {names[i]} shards two dims in {spec}")
            out[i] = Shard(d)
    return tuple(out)


def check_even(shape, spec, mesh) -> None:
    """Every sharded dim divides by the product of its axes' sizes: the
    rules guard on divisibility, so DTensor never pads."""
    sizes = mesh_shape(mesh)
    for d, entry in enumerate(spec):
        n = 1
        for a in _names(entry):
            n *= sizes[a]
        if shape[d] % n:
            raise ValueError(f"dim {d} of {tuple(shape)} does not divide by {n} ({spec})")


def constrain(x, pc: Optional[ParallelCtx], *spec, batch_dim: Optional[int] = None):
    """Redistribute the DTensor ``x`` onto ``spec`` (pending sums reduced,
    shards gathered or split). No-op when pc is None.

    ``batch_dim``: index within spec to replace with the DP axes, but only
    when that dim divides the DP extent (batch=1 decode stays unsharded)."""
    if pc is None:
        return x
    if not isinstance(x, DTensor):
        raise TypeError("constrain takes a DTensor when a ParallelCtx is given")
    spec = list(spec)
    if batch_dim is not None:
        spec[batch_dim] = pc.batch_for(x.shape[batch_dim])
    check_even(x.shape, spec, pc.mesh)
    return x.redistribute(pc.mesh, placements(spec, pc.mesh))


def batch_input(x: torch.Tensor, pc: Optional[ParallelCtx]):
    """A model input as a DTensor sharded by batch (where the batch divides)
    when a ParallelCtx is given; a plain tensor is taken as the whole batch,
    the same on every rank."""
    if pc is None:
        return x
    if not isinstance(x, DTensor):
        x = replicated(x, pc)
    return constrain(x, pc, *([None] * x.ndim), batch_dim=0)


def replicated(x: torch.Tensor, pc: ParallelCtx) -> DTensor:
    """A tensor every rank holds whole (the same values on each) as a
    replicated DTensor, without communication."""
    return DTensor.from_local(x, pc.mesh, [Replicate()] * pc.mesh.ndim, run_check=False)


class Sum(P):
    """A spec whose value is the reduction (``op``: a sum unless said) over
    the mesh axes ``axes`` of what each rank holds (a ``Partial`` placement
    on each)."""

    def __new__(cls, spec, axes, op: str = "sum"):
        self = tuple.__new__(cls, spec)
        self.axes, self.op = tuple(axes), op
        return self


def _pl(spec, mesh):
    if spec is None:
        return None
    return placements(spec, mesh, getattr(spec, "axes", ()), getattr(spec, "op", "sum"))


def shard_map(fn, pc: ParallelCtx, in_specs, out_specs, grad_specs=None):
    """``fn`` on each rank's local pieces, the counterpart of the
    reference's ``shard_map``: each DTensor argument is redistributed onto
    its spec of ``in_specs`` (a ``None`` spec passes the argument as it is)
    and handed to ``fn`` as its local tensor; ``fn``'s outputs are the
    local pieces of DTensors placed by ``out_specs`` (a ``Sum`` spec for a
    pending sum). A plain tensor argument with a spec is taken as the same
    whole value on every rank. ``grad_specs`` (default: the in_specs) say
    how each argument's gradient is spread: a ``Sum`` over the axes along
    which ``fn``'s work is split where the argument itself is not."""
    mesh = pc.mesh
    grad_specs = in_specs if grad_specs is None else [
        s if g is None else g for s, g in zip(in_specs, grad_specs)]

    def norm(specs):
        return tuple(None if s is None else list(_pl(s, mesh)) for s in specs)

    outs = norm([out_specs] if isinstance(out_specs, P) else out_specs)
    mapped = local_map(fn, out_placements=outs, in_placements=norm(in_specs),
                       in_grad_placements=norm(grad_specs), device_mesh=mesh,
                       redistribute_inputs=True)

    def call(*args):
        args = [replicated(a, pc) if spec is not None and isinstance(a, torch.Tensor)
                and not isinstance(a, DTensor) else a for a, spec in zip(args, in_specs)]
        return mapped(*args)

    return call


def assign(dst: torch.Tensor, src: torch.Tensor) -> None:
    """``dst.copy_(src)`` in place; a DTensor ``src`` is first placed as the
    DTensor ``dst`` is."""
    if isinstance(dst, DTensor):
        dst.to_local().copy_(src.redistribute(dst.device_mesh, dst.placements).to_local())
    else:
        dst.copy_(src)
