"""Fault-tolerant checkpointing. Counterpart of ``repro/train/checkpoint.py``,
with its on-disk layout: one ``arrays.npz`` of full logical tensors named by
``common.tree_paths`` plus a ``manifest.json`` of paths, shapes and dtypes,
so a checkpoint written by either implementation restores into the other.

Design goals (the parts that matter at 1000+ nodes):
  * atomic: a checkpoint directory appears only once fully written
    (write to ``<step>.tmp`` then os.rename)
  * resumable: ``latest_step`` + ``restore`` reconstruct {params, opt} exactly
  * async: ``save(..., blocking=False)`` snapshots to host then writes on a
    background thread so the train loop keeps stepping. The snapshot is taken
    before ``save`` returns, so a step that then updates the state in place
    (``train.optim``) does not change what is being written.
  * bounded: keeps the last ``keep`` checkpoints, deletes older ones

numpy has no bfloat16 of its own, so a bf16 leaf is stored as its raw bits
(``uint16``) and the manifest records ``"bfloat16"``.

A state of DTensors (the sharded train step's) is saved as the same full
arrays: every rank takes part in gathering one leaf at a time, and rank 0
writes it into the archive before the next, so no rank holds the whole
state gathered; such a save is blocking. ``restore`` places each leaf onto
a ``(mesh, placements)`` (the elastic-rescale path: the checkpoint does not
care what mesh wrote it), each rank reading and building only its own
slice; a DTensor leaf of ``state_like`` gives its own placements.
"""
from __future__ import annotations

import json
import os
import shutil
import threading
import zipfile
from typing import Any, Optional

import numpy as np
import torch
import torch.distributed as dist
from torch.distributed.tensor import DTensor
from torch.distributed.tensor._utils import compute_local_shape_and_global_offset

from repro_torch.common import tree_paths, tree_unflatten_paths
from repro_torch.parallel.sharding import contiguous_strides

_MANIFEST = "manifest.json"
_DATA = "arrays.npz"


def _host(leaf: torch.Tensor) -> np.ndarray:
    """A copy of ``leaf`` on the host (never a view of a CPU leaf, which the
    next step may update in place); bf16 as its bits."""
    t = leaf.detach()
    t = t.clone() if t.device.type == "cpu" else t.cpu()
    if t.dtype == torch.bfloat16:
        return t.view(torch.int16).numpy().view(np.uint16)
    return t.numpy()


def _flatten(state) -> tuple[dict[str, np.ndarray], dict[str, str]]:
    arrays, dtypes = {}, {}
    for path, leaf in tree_paths(state):
        arrays[path] = _host(leaf)
        dtypes[path] = str(leaf.dtype).removeprefix("torch.")
    return arrays, dtypes


def save(
    ckpt_dir: str,
    step: int,
    state: Any,
    keep: int = 3,
    blocking: bool = True,
) -> Optional[threading.Thread]:
    if any(isinstance(leaf, DTensor) for _, leaf in tree_paths(state)):
        _save_sharded(ckpt_dir, step, state, keep)
        return None
    os.makedirs(ckpt_dir, exist_ok=True)
    arrays, dtypes = _flatten(state)  # host snapshot happens NOW (async-safe)

    def write():
        tmp = _begin(ckpt_dir, step)
        np.savez(os.path.join(tmp, _DATA), **arrays)
        _finish(ckpt_dir, step, keep, {k: list(v.shape) for k, v in arrays.items()},
                dtypes)

    if blocking:
        write()
        return None
    t = threading.Thread(target=write, daemon=True)
    t.start()
    return t


def _begin(ckpt_dir: str, step: int) -> str:
    tmp = os.path.join(ckpt_dir, f"{step}.tmp")
    if os.path.exists(tmp):
        shutil.rmtree(tmp)
    os.makedirs(tmp)
    return tmp


def _finish(ckpt_dir: str, step: int, keep: int, shapes: dict, dtypes: dict) -> None:
    tmp = os.path.join(ckpt_dir, f"{step}.tmp")
    final = os.path.join(ckpt_dir, str(step))
    manifest = {"step": step, "paths": list(shapes), "shapes": shapes, "dtypes": dtypes}
    with open(os.path.join(tmp, _MANIFEST), "w") as f:
        json.dump(manifest, f)
    if os.path.exists(final):
        shutil.rmtree(final)
    os.rename(tmp, final)  # atomicity point
    _gc(ckpt_dir, keep)


def _save_sharded(ckpt_dir: str, step: int, state: Any, keep: int) -> None:
    """Every rank gathers each leaf in turn; rank 0 appends it to the
    archive (the ``np.savez`` layout: one ``.npy`` member per path) before
    the next is gathered. Returns on every rank once the checkpoint is in
    place."""
    writer = dist.get_rank() == 0
    shapes, dtypes = {}, {}
    archive = None
    if writer:
        os.makedirs(ckpt_dir, exist_ok=True)
        archive = zipfile.ZipFile(os.path.join(_begin(ckpt_dir, step), _DATA), "w",
                                  compression=zipfile.ZIP_STORED, allowZip64=True)
    try:
        for path, leaf in tree_paths(state):
            full = leaf.full_tensor() if isinstance(leaf, DTensor) else leaf
            if writer:
                arr = _host(full)
                with archive.open(path + ".npy", "w", force_zip64=True) as f:
                    np.lib.format.write_array(f, arr, allow_pickle=False)
                shapes[path] = list(arr.shape)
                dtypes[path] = str(leaf.dtype).removeprefix("torch.")
            del full
    finally:
        if archive is not None:
            archive.close()
    if writer:
        _finish(ckpt_dir, step, keep, shapes, dtypes)
    dist.barrier()


def _gc(ckpt_dir: str, keep: int):
    steps = sorted(all_steps(ckpt_dir))
    for s in steps[:-keep] if keep > 0 else []:
        shutil.rmtree(os.path.join(ckpt_dir, str(s)), ignore_errors=True)


def all_steps(ckpt_dir: str) -> list[int]:
    if not os.path.isdir(ckpt_dir):
        return []
    out = []
    for name in os.listdir(ckpt_dir):
        if name.isdigit() and os.path.exists(
            os.path.join(ckpt_dir, name, _MANIFEST)
        ):
            out.append(int(name))
    return sorted(out)


def latest_step(ckpt_dir: str) -> Optional[int]:
    steps = all_steps(ckpt_dir)
    return steps[-1] if steps else None


def _tensor(arr: np.ndarray, dtype: str) -> torch.Tensor:
    """An array as written (bf16 as its 16 raw bits, whatever numpy type
    holds them) as a tensor of its recorded type."""
    if dtype == "bfloat16":
        return torch.from_numpy(np.ascontiguousarray(arr).view(np.int16)).view(torch.bfloat16)
    return torch.from_numpy(np.asarray(arr))


def restore(
    ckpt_dir: str,
    state_like: Any,
    step: Optional[int] = None,
    shardings: Any = None,
) -> tuple[Any, int]:
    """Restore into the structure of ``state_like``: each leaf a new tensor
    of the like leaf's type on its device. ``shardings``, a tree like
    ``state_like`` of ``(mesh, placements)`` pairs, places each leaf as a
    DTensor instead (a DTensor like leaf gives its own when ``shardings``
    is None); each rank reads and builds only its own slice."""
    if step is None:
        step = latest_step(ckpt_dir)
    if step is None:
        raise FileNotFoundError(f"no checkpoint under {ckpt_dir}")
    d = os.path.join(ckpt_dir, str(step))
    with open(os.path.join(d, _MANIFEST)) as f:
        dtypes = json.load(f)["dtypes"]
    like = tree_paths(state_like)
    placed = (_along(state_like, shardings) if shardings is not None else
              [(t.device_mesh, t.placements) if isinstance(t, DTensor) else None
               for _, t in like])
    with np.load(os.path.join(d, _DATA)) as data:
        missing = [p for p, _ in like if p not in data]
        if missing:
            raise KeyError(f"checkpoint missing {len(missing)} arrays, e.g. {missing[:3]}")
        leaves = []
        for (p, t), where in zip(like, placed):
            arr = data[p]
            if tuple(arr.shape) != tuple(t.shape):
                raise ValueError(f"{p}: shape {arr.shape} != expected {t.shape}")
            if where is None:
                leaves.append(_tensor(arr, dtypes[p]).to(device=t.device, dtype=t.dtype))
            else:
                leaves.append(_placed(arr, dtypes[p], t.dtype, *where))
    return tree_unflatten_paths(state_like, leaves), step


def _along(like, other) -> list:
    """``other``'s entries where ``like`` has leaves, in ``tree_paths``
    order (``other`` may hold tuples where ``like`` has leaves)."""
    if like is None:
        return []
    if isinstance(like, dict):
        return [x for k in sorted(like) for x in _along(like[k], other[k])]
    if isinstance(like, (list, tuple)):
        return [x for i, t in enumerate(like) for x in _along(t, other[i])]
    return [other]


def _placed(arr: np.ndarray, dtype: str, like_dtype: torch.dtype, mesh, placements) -> DTensor:
    """This rank's slice of the full array ``arr``, as a DTensor on
    ``mesh`` placed by ``placements``."""
    shape, offset = compute_local_shape_and_global_offset(arr.shape, mesh, placements)
    index = tuple(slice(o, o + n) for o, n in zip(offset, shape))
    local = _tensor(np.ascontiguousarray(arr[index]), dtype)
    local = local.to(device=mesh.device_type, dtype=like_dtype)
    return DTensor.from_local(local, mesh, placements, run_check=False,
                              shape=torch.Size(arr.shape),
                              stride=contiguous_strides(arr.shape))
