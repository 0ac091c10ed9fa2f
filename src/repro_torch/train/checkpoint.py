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
(``uint16``) and the manifest records ``"bfloat16"``. Restoring onto
another mesh (``shardings``) comes with the port's parallel slice.
"""
from __future__ import annotations

import json
import os
import shutil
import threading
from typing import Any, Optional

import numpy as np
import torch

from repro_torch.common import tree_paths, tree_unflatten_paths

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
    os.makedirs(ckpt_dir, exist_ok=True)
    arrays, dtypes = _flatten(state)  # host snapshot happens NOW (async-safe)

    def write():
        tmp = os.path.join(ckpt_dir, f"{step}.tmp")
        final = os.path.join(ckpt_dir, str(step))
        if os.path.exists(tmp):
            shutil.rmtree(tmp)
        os.makedirs(tmp)
        np.savez(os.path.join(tmp, _DATA), **arrays)
        manifest = {
            "step": step,
            "paths": list(arrays.keys()),
            "shapes": {k: list(v.shape) for k, v in arrays.items()},
            "dtypes": dtypes,
        }
        with open(os.path.join(tmp, _MANIFEST), "w") as f:
            json.dump(manifest, f)
        if os.path.exists(final):
            shutil.rmtree(final)
        os.rename(tmp, final)  # atomicity point
        _gc(ckpt_dir, keep)

    if blocking:
        write()
        return None
    t = threading.Thread(target=write, daemon=True)
    t.start()
    return t


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
    of the like leaf's type on its device."""
    if shardings is not None:
        raise NotImplementedError("restoring onto shardings comes with the port's "
                                  "parallel slice")
    if step is None:
        step = latest_step(ckpt_dir)
    if step is None:
        raise FileNotFoundError(f"no checkpoint under {ckpt_dir}")
    d = os.path.join(ckpt_dir, str(step))
    with open(os.path.join(d, _MANIFEST)) as f:
        dtypes = json.load(f)["dtypes"]
    like = tree_paths(state_like)
    with np.load(os.path.join(d, _DATA)) as data:
        missing = [p for p, _ in like if p not in data]
        if missing:
            raise KeyError(f"checkpoint missing {len(missing)} arrays, e.g. {missing[:3]}")
        leaves = []
        for p, t in like:
            arr = data[p]
            if tuple(arr.shape) != tuple(t.shape):
                raise ValueError(f"{p}: shape {arr.shape} != expected {t.shape}")
            leaves.append(_tensor(arr, dtypes[p]).to(device=t.device, dtype=t.dtype))
    return tree_unflatten_paths(state_like, leaves), step
