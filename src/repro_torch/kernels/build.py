"""Builds the port's CUDA sources and reads the card's properties.

Each source under ``csrc/`` has a plain C interface. At first use ``nvcc``
compiles it for ``sm_90a`` into a shared library under ``build/kernels/`` at
the repository root (one file per source digest), which the kernel's module
loads with ``ctypes``; the digest covers the local headers the source
includes (``csrc/hopper.cuh``). ``build`` starts one ``nvcc`` per source that
is not built yet, all at once, and waits for them all. Nothing is built when a
module is imported.
"""
from __future__ import annotations

import hashlib
import os
import re
import shutil
import subprocess
from pathlib import Path

import torch
from torch._subclasses.fake_tensor import FakeTensor

BUILD_DIR = Path(__file__).resolve().parents[3] / "build" / "kernels"
NVCC_TIMEOUT_S = 600

#: ptxas's report (registers, shared memory, spills) of each source built
#: by this process, by file name
LOGS: dict[str, str] = {}
#: device index -> (compute capability, SM count), asked once per process
DEVICES: dict = {}


def _nvcc() -> str:
    nvcc = shutil.which("nvcc") or "/usr/local/cuda/bin/nvcc"
    if not os.path.exists(nvcc):
        raise RuntimeError("the port's kernels need nvcc (the CUDA toolkit) to build; "
                           "none found on PATH or in /usr/local/cuda")
    return nvcc


def _local_includes(source: Path) -> list[Path]:
    """The headers that ``source`` includes with ``#include "..."`` (the
    port's own, found beside the file that includes them), and theirs, each
    once, in order."""
    seen: list[Path] = []
    todo = [source]
    while todo:
        including = todo.pop(0)
        text = including.read_text()
        for name in re.findall(r'^\s*#\s*include\s*"([^"]+)"', text, flags=re.MULTILINE):
            header = (including.parent / name).resolve()
            if header not in seen:
                seen.append(header)
                todo.append(header)
    return seen


def library_path(source: Path) -> Path:
    """The library built from ``source``: its name carries a digest of the
    source and of every local header it includes, so editing either
    rebuilds it instead of loading a stale one."""
    h = hashlib.sha256(source.read_bytes())
    for header in _local_includes(source):
        h.update(header.name.encode() + b"\0" + header.read_bytes())
    return BUILD_DIR / f"lib{source.stem}-{h.hexdigest()[:16]}.so"


def build(*sources: Path) -> list[Path]:
    """Compile every source whose library is missing, one ``nvcc`` each,
    all started together; returns the libraries' paths in order."""
    pending = []
    try:
        for source in sources:
            out = library_path(source)
            if out.exists():
                continue
            BUILD_DIR.mkdir(parents=True, exist_ok=True)
            tmp = out.with_name(f"{out.stem}.{os.getpid()}.tmp.so")
            cmd = [_nvcc(), "-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17",
                   "-O3", "-shared", "-Xcompiler", "-fPIC", "-Xptxas", "-v",
                   "-o", str(tmp), str(source)]
            proc = subprocess.Popen(cmd, stdout=subprocess.PIPE, stderr=subprocess.PIPE,
                                    text=True)
            pending.append((source, out, tmp, proc))
        for source, out, tmp, proc in pending:
            stdout, stderr = proc.communicate(timeout=NVCC_TIMEOUT_S)
            if proc.returncode != 0:
                raise RuntimeError(f"nvcc failed ({proc.returncode}) building {source}:\n"
                                   f"{stdout}{stderr}")
            LOGS[source.name] = stderr
            os.replace(tmp, out)
    finally:
        for _, _, _, proc in pending:
            if proc.poll() is None:
                proc.kill()
                proc.wait()
    return [library_path(s) for s in sources]


def device_info(index: int) -> tuple[tuple[int, int], int]:
    """(compute capability, SM count) of a card, asked once per process:
    the model code calls the wrappers hundreds of times a step."""
    info = DEVICES.get(index)
    if info is None:
        props = torch.cuda.get_device_properties(index)
        info = DEVICES[index] = ((props.major, props.minor), props.multi_processor_count)
    return info


def start_aligned(t: torch.Tensor, align: int = 16) -> bool:
    """Whether ``t``'s first element lies on an ``align``-byte boundary: its
    address on a real tensor; on a fake or meta tensor, which has none, its
    offset into its storage (the caching allocator starts every block on
    512 bytes), so that a shape-only trace copies what the card copies."""
    if t.is_meta or isinstance(t, FakeTensor):
        return t.storage_offset() * t.element_size() % align == 0
    return t.data_ptr() % align == 0


def traced(*tensors: torch.Tensor) -> bool:
    """Whether a kernel's call goes through its custom op: a tensor is fake
    or meta (a shape-only trace), or a dispatch mode is active (a tracer or
    a counter, which sees the op as one op). Otherwise the wrapper calls the
    op's launch directly: the dispatcher's round trip to it costs tens of µs
    a call on the card's host (PERF.md)."""
    return (torch._C._len_torch_dispatch_stack() > 0
            or any(t.is_meta or isinstance(t, FakeTensor) for t in tensors))


def require_sm90(t: torch.Tensor, kernel: str) -> int:
    """The SM count of ``t``'s card; raises unless ``t`` lies on a card of
    compute capability 9.0 or above (the kernels are built for sm_90a)."""
    if t.device.type != "cuda":
        raise ValueError(f"the {kernel} kernel runs on CUDA tensors, got {t.device}")
    cap, sms = device_info(t.device.index)
    if cap < (9, 0):
        raise RuntimeError(f"the {kernel} kernel is built for sm_90a; "
                           f"{torch.cuda.get_device_name(t.device)} has "
                           f"compute capability {cap[0]}.{cap[1]}")
    return sms
