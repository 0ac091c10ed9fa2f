"""IBN pointwise (1×1) conv + bias + activation on a hand-written CUDA
kernel for Hopper (sm_90a), with its gradient.

Replaces ``repro/kernels/ibn_conv.py::ibn_pointwise`` (the Pallas TPU
kernel ``_pw_kernel``): ``y = act(x @ w + b)``, x (N, Cin), w (Cin, Cout),
b (Cout,), fp32 accumulation, bias and act in the epilogue, output in
``x.dtype``. The kernel source is ``csrc/ibn_pointwise.cu``; its header says
what bounds it on the card and how it is laid out.

Build: at first use, ``nvcc`` compiles the source into a shared library
with a plain C interface under ``build/kernels/`` at the repository root
(one file per source digest), loaded with ``ctypes``. Nothing is built when
the module is imported.

Gradient (``IbnPointwise``): ``dz = dy · act'(z)`` in plain torch (relu
reads ``y > 0``; silu recomputes ``z`` with the kernel at ``act="none"``),
then ``dx = K(dz, wᵀ)`` and ``dw = K(xᵀ, dz)`` on the same kernel with no
bias and ``act="none"`` (transposed views, no copies), and ``db = dz.sum(0)``.

On a CPU tensor every product takes the plain version
(``ref.ibn_pointwise_ref``). A CUDA tensor launches the kernel or raises.
``LAUNCHES`` counts kernel launches (one per product on the card).
"""
from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
from pathlib import Path
from typing import Optional

import torch

from repro_torch.common import ceil_div, round_up
from repro_torch.kernels import ref

SOURCE = Path(__file__).resolve().parent / "csrc" / "ibn_pointwise.cu"
BUILD_DIR = Path(__file__).resolve().parents[3] / "build" / "kernels"

#: kernel launches so far (products on the card; the plain version is not
#: counted). Reset it to 0 to count one run.
LAUNCHES = 0
#: ptxas's report (registers, shared memory, spills) from this process's build
BUILD_LOG = ""

_ACTS = {"none": 0, "relu": 1, "silu": 2}
_DTYPES = {torch.float32: 0, torch.bfloat16: 1}
_BM, _BN, _BK = 64, 64, 16  # the kernel's output tile and K step
_lib: Optional[ctypes.CDLL] = None
_devices: dict = {}  # device index -> (compute capability, SM count)


def _nvcc() -> str:
    nvcc = shutil.which("nvcc") or "/usr/local/cuda/bin/nvcc"
    if not os.path.exists(nvcc):
        raise RuntimeError("ibn_pointwise needs nvcc (the CUDA toolkit) to build "
                           "its kernel; none found on PATH or in /usr/local/cuda")
    return nvcc


def build() -> Path:
    """Compile the kernel library if this source has not been built yet;
    returns its path."""
    global BUILD_LOG
    digest = hashlib.sha256(SOURCE.read_bytes()).hexdigest()[:16]
    out = BUILD_DIR / f"libibn_pointwise-{digest}.so"
    if out.exists():
        return out
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    tmp = out.with_name(f"{out.stem}.{os.getpid()}.tmp.so")
    cmd = [_nvcc(), "-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17",
           "-O3", "-shared", "-Xcompiler", "-fPIC", "-Xptxas", "-v",
           "-o", str(tmp), str(SOURCE)]
    proc = subprocess.run(cmd, capture_output=True, text=True)
    if proc.returncode != 0:
        raise RuntimeError(f"nvcc failed ({proc.returncode}) building {SOURCE}:\n"
                           f"{proc.stdout}{proc.stderr}")
    BUILD_LOG = proc.stderr
    os.replace(tmp, out)
    return out


def _library() -> ctypes.CDLL:
    global _lib
    if _lib is None:
        lib = ctypes.CDLL(str(build()))
        vp, i32, i64 = ctypes.c_void_p, ctypes.c_int, ctypes.c_longlong
        lib.ibn_pointwise_launch.argtypes = [
            i32, vp, vp, vp, vp, vp, i32, i32, i32, i64, i64, i64, i64,
            i32, i32, i32, vp,
        ]
        lib.ibn_pointwise_launch.restype = i32
        _lib = lib
    return _lib


def _split_k(m: int, n: int, k: int, sms: int) -> tuple[int, int]:
    """(splits, k_chunk): cut K when the output tiles alone cannot fill the
    card twice over, keeping at least 512 of K per chunk."""
    tiles = ceil_div(m, _BM) * ceil_div(n, _BN)
    splits = 1
    if tiles < 2 * sms:
        splits = max(1, min(ceil_div(2 * sms, tiles), k // 512))
    k_chunk = round_up(ceil_div(k, splits), _BK)
    return ceil_div(k, k_chunk), k_chunk


def _device(index: int) -> tuple[tuple[int, int], int]:
    """(compute capability, SM count) of a card, asked once per process:
    the training step calls the wrapper hundreds of times."""
    info = _devices.get(index)
    if info is None:
        props = torch.cuda.get_device_properties(index)
        info = _devices[index] = ((props.major, props.minor), props.multi_processor_count)
    return info


def launch(x: torch.Tensor, w: torch.Tensor, b: Optional[torch.Tensor],
           act: str) -> torch.Tensor:
    """One launch of the kernel: ``act(x @ w + b)`` into a new (N, Cout)
    tensor. x and w may be strided views; b (Cout,) or None. Raises on
    anything the kernel does not take."""
    global LAUNCHES
    if x.device.type != "cuda":
        raise ValueError(f"the ibn_pointwise kernel runs on CUDA tensors, got {x.device}")
    cap, sms = _device(x.device.index)
    if cap < (9, 0):
        raise RuntimeError(f"the ibn_pointwise kernel is built for sm_90a; "
                           f"{torch.cuda.get_device_name(x.device)} has "
                           f"compute capability {cap[0]}.{cap[1]}")
    if act not in _ACTS:
        raise ValueError(f"act must be one of {sorted(_ACTS)}, got {act!r}")
    if x.dtype not in _DTYPES:
        raise TypeError(f"ibn_pointwise takes float32 or bfloat16, got {x.dtype}")
    if x.dim() != 2 or w.dim() != 2 or x.shape[1] != w.shape[0]:
        raise ValueError(f"shapes {tuple(x.shape)} @ {tuple(w.shape)} do not multiply")
    m, k = x.shape
    n = w.shape[1]
    if min(m, k, n) == 0:
        raise ValueError(f"empty product {tuple(x.shape)} @ {tuple(w.shape)}")
    others = [w] if b is None else [w, b]
    for t in others:
        if t.device != x.device or t.dtype != x.dtype:
            raise ValueError(f"w and b must match x ({x.dtype} on {x.device}); "
                             f"got {t.dtype} on {t.device}")
    if b is not None and (b.shape != (n,) or b.stride(0) != 1):
        raise ValueError(f"b must be a contiguous ({n},) vector, got {tuple(b.shape)}")
    lib = _library()
    y = torch.empty((m, n), device=x.device, dtype=x.dtype)
    splits, k_chunk = _split_k(m, n, k, sms)
    ws = (torch.empty((splits, m, n), device=x.device, dtype=torch.float32)
          if splits > 1 else None)
    with torch.cuda.device(x.device):
        err = lib.ibn_pointwise_launch(
            _DTYPES[x.dtype], x.data_ptr(), w.data_ptr(),
            None if b is None else b.data_ptr(), y.data_ptr(),
            None if ws is None else ws.data_ptr(), m, k, n,
            x.stride(0), x.stride(1), w.stride(0), w.stride(1),
            _ACTS[act], k_chunk, splits,
            torch.cuda.current_stream(x.device).cuda_stream,
        )
    if err != 0:
        raise RuntimeError(f"ibn_pointwise kernel launch failed: CUDA error {err}")
    LAUNCHES += 1
    return y


def _product(x, w, b, act):
    """One product: the plain version for a CPU tensor, the kernel else."""
    if x.device.type == "cpu":
        return ref.ibn_pointwise_ref(x, w, b, act)
    return launch(x, w, b, act)


class IbnPointwise(torch.autograd.Function):
    """``act(x @ w + b)`` with every product, forward and backward, on the
    kernel (see the module docstring)."""

    @staticmethod
    def forward(ctx, x, w, b, act):
        y = _product(x, w, b, act)
        ctx.act = act
        ctx.save_for_backward(x, w, b, y)
        return y

    @staticmethod
    def backward(ctx, dy):
        x, w, b, y = ctx.saved_tensors
        if ctx.act == "relu":
            dz = dy * (y > 0)
        elif ctx.act == "silu":
            z = _product(x, w, b, "none").float()
            s = torch.sigmoid(z)
            dz = (dy.float() * s * (1.0 + z * (1.0 - s))).to(dy.dtype)
        else:
            dz = dy
        dz = dz.contiguous()
        dx = _product(dz, w.t(), None, "none") if ctx.needs_input_grad[0] else None
        dw = _product(x.t(), dz, None, "none") if ctx.needs_input_grad[1] else None
        db = dz.sum(0) if b is not None and ctx.needs_input_grad[2] else None
        return dx, dw, db, None


def ibn_pointwise(x: torch.Tensor, w: torch.Tensor, b: Optional[torch.Tensor],
                  *, act: str = "relu") -> torch.Tensor:
    """``act(x @ w + b)``, differentiable in x, w and b."""
    return IbnPointwise.apply(x, w, b, act)
