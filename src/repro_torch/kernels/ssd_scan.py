"""The Mamba2 SSD chunk scan on a hand-written CUDA kernel for Hopper
(sm_90a).

Replaces ``repro/kernels/ssd_scan.py::ssd_scan`` (the Pallas TPU kernel
``_ssd_kernel``) and computes what the model's chunked path computes
(``ref.ssd_chunked``): x (B, S, H, P), dt (B, S, H) fp32, A (H,) fp32, B and
C (B, S, G, N), chunks of ``min(chunk, S)`` positions with the tail padded
by zeros, y (B, S, H, P) in x's type and the final state (B, H, P, N) in
fp32. x, B and C are fp32 or bf16 (the same type), P ≤ 64, N ≤ 128, the
chunk ≤ 4096. The kernel source is ``csrc/ssd_scan.cu``; its header says
what bounds it on the card and how it is laid out.

x, dt, B and C are read through their strides (unit stride along the last
dim), so the model's B and C, which are views into one projection, are
passed without a copy; head h reads group h // (H / G).

Build: at first use, ``kernels.build`` compiles the source into a shared
library with a plain C interface under ``build/kernels/``, loaded with
``ctypes``. Nothing is built when the module is imported.

On a CPU tensor ``ssd_scan`` takes the plain version (``ref.ssd_chunked``);
a CUDA tensor launches the kernel or raises. There is no initial state: the
TPU kernel starts from zeros. ``LAUNCHES`` counts kernel launches.

Gradient (``SsdScan``): the TPU kernel has no VJP, and the reference's
Mamba2 mixer differentiates its jnp chunked scan. So backward recomputes
that scan in plain torch (``ref.ssd_chunked``) from the saved inputs, on
their device, and takes autograd's VJP of it for x, dt, A, B and C; the
final state's gradient may be absent (``None``) or a tensor. The forward on
the card still launches the kernel; a backward kernel is later work.
"""
from __future__ import annotations

import ctypes
from pathlib import Path
from typing import Optional

import torch

from repro_torch.kernels import build as kbuild
from repro_torch.kernels import ref

SOURCE = Path(__file__).resolve().parent / "csrc" / "ssd_scan.cu"

#: kernel launches so far (the plain version is not counted). Reset it to 0
#: to count one run.
LAUNCHES = 0

MAX_P, MAX_N, MAX_CHUNK = 64, 128, 4096
_DTYPES = {torch.float32: 0, torch.bfloat16: 1}
_lib: Optional[ctypes.CDLL] = None


def build() -> Path:
    """Compile the kernel library if this source has not been built yet;
    returns its path."""
    return kbuild.build(SOURCE)[0]


def _library() -> ctypes.CDLL:
    global _lib
    if _lib is None:
        lib = ctypes.CDLL(str(build()))
        vp, i32 = ctypes.c_void_p, ctypes.c_int
        lib.ssd_scan_launch.argtypes = [
            i32, vp, vp, vp, vp, vp, vp, vp, i32, i32, i32, i32, i32, i32, i32, vp, vp,
        ]
        lib.ssd_scan_launch.restype = i32
        _lib = lib
    return _lib


def launch(x: torch.Tensor, dt: torch.Tensor, A: torch.Tensor, B: torch.Tensor,
           C: torch.Tensor, *, chunk: int) -> tuple[torch.Tensor, torch.Tensor]:
    """One launch of the kernel. Returns (y, final_state) as new contiguous
    tensors. Raises on anything the kernel does not take."""
    global LAUNCHES
    kbuild.require_sm90(x, "ssd_scan")
    if x.dtype not in _DTYPES:
        raise TypeError(f"ssd_scan takes float32 or bfloat16 x, got {x.dtype}")
    if x.dim() != 4 or dt.dim() != 3 or A.dim() != 1 or B.dim() != 4 or B.shape != C.shape:
        raise ValueError(f"x (B,S,H,P), dt (B,S,H), A (H,) and B, C (B,S,G,N) expected; got "
                         f"{tuple(x.shape)}, {tuple(dt.shape)}, {tuple(A.shape)}, "
                         f"{tuple(B.shape)}, {tuple(C.shape)}")
    b, s, h, p = x.shape
    g, n = B.shape[2], B.shape[3]
    if dt.shape != (b, s, h) or A.shape != (h,) or B.shape[:2] != (b, s) or h % g:
        raise ValueError(f"shapes do not match: x {tuple(x.shape)}, dt {tuple(dt.shape)}, "
                         f"A {tuple(A.shape)}, B and C {tuple(B.shape)} (H a multiple of G)")
    if min(b, s, h, p, n) == 0:
        raise ValueError(f"empty scan: x {tuple(x.shape)}, B {tuple(B.shape)}")
    if p > MAX_P or n > MAX_N:
        raise ValueError(f"ssd_scan takes head_dim <= {MAX_P} and state <= {MAX_N}, "
                         f"got {p} and {n}")
    q = min(int(chunk), s)
    if not 1 <= q <= MAX_CHUNK:
        raise ValueError(f"chunk must be in [1, {MAX_CHUNK}], got {chunk}")
    for t, what in ((B, "B"), (C, "C")):
        if t.device != x.device or t.dtype != x.dtype:
            raise ValueError(f"{what} must match x ({x.dtype} on {x.device}); "
                             f"got {t.dtype} on {t.device}")
    for t, what in ((dt, "dt"), (A, "A")):
        if t.device != x.device or t.dtype != torch.float32:
            raise ValueError(f"{what} must be float32 on {x.device}; got {t.dtype} on {t.device}")
    for t, what in ((x, "x"), (B, "B"), (C, "C"), (A, "A")):
        if t.stride(-1) != 1:
            raise ValueError(f"ssd_scan needs unit stride along {what}'s last dim, got "
                             f"strides {t.stride()}")
    y = torch.empty((b, s, h, p), device=x.device, dtype=x.dtype)
    state = torch.empty((b, h, p, n), device=x.device, dtype=torch.float32)
    strides = (ctypes.c_longlong * 15)(*(st for t in (x, y, dt, B, C) for st in t.stride()[:3]))
    lib = _library()
    with torch.cuda.device(x.device):
        err = lib.ssd_scan_launch(
            _DTYPES[x.dtype], x.data_ptr(), dt.data_ptr(), A.data_ptr(), B.data_ptr(),
            C.data_ptr(), y.data_ptr(), state.data_ptr(), b, s, h, g, p, n, q, strides,
            torch.cuda.current_stream(x.device).cuda_stream)
    if err != 0:
        raise RuntimeError(f"ssd_scan kernel launch failed: CUDA error {err}")
    LAUNCHES += 1
    return y, state


class SsdScan(torch.autograd.Function):
    """The kernel (or, on the CPU, the plain version), with the plain
    chunked scan's VJP as its gradient (see the module docstring)."""

    @staticmethod
    def forward(ctx, x, dt, A, B, C, chunk):
        ctx.chunk = chunk
        ctx.set_materialize_grads(False)
        ctx.save_for_backward(x, dt, A, B, C)
        if x.device.type == "cpu":
            return ref.ssd_chunked(x, dt, A, B, C, chunk)
        return launch(x, dt, A, B, C, chunk=chunk)

    @staticmethod
    def backward(ctx, dy, dstate):
        return ref.vjp(lambda *t: ref.ssd_chunked(*t, ctx.chunk), ctx.saved_tensors,
                       ctx.needs_input_grad[:5], (dy, dstate)) + (None,)


def ssd_scan(x: torch.Tensor, dt: torch.Tensor, A: torch.Tensor, B: torch.Tensor,
             C: torch.Tensor, *, chunk: int) -> tuple[torch.Tensor, torch.Tensor]:
    """(y (B,S,H,P) in x's dtype, final_state (B,H,P,N) fp32),
    differentiable in x, dt, A, B and C."""
    return SsdScan.apply(x, dt, A, B, C, chunk)
