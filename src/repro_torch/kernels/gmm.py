"""The grouped (per-expert) matmul on a hand-written CUDA kernel for Hopper
(sm_90a).

Replaces ``repro/kernels/gmm.py::gmm`` (the Pallas TPU kernel
``_gmm_kernel``): ``y[e] = x[e] @ w[e]``, x (E, C, D), w (E, D, F), fp32 or
bf16 (the same type), fp32 accumulation, y (E, C, F) in x's type. It is
what the MoE layer's three expert products compute
(``models.moe.expert_ffn``). One launch covers every expert. The kernel
source is ``csrc/gmm.cu``; its header says what bounds it on the card and
how it is laid out (bf16 on ``wgmma`` with TMA, warp-specialised and
persistent, with a 64-row body for C <= 64; fp32 as fp32 FMAs).

fp32 operands are read through their strides (any strides), without a
copy. The bf16 body reads each operand through a TMA map of its own layout:
unit stride along either of its last two axes (``_layout``: 0 along the
last, 1 along the middle one, a transposed view), the other strides
positive multiples of 8 elements and a 16-byte-aligned start, which covers
the MoE layer's buffers, views such as ``x[:, ::2]`` and the backward's
transposed views; w's last axis (F) must also be a multiple of 8.
``launch`` copies any other bf16 operand into a zero-padded contiguous one
first (the zeros add nothing to the products) and returns the unpadded
columns. A fault of the bf16 body's barrier protocol traps after about 2 s
instead of hanging the card, which ends the process's CUDA context.

Build: at first use, ``kernels.build`` compiles the source into a shared
library with a plain C interface under ``build/kernels/``, loaded with
``ctypes``. Nothing is built when the module is imported.

On a CPU tensor ``gmm`` takes the plain version (``ref.gmm_ref``); a CUDA
tensor launches the kernel or raises. The launch is the custom op
``repro_torch::gmm``, so a tracer sees it as one op: on a fake or meta
tensor (a shape-only trace, ``launch.dryrun``) it runs the op's fake
implementation, and ``torch.utils.flop_counter`` counts it by ``flops``,
the plain version's count. A call that nothing traces (``kbuild.traced``)
calls the launch directly, without the dispatcher. ``LAUNCHES`` counts
kernel launches.

Gradient (``Gmm``): the TPU kernel has no VJP, and the reference's MoE
layer differentiates its einsums, whose gradient is two more grouped
products: ``dx[e] = dy[e] @ w[e]ᵀ`` and ``dw[e] = x[e]ᵀ @ dy[e]``, each in
the operand's type with fp32 accumulation. On the card both are launches of
the same kernel on the transposed views as they lie (wᵀ read K-major, xᵀ
MN-major: no copy), so a product that needs both grads counts three
launches; on the CPU they take the plain version.
"""
from __future__ import annotations

import ctypes
from pathlib import Path
from typing import Optional

import torch
from torch.utils.flop_counter import register_flop_formula

from repro_torch.kernels import build as kbuild
from repro_torch.kernels import ref

SOURCE = Path(__file__).resolve().parent / "csrc" / "gmm.cu"

#: kernel launches so far (the plain version is not counted). Reset it to 0
#: to count one run.
LAUNCHES = 0

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
        lib.gmm_launch.argtypes = [i32, vp, vp, vp, i32, i32, i32, i32, vp, i32, i32, vp]
        lib.gmm_launch.restype = i32
        _lib = lib
    return _lib


def launch(x: torch.Tensor, w: torch.Tensor) -> torch.Tensor:
    """One launch of the kernel into a new contiguous (E, C, F) tensor.
    Raises on anything the kernel does not take. The launch itself
    (``_launch``) is the custom op ``repro_torch::gmm``, called as one
    where ``kbuild.traced`` says so; on a fake or meta tensor the op runs its
    fake implementation, which launches nothing, after the same checks and
    operand copies as on the card."""
    if x.device.type not in ("cuda", "meta"):
        raise ValueError(f"the gmm kernel runs on CUDA tensors, got {x.device}")
    if x.dtype not in _DTYPES:
        raise TypeError(f"gmm takes float32 or bfloat16, got {x.dtype}")
    if x.dim() != 3 or w.dim() != 3 or x.shape[0] != w.shape[0] or x.shape[2] != w.shape[1]:
        raise ValueError(f"x (E,C,D) and w (E,D,F) expected; got {tuple(x.shape)} and "
                         f"{tuple(w.shape)}")
    e, c, d = x.shape
    f = w.shape[2]
    if min(e, c, d, f) == 0:
        raise ValueError(f"empty product {tuple(x.shape)} @ {tuple(w.shape)}")
    if e > 65535:
        raise ValueError(f"gmm takes at most 65535 experts, got {e}")
    if w.device != x.device or w.dtype != x.dtype:
        raise ValueError(f"w must match x ({x.dtype} on {x.device}); "
                         f"got {w.dtype} on {w.device}")
    if x.dtype == torch.bfloat16:
        x, w = _tma_operands(x, w)
    launch_op = torch.ops.repro_torch.gmm if kbuild.traced(x, w) else _launch
    y = launch_op(x, w, d, f)
    return y if w.shape[2] == f else y[..., :f].contiguous()


def _launch(x: torch.Tensor, w: torch.Tensor, d: int, f: int) -> torch.Tensor:
    """The kernel's launch on ``launch``'s operands: y (E, C, w's F) of the
    products over the first ``d`` entries of D (``f``, w's unpadded F, is
    for the FLOP count)."""
    global LAUNCHES
    kbuild.require_sm90(x, "gmm")
    e, c = x.shape[:2]
    fp = w.shape[2]
    y = torch.empty((e, c, fp), device=x.device, dtype=x.dtype)
    strides = (ctypes.c_longlong * 6)(*x.stride(), *w.stride())
    # each bf16 operand's layout (the fp32 body reads any strides)
    x_t, w_t = (_layout(x) or 0, _layout(w) or 0) if x.dtype == torch.bfloat16 else (0, 0)
    lib = _library()
    with torch.cuda.device(x.device):
        err = lib.gmm_launch(_DTYPES[x.dtype], x.data_ptr(), w.data_ptr(), y.data_ptr(),
                             e, c, d, fp, strides, x_t, w_t,
                             torch.cuda.current_stream(x.device).cuda_stream)
    if err != 0:
        raise RuntimeError(f"gmm kernel launch failed: CUDA error {err}")
    LAUNCHES += 1
    return y


_op = torch.library.custom_op("repro_torch::gmm", _launch, mutates_args=(), device_types="cuda")


@_op.register_fake
def _(x, w, d, f):
    return x.new_empty((x.shape[0], x.shape[1], w.shape[2]))


@register_flop_formula(torch.ops.repro_torch.gmm)
def flops(x_shape, w_shape, d: int, f: int, *args, out_shape=None, **kwargs) -> int:
    """What the plain version (``ref.gmm_ref``: one ``bmm``) counts:
    2·E·C·D·F."""
    return 2 * x_shape[0] * x_shape[1] * d * f


def _tma_operands(x: torch.Tensor, w: torch.Tensor) -> tuple[torch.Tensor, torch.Tensor]:
    """The bf16 body's operands: each as it is where a TMA map describes it
    (and, for w, F is a multiple of 8), transposed views included, else a
    zero-padded contiguous copy (8-aligned D for x, F for w). The kernel is
    given the unpadded D."""
    if not _fits_bf16_body(x):
        x = _padded(x, x.shape[1], x.shape[2] + -x.shape[2] % 8)
    if not (_fits_bf16_body(w) and w.shape[2] % 8 == 0):
        w = _padded(w, w.shape[1], w.shape[2] + -w.shape[2] % 8)
    return x, w


def _layout(t: torch.Tensor) -> Optional[int]:
    """The layout a TMA map reads ``t`` (3-d) in: 0 with unit stride along
    the last axis, 1 along the middle one (a transposed view: the backward's
    wᵀ and xᵀ), the other two strides positive multiples of 8 elements (16
    bytes) and the start 16-byte aligned; None where no map describes it."""
    if not kbuild.start_aligned(t):
        return None
    for layout, unit, other in ((0, 2, 1), (1, 1, 2)):
        if t.stride(unit) == 1 and all(s > 0 and s % 8 == 0
                                       for s in (t.stride(0), t.stride(other))):
            return layout
    return None


def _fits_bf16_body(t: torch.Tensor) -> bool:
    """Whether a TMA map describes ``t`` (3-d) as it is, in either layout."""
    return _layout(t) is not None


def _padded(t: torch.Tensor, rows: int, cols: int) -> torch.Tensor:
    """A new contiguous (E, rows, cols) copy of ``t`` with zeros past its
    edges (a fresh allocation, so its start is 16-byte aligned; cols is a
    multiple of 8, so its strides are too)."""
    out = t.new_zeros((t.shape[0], rows, cols))
    out[:, :t.shape[1], :t.shape[2]] = t
    return out


def _product(x: torch.Tensor, w: torch.Tensor) -> torch.Tensor:
    """One grouped product: the plain version for a CPU tensor (real or
    fake), the kernel's op else."""
    if x.device.type == "cpu":
        return ref.gmm_ref(x, w)
    return launch(x, w)


class Gmm(torch.autograd.Function):
    """``x @ w`` per expert with every product, forward and backward, on the
    kernel (see the module docstring)."""

    @staticmethod
    def forward(ctx, x, w):
        ctx.save_for_backward(x, w)
        return _product(x, w)

    @staticmethod
    def backward(ctx, dy):
        # the transposed views go to the kernel as they lie (see _layout)
        x, w = ctx.saved_tensors
        dx = _product(dy, w.transpose(1, 2)) if ctx.needs_input_grad[0] else None
        dw = _product(x.transpose(1, 2), dy) if ctx.needs_input_grad[1] else None
        return dx, dw


def gmm(x: torch.Tensor, w: torch.Tensor) -> torch.Tensor:
    """x (E, C, D) @ w (E, D, F) -> (E, C, F) in x's dtype, differentiable
    in x and w."""
    return Gmm.apply(x, w)
