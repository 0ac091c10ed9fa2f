"""IBN pointwise (1×1) conv + bias + activation on a hand-written CUDA
kernel for Hopper (sm_90a), with its gradient.

Replaces ``repro/kernels/ibn_conv.py::ibn_pointwise`` (the Pallas TPU
kernel ``_pw_kernel``): ``y = act(x @ w + b)``, x (N, Cin), w (Cin, Cout),
b (Cout,), fp32 accumulation, bias and act in the epilogue, output in
``x.dtype``. The kernel source is ``csrc/ibn_pointwise.cu``; its header says
what bounds it on the card and how it is laid out: one launch per product,
operands through TMA into a ring of stages, products on the tensor cores
(bf16 directly, fp32 as 3xTF32), and a product whose tiles cannot fill the
card splits K across a thread-block cluster and sums the partial tiles
through distributed shared memory in rank order.

``plan`` chooses each product's tile, cluster size and K range from its
shape, the card's SM count and its largest cluster, both asked once per
device. ``launch`` reads x and w through their strides where a TMA map can
(unit stride along one axis, the other 16-byte aligned) and copies an
operand that cannot be read so; it allocates only y, and is safe to capture
in a CUDA graph.

Build: at first use, ``kernels.build`` compiles the source into a shared
library with a plain C interface under ``build/kernels/``, loaded with
``ctypes``. Nothing is built when the module is imported.

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
import functools
from pathlib import Path
from typing import Optional

import torch

from repro_torch.common import ceil_div, round_up
from repro_torch.kernels import build as kbuild
from repro_torch.kernels import ref

SOURCE = Path(__file__).resolve().parent / "csrc" / "ibn_pointwise.cu"

#: kernel launches so far (products on the card; the plain version is not
#: counted). Reset it to 0 to count one run.
LAUNCHES = 0

_ACTS = {"none": 0, "relu": 1, "silu": 2}
_DTYPES = {torch.float32: 0, torch.bfloat16: 1}
#: the kernel's bodies by type, (BM, BN, K step) -> the body's index in the C
#: interface, largest tile first; a K step is one 128-byte panel row of the
#: type, or two (the fp32 32 x 32 tile's deep step)
TILES = {torch.float32: {(64, 64, 32): 0, (32, 32, 32): 1, (32, 32, 64): 2},
         torch.bfloat16: {(64, 64, 64): 0}}
#: fewest K steps a split-K CTA takes
MIN_STEPS = 2
#: K a CTA of the fp32 32 x 32 tile walks from which the deep step pays
DEEP_K = 256
_lib: Optional[ctypes.CDLL] = None
#: device index -> the largest split-K cluster (8 or 16), asked once
_MAX_CLUSTER: dict = {}


def build() -> Path:
    """Compile the kernel library if this source has not been built yet;
    returns its path."""
    return kbuild.build(SOURCE)[0]


def _library() -> ctypes.CDLL:
    global _lib
    if _lib is None:
        lib = ctypes.CDLL(str(build()))
        vp, i32, i64 = ctypes.c_void_p, ctypes.c_int, ctypes.c_longlong
        lib.ibn_pointwise_launch.argtypes = [
            i32, vp, vp, vp, vp, i32, i32, i32, i64, i64, i32, i32, i32, i32, i32, i32, vp,
        ]
        lib.ibn_pointwise_launch.restype = i32
        lib.ibn_pointwise_max_cluster.argtypes = []
        lib.ibn_pointwise_max_cluster.restype = i32
        _lib = lib
    return _lib


@functools.lru_cache(maxsize=4096)  # the model's shapes repeat at every step
def plan(m: int, n: int, k: int, dtype: torch.dtype, sms: int,
         max_cluster: int) -> tuple[tuple[int, int, int], int, int]:
    """(body, splits, k_chunk) of one product (M, K, N): the body (BM, BN,
    K step), the CTAs of a cluster that share each tile's K (a power of two
    up to ``max_cluster``) and the K each takes (a multiple of the K step;
    the last ranks may get less, or none).

    The largest tile is taken when its tiles alone fill the card (``sms``
    CTAs), the smallest one otherwise: a K step of a 32 x 32 tile costs
    less than a 64 x 64 tile's for a quarter of the work, and a thin
    product (M or N of 16 or 32) wastes most of a large tile. A product
    whose tiles do not fill the card splits K into as many parts as fill
    it, each at least ``MIN_STEPS`` K steps long. A CTA that walks at least
    ``DEEP_K`` of K takes the deep step where its type has one."""
    bodies = list(TILES[dtype])
    for bm, bn in dict.fromkeys(b[:2] for b in bodies):  # largest first
        tiles = ceil_div(m, bm) * ceil_div(n, bn)
        if tiles >= sms:
            break
    step = min(b[2] for b in bodies if b[:2] == (bm, bn))
    steps = ceil_div(k, step)
    splits = 1
    while (splits * 2 <= max_cluster and tiles * splits < sms
           and ceil_div(steps, splits * 2) >= MIN_STEPS):
        splits *= 2
    k_chunk = ceil_div(steps, splits) * step
    deep = [b for b in bodies if b[:2] == (bm, bn) and b[2] > step]
    if deep and k_chunk >= DEEP_K:
        step = deep[0][2]
        k_chunk = ceil_div(ceil_div(k, step), splits) * step
    return (bm, bn, step), splits, k_chunk


def _max_cluster(index: int) -> int:
    got = _MAX_CLUSTER.get(index)
    if got is None:
        got = _library().ibn_pointwise_max_cluster()
        if got < 0:
            raise RuntimeError(f"ibn_pointwise: asking the card for its cluster limit failed: "
                               f"CUDA error {-got}")
        _MAX_CLUSTER[index] = got
    return got


def _operand(t: torch.Tensor, k_axis: int) -> tuple[torch.Tensor, bool, int]:
    """(t, k-major, outer stride): ``t`` as a TMA map reads it, unit stride
    along one axis (K's when it has one) and the other stride and the start
    16-byte aligned; else a copy that is (a fresh allocation, its rows padded
    to 16 bytes, the K axis innermost)."""
    size = t.element_size()
    align = 16 // size
    for inner in (k_axis, 1 - k_axis):
        outer = 1 - inner
        if t.stride(inner) == 1 or t.shape[inner] == 1:
            stride = t.stride(outer) if t.shape[outer] > 1 else round_up(t.shape[inner], align)
            if stride > 0 and stride % align == 0 and t.data_ptr() % 16 == 0:
                return t, inner == k_axis, stride
    rows, cols = (t.shape[1], t.shape[0]) if k_axis == 0 else t.shape
    buf = t.new_empty((rows, round_up(cols, align)))[:, :cols]
    buf.copy_(t.t() if k_axis == 0 else t)
    return (buf.t() if k_axis == 0 else buf), True, buf.stride(0)


def launch(x: torch.Tensor, w: torch.Tensor, b: Optional[torch.Tensor],
           act: str) -> torch.Tensor:
    """One launch of the kernel: ``act(x @ w + b)`` into a new (N, Cout)
    tensor. x and w may be strided views; b (Cout,) or None. Raises on
    anything the kernel does not take."""
    global LAUNCHES
    sms = kbuild.require_sm90(x, "ibn_pointwise")
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
    index = x.device.index
    body, splits, k_chunk = plan(m, n, k, x.dtype, sms, _max_cluster(index))
    a, a_kmajor, sa = _operand(x, 1)
    bt, b_kmajor, sb = _operand(w, 0)
    y = torch.empty((m, n), device=x.device, dtype=x.dtype)
    args = (_DTYPES[x.dtype], a.data_ptr(), bt.data_ptr(), None if b is None else b.data_ptr(),
            y.data_ptr(), m, k, n, sa, sb, int(a_kmajor), int(b_kmajor), _ACTS[act],
            TILES[x.dtype][body], splits, k_chunk)
    if index == torch.cuda.current_device():
        err = lib.ibn_pointwise_launch(*args, torch.cuda.current_stream(index).cuda_stream)
    else:
        with torch.cuda.device(index):
            err = lib.ibn_pointwise_launch(*args, torch.cuda.current_stream(index).cuda_stream)
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
