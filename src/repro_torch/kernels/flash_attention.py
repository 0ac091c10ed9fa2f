"""Flash attention on a hand-written CUDA kernel for Hopper (sm_90a).

Replaces ``repro/kernels/flash_attention.py::flash_attention`` (the Pallas
TPU kernel ``_attn_kernel``): online-softmax GQA attention with fp32 m, l
and accumulator, scale 1/√hd, an optional causal mask aligned top-left, the
ragged kv tail masked, ``p`` rounded to v's type before the product with v,
and the output in q's type. q (B, H, Sq, hd), k and v (B, KV, Skv, hd),
fp32 or bf16, hd in ``HEAD_DIMS`` (16, 32, 64, 80, 112, 128, 256: every
head_dim of the repo's full-size configs). The kernel source is
``csrc/flash_attention.cu``; its header says what bounds it on the card and
how it is laid out: bf16 runs on the tensor cores (``wgmma``, its tiles
brought by TMA), fp32 on FMAs. TMA reads a tensor whose start and (batch,
head, row) strides are 16-byte aligned, so ``launch`` copies a bf16 q, k or
v that is not into a contiguous one first; the model's views always are.

Build: at first use, ``kernels.build`` compiles the source into a shared
library with a plain C interface under ``build/kernels/``, loaded with
``ctypes``. Nothing is built when the module is imported.

On a CPU tensor ``flash_attention`` takes the plain version
(``ref.flash_attention_ref``); a CUDA tensor launches the kernel or raises.
The launch is the custom op ``repro_torch::flash_attention``, so a tracer
sees it as one op: on a fake or meta tensor (a shape-only trace,
``launch.dryrun``) it runs the op's fake implementation, and
``torch.utils.flop_counter`` counts it by ``flops``, the plain version's
count. A call that nothing traces (``kbuild.traced``) calls the launch
directly, without the dispatcher. ``LAUNCHES`` counts kernel launches.

Gradient (``FlashAttention``): the TPU kernel has no VJP, and the reference's
models differentiate their jnp attention, the same function. On the card the
gradient is two more hand-written kernels (``csrc/flash_attention_bwd.cu``,
FlashAttention-2's backward on ``mma.sync``): dq, and dk with dv, from the
saved q, k, v, the output and the rows' log-sum-exp, which the forward
kernel writes only when a gradient will be taken (``with_lse``); so a
backward counts two launches (``LAUNCHES`` and ``BACKWARD_LAUNCHES``). On
the CPU it takes the plain backward, ``ref.flash_attention_bwd``. The
launch is the custom op ``repro_torch::flash_attention_bwd`` (fake
implementation and FLOP formula as the forward's). No atomics: the same
inputs give bitwise the same gradients. The backward runs in a profiler
range, ``flash_attention.backward``, that gives its device time.
"""
from __future__ import annotations

import ctypes
import math
from pathlib import Path
from typing import Optional

import torch
from torch.utils.flop_counter import register_flop_formula

from repro_torch.kernels import build as kbuild
from repro_torch.kernels import ref

SOURCE = Path(__file__).resolve().parent / "csrc" / "flash_attention.cu"
BWD_SOURCE = SOURCE.with_name("flash_attention_bwd.cu")
SOURCES = (SOURCE, BWD_SOURCE)

#: kernel launches so far, forward and backward (the plain version is not
#: counted). Reset it to 0 to count one run.
LAUNCHES = 0
#: of those, the backward's (two a backward)
BACKWARD_LAUNCHES = 0

HEAD_DIMS = (16, 32, 64, 80, 112, 128, 256)
_DTYPES = {torch.float32: 0, torch.bfloat16: 1}
_lib: Optional[ctypes.CDLL] = None
_bwd_lib: Optional[ctypes.CDLL] = None


def build() -> Path:
    """Compile the forward's and the backward's libraries if these sources
    have not been built yet (in parallel); returns the forward's path."""
    return kbuild.build(*SOURCES)[0]


def _library() -> ctypes.CDLL:
    global _lib
    if _lib is None:
        lib = ctypes.CDLL(str(build()))
        vp, i32 = ctypes.c_void_p, ctypes.c_int
        lib.flash_attention_launch.argtypes = [
            i32, i32, vp, vp, vp, vp, vp, i32, i32, i32, i32, i32, vp, i32,
            ctypes.c_float, vp,
        ]
        lib.flash_attention_launch.restype = i32
        _lib = lib
    return _lib


def _bwd_library() -> ctypes.CDLL:
    global _bwd_lib
    if _bwd_lib is None:
        lib = ctypes.CDLL(str(kbuild.build(BWD_SOURCE)[0]))
        vp, i32 = ctypes.c_void_p, ctypes.c_int
        lib.flash_attention_bwd_launch.argtypes = [
            i32, i32, vp, vp, vp, vp, vp, vp, vp, vp, vp, vp, i32, i32, i32, i32, i32, vp, i32,
            ctypes.c_float, vp,
        ]
        lib.flash_attention_bwd_launch.restype = i32
        _bwd_lib = lib
    return _bwd_lib


def _aligned16(t: torch.Tensor) -> bool:
    """Start and (batch, head, row) strides on 16-byte boundaries."""
    size = t.element_size()
    return kbuild.start_aligned(t) and all(s * size % 16 == 0 for s in t.stride()[:3])


def launch(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, *,
           causal: bool, with_lse: bool = False) -> tuple[torch.Tensor, torch.Tensor]:
    """One launch of the kernel. q (B, H, Sq, hd), k and v (B, KV, Skv, hd),
    any strides with unit stride along hd. Returns (B, H, Sq, hd) as a view
    of a new (B, Sq, H, hd) tensor, the model's layout, and with
    ``with_lse`` the rows' log-sum-exp (B, H, Sq) fp32 for the backward
    (else an empty tensor). Raises on anything the kernel does not take.
    The launch itself (``_launch``) is the custom op
    ``repro_torch::flash_attention``, called as one where ``kbuild.traced``
    says so; on a fake or meta tensor the op runs its fake implementation,
    which launches nothing, after the same checks and copies as on the
    card."""
    if q.device.type not in ("cuda", "meta"):
        raise ValueError(f"the flash_attention kernel runs on CUDA tensors, got {q.device}")
    if q.dtype not in _DTYPES:
        raise TypeError(f"flash_attention takes float32 or bfloat16, got {q.dtype}")
    if q.dim() != 4 or k.dim() != 4 or k.shape != v.shape:
        raise ValueError(f"q (B,H,Sq,hd) and k, v (B,KV,Skv,hd) expected; got "
                         f"{tuple(q.shape)}, {tuple(k.shape)}, {tuple(v.shape)}")
    b, h, sq, hd = q.shape
    kvh, skv = k.shape[1], k.shape[2]
    if k.shape[0] != b or k.shape[3] != hd or kvh == 0 or h % kvh:
        raise ValueError(f"q {tuple(q.shape)} does not match k, v {tuple(k.shape)} "
                         f"(GQA needs H a multiple of KV)")
    if hd not in HEAD_DIMS:
        raise ValueError(f"head_dim must be one of {HEAD_DIMS}, got {hd}")
    if min(b, h, sq, skv) == 0:
        raise ValueError(f"empty attention: q {tuple(q.shape)}, k {tuple(k.shape)}")
    for t in (k, v):
        if t.device != q.device or t.dtype != q.dtype:
            raise ValueError(f"k and v must match q ({q.dtype} on {q.device}); "
                             f"got {t.dtype} on {t.device}")
    for t in (q, k, v):
        if t.stride(3) != 1:
            raise ValueError(f"flash_attention needs unit stride along head_dim, got "
                             f"strides {t.stride()}")
    if q.dtype == torch.bfloat16:  # TMA's 16-byte alignment
        q, k, v = (t if _aligned16(t) else t.contiguous() for t in (q, k, v))
    launch_op = torch.ops.repro_torch.flash_attention if kbuild.traced(q, k, v) else _launch
    out, lse = launch_op(q, k, v, causal, with_lse)
    return out.transpose(1, 2), lse


def _launch(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, causal: bool,
            with_lse: bool) -> tuple[torch.Tensor, torch.Tensor]:
    """The kernel's launch on ``launch``'s operands: a new contiguous
    (B, Sq, H, hd) tensor, the model's layout, and the log-sum-exp (see
    ``launch``)."""
    global LAUNCHES
    kbuild.require_sm90(q, "flash_attention")
    b, h, sq, hd = q.shape
    kvh, skv = k.shape[1], k.shape[2]
    out = torch.empty((b, sq, h, hd), device=q.device, dtype=q.dtype)
    lse = torch.empty((b, h, sq) if with_lse else (0,), device=q.device, dtype=torch.float32)
    os_ = out.stride()  # written as its (B, H, Sq, hd) view
    strides = (ctypes.c_longlong * 12)(*(s for t in (q, k, v) for s in t.stride()[:3]),
                                       os_[0], os_[2], os_[1])
    lib = _library()
    with torch.cuda.device(q.device):
        err = lib.flash_attention_launch(
            _DTYPES[q.dtype], hd, q.data_ptr(), k.data_ptr(), v.data_ptr(),
            out.data_ptr(), lse.data_ptr() if with_lse else None, b, h, kvh, sq, skv, strides,
            int(causal), 1.0 / math.sqrt(hd), torch.cuda.current_stream(q.device).cuda_stream)
    if err != 0:
        raise RuntimeError(f"flash_attention kernel launch failed: CUDA error {err}")
    LAUNCHES += 1
    return out, lse


_op = torch.library.custom_op("repro_torch::flash_attention", _launch, mutates_args=(),
                              device_types="cuda")


@_op.register_fake
def _(q, k, v, causal, with_lse):
    b, h, sq, hd = q.shape
    return (q.new_empty((b, sq, h, hd)),
            q.new_empty((b, h, sq) if with_lse else (0,), dtype=torch.float32))


@register_flop_formula(torch.ops.repro_torch.flash_attention)
def flops(q_shape, k_shape, v_shape, causal: bool, *args, out_shape=None, **kwargs) -> int:
    """What the plain version (``ref.flash_attention_ref``: the scores and
    their product with v, every position, the mask applied after) counts:
    4·B·H·Sq·Skv·hd."""
    b, h, sq, hd = q_shape
    return 4 * b * h * sq * k_shape[2] * hd


def launch_bwd(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, o: torch.Tensor,
               lse: torch.Tensor, do: torch.Tensor, *,
               causal: bool) -> tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """The backward kernels' two launches: (dq, dk, dv) like q, k and v
    ((B, heads, S, hd) views of new tensors in the model's (B, S, heads, hd)
    layout) from the forward's q, k, v, its output o, the log-sum-exp its
    launch wrote (``with_lse``) and o's cotangent do. Any strides with unit
    stride along hd (a tensor without is copied). Raises on anything the
    kernels do not take. The launches (``_launch_bwd``) are the custom op
    ``repro_torch::flash_attention_bwd``, called as one where
    ``kbuild.traced`` says so."""
    if q.device.type not in ("cuda", "meta"):
        raise ValueError(f"the flash_attention backward runs on CUDA tensors, got {q.device}")
    if q.dtype not in _DTYPES:
        raise TypeError(f"flash_attention takes float32 or bfloat16, got {q.dtype}")
    b, h, sq, hd = q.shape
    kvh, skv = k.shape[1], k.shape[2]
    if hd not in HEAD_DIMS or h % kvh or k.shape != v.shape or k.shape[0] != b:
        raise ValueError(f"q {tuple(q.shape)}, k {tuple(k.shape)}, v {tuple(v.shape)}: "
                         f"head_dim in {HEAD_DIMS} and H a multiple of KV expected")
    if o.shape != q.shape or do.shape != q.shape or lse.shape != (b, h, sq):
        raise ValueError(f"o {tuple(o.shape)}, do {tuple(do.shape)} and lse "
                         f"{tuple(lse.shape)} do not match q {tuple(q.shape)}")
    for t in (k, v, o, do):
        if t.device != q.device or t.dtype != q.dtype:
            raise ValueError(f"k, v, o and do must match q ({q.dtype} on {q.device}); "
                             f"got {t.dtype} on {t.device}")
    if lse.dtype != torch.float32 or lse.device != q.device:
        raise ValueError(f"lse must be float32 on {q.device}; got {lse.dtype} on {lse.device}")
    q, k, v, o, do = (t if t.stride(3) == 1 else t.contiguous() for t in (q, k, v, o, do))
    lse = lse.contiguous()
    args = (q, k, v, o, lse, do)
    launch_op = torch.ops.repro_torch.flash_attention_bwd if kbuild.traced(*args) else _launch_bwd
    dq, dk, dv = launch_op(*args, causal)
    return dq.transpose(1, 2), dk.transpose(1, 2), dv.transpose(1, 2)


def _launch_bwd(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, o: torch.Tensor,
                lse: torch.Tensor, do: torch.Tensor,
                causal: bool) -> tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """The backward's launches on ``launch_bwd``'s operands: new contiguous
    dq (B, Sq, H, hd), dk and dv (B, Skv, KV, hd)."""
    global LAUNCHES, BACKWARD_LAUNCHES
    kbuild.require_sm90(q, "flash_attention")
    b, h, sq, hd = q.shape
    kvh, skv = k.shape[1], k.shape[2]
    dq = torch.empty((b, sq, h, hd), device=q.device, dtype=q.dtype)
    dk = torch.empty((b, skv, kvh, hd), device=q.device, dtype=q.dtype)
    dv = torch.empty_like(dk)
    dsum = torch.empty((b, h, sq), device=q.device, dtype=torch.float32)  # D = rowsum(do o)
    strides = (ctypes.c_longlong * 24)(
        *(s for t in (q, k, v, o, do) for s in t.stride()[:3]),
        *(s for t in (dq, dk, dv) for s in (t.stride(0), t.stride(2), t.stride(1))))
    lib = _bwd_library()
    with torch.cuda.device(q.device):
        err = lib.flash_attention_bwd_launch(
            _DTYPES[q.dtype], hd, q.data_ptr(), k.data_ptr(), v.data_ptr(), o.data_ptr(),
            do.data_ptr(), lse.data_ptr(), dsum.data_ptr(), dq.data_ptr(), dk.data_ptr(),
            dv.data_ptr(), b, h, kvh, sq, skv, strides, int(causal), 1.0 / math.sqrt(hd),
            torch.cuda.current_stream(q.device).cuda_stream)
    if err != 0:
        raise RuntimeError(f"flash_attention backward launch failed: CUDA error {err}")
    LAUNCHES += 2
    BACKWARD_LAUNCHES += 2
    return dq, dk, dv


_bwd_op = torch.library.custom_op("repro_torch::flash_attention_bwd", _launch_bwd,
                                  mutates_args=(), device_types="cuda")


@_bwd_op.register_fake
def _(q, k, v, o, lse, do, causal):
    b, h, sq, hd = q.shape
    kvh, skv = k.shape[1], k.shape[2]
    return (q.new_empty((b, sq, h, hd)), q.new_empty((b, skv, kvh, hd)),
            q.new_empty((b, skv, kvh, hd)))


@register_flop_formula(torch.ops.repro_torch.flash_attention_bwd)
def bwd_flops(q_shape, k_shape, v_shape, o_shape, lse_shape, do_shape, causal: bool, *args,
              out_shape=None, **kwargs) -> int:
    """What the plain backward (``ref.flash_attention_bwd``: the scores, dv,
    dP, dq and dk, every position, the mask applied after) counts:
    10·B·H·Sq·Skv·hd."""
    b, h, sq, hd = q_shape
    return 10 * b * h * sq * k_shape[2] * hd


class FlashAttention(torch.autograd.Function):
    """The kernel (or, on the CPU, the plain version), with the backward
    kernels (on the CPU the plain backward) as its gradient (see the module
    docstring)."""

    @staticmethod
    def forward(ctx, q, k, v, causal, with_lse):
        ctx.causal = causal
        if q.device.type == "cpu":
            out = ref.flash_attention_ref(q, k, v, causal=causal)
            ctx.save_for_backward(q, k, v, out)
            return out
        out, lse = launch(q, k, v, causal=causal, with_lse=with_lse)
        ctx.save_for_backward(q, k, v, out, lse)
        return out

    @staticmethod
    def backward(ctx, do):
        q, k, v, o, *lse = ctx.saved_tensors
        with torch.profiler.record_function("flash_attention.backward"):
            if q.device.type == "cpu":
                grads = ref.flash_attention_bwd(q, k, v, o, do, causal=ctx.causal)
            else:
                grads = launch_bwd(q, k, v, o, lse[0], do, causal=ctx.causal)
        return tuple(g if need else None
                     for g, need in zip(grads, ctx.needs_input_grad[:3])) + (None, None)


def flash_attention(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, *,
                    causal: bool = True) -> torch.Tensor:
    """q (B, H, Sq, hd), k and v (B, KV, Skv, hd) -> (B, H, Sq, hd) in q's
    dtype, differentiable in q, k and v."""
    with_lse = torch.is_grad_enabled() and any(t.requires_grad for t in (q, k, v))
    return FlashAttention.apply(q, k, v, causal, with_lse)
