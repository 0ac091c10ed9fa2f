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
``LAUNCHES`` counts kernel launches.

Gradient (``FlashAttention``): the TPU kernel has no VJP, and the reference's
models differentiate their jnp attention, the same function. So backward
recomputes the plain version from the saved q, k and v, on their device, and
takes autograd's VJP of it. The forward on the card still launches the
kernel; a backward kernel is later work. The backward runs in a profiler
range, ``flash_attention.backward``, that gives its device time.
"""
from __future__ import annotations

import ctypes
import math
from pathlib import Path
from typing import Optional

import torch

from repro_torch.kernels import build as kbuild
from repro_torch.kernels import ref

SOURCE = Path(__file__).resolve().parent / "csrc" / "flash_attention.cu"

#: kernel launches so far (the plain version is not counted). Reset it to 0
#: to count one run.
LAUNCHES = 0

HEAD_DIMS = (16, 32, 64, 80, 112, 128, 256)
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
        lib.flash_attention_launch.argtypes = [
            i32, i32, vp, vp, vp, vp, i32, i32, i32, i32, i32, vp, i32,
            ctypes.c_float, vp,
        ]
        lib.flash_attention_launch.restype = i32
        _lib = lib
    return _lib


def _aligned16(t: torch.Tensor) -> bool:
    """Start and (batch, head, row) strides on 16-byte boundaries."""
    size = t.element_size()
    return t.data_ptr() % 16 == 0 and all(s * size % 16 == 0 for s in t.stride()[:3])


def launch(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, *,
           causal: bool) -> torch.Tensor:
    """One launch of the kernel. q (B, H, Sq, hd), k and v (B, KV, Skv, hd),
    any strides with unit stride along hd. Returns (B, H, Sq, hd) as a view
    of a new (B, Sq, H, hd) tensor, the model's layout. Raises on anything
    the kernel does not take."""
    global LAUNCHES
    kbuild.require_sm90(q, "flash_attention")
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
    out = torch.empty((b, sq, h, hd), device=q.device, dtype=q.dtype).transpose(1, 2)
    strides = (ctypes.c_longlong * 12)(*(s for t in (q, k, v, out) for s in t.stride()[:3]))
    lib = _library()
    with torch.cuda.device(q.device):
        err = lib.flash_attention_launch(
            _DTYPES[q.dtype], hd, q.data_ptr(), k.data_ptr(), v.data_ptr(),
            out.data_ptr(), b, h, kvh, sq, skv, strides, int(causal),
            1.0 / math.sqrt(hd), torch.cuda.current_stream(q.device).cuda_stream)
    if err != 0:
        raise RuntimeError(f"flash_attention kernel launch failed: CUDA error {err}")
    LAUNCHES += 1
    return out


class FlashAttention(torch.autograd.Function):
    """The kernel (or, on the CPU, the plain version), with the plain
    version's VJP as its gradient (see the module docstring)."""

    @staticmethod
    def forward(ctx, q, k, v, causal):
        ctx.causal = causal
        ctx.save_for_backward(q, k, v)
        if q.device.type == "cpu":
            return ref.flash_attention_ref(q, k, v, causal=causal)
        return launch(q, k, v, causal=causal)

    @staticmethod
    def backward(ctx, do):
        with torch.profiler.record_function("flash_attention.backward"):
            return ref.vjp(lambda q, k, v: ref.flash_attention_ref(q, k, v, causal=ctx.causal),
                           ctx.saved_tensors, ctx.needs_input_grad[:3], (do,)) + (None,)


def flash_attention(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, *,
                    causal: bool = True) -> torch.Tensor:
    """q (B, H, Sq, hd), k and v (B, KV, Skv, hd) -> (B, H, Sq, hd) in q's
    dtype, differentiable in q, k and v."""
    return FlashAttention.apply(q, k, v, causal)
