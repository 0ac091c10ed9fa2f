"""The Mamba2 SSD chunk scan on a hand-written CUDA kernel for Hopper
(sm_90a).

Replaces ``repro/kernels/ssd_scan.py::ssd_scan`` (the Pallas TPU kernel
``_ssd_kernel``) and computes what the model's chunked path computes
(``ref.ssd_chunked``): x (B, S, H, P), dt (B, S, H) fp32, A (H,) fp32, B and
C (B, S, G, N), chunks of ``min(chunk, S)`` positions with the tail padded
by zeros, y (B, S, H, P) in x's type and the final state (B, H, P, N) in
fp32. x, B and C are fp32 or bf16 (the same type), P ≤ 64, N ≤ 128, the
chunk ≤ 4096. The kernel source is ``csrc/ssd_scan.cu``; its header says
what bounds it on the card and how it is laid out: a (batch, head)'s chunks
split over the CTAs of a thread-block cluster, the state passed from rank to
rank in order through distributed shared memory, B, C and x through TMA in
64-position tiles, and the chunk products on the tensor cores.

``plan`` gives what the launcher takes for a shape: the cluster size, the
groups of chunks each CTA walks, the ring's stages, the C buffers and the
shared memory a CTA uses. One launch per call whatever the shape.

x, B and C are read through their strides (unit stride along the last dim)
where a TMA map can (start and strides on 16 bytes), so the model's B and C,
which are views into one projection, are passed without a copy; head h reads
group h // (H / G). A tensor a map cannot read is copied into padded rows.
dt is read through any strides.

Build: at first use, ``kernels.build`` compiles the source into a shared
library with a plain C interface under ``build/kernels/``, loaded with
``ctypes``. Nothing is built when the module is imported.

On a CPU tensor ``ssd_scan`` takes the plain version (``ref.ssd_chunked``);
a CUDA tensor launches the kernel or raises. The launch is the custom op
``repro_torch::ssd_scan``, so a tracer sees it as one op: on a fake or meta
tensor (a shape-only trace, ``launch.dryrun``) it runs the op's fake
implementation, and ``torch.utils.flop_counter`` counts it by ``flops``,
the plain version's count. A call that nothing traces (``kbuild.traced``)
calls the launch directly, without the dispatcher. There is no initial
state: the TPU kernel starts from zeros. ``LAUNCHES`` counts kernel
launches.

Gradient (``SsdScan``): the TPU kernel has no VJP, and the reference's
Mamba2 mixer differentiates its jnp chunked scan. On the card its gradient
for x, dt, A, B and C is five more hand-written launches
(``csrc/ssd_scan_bwd.cu``: the chunks' states, the state pass, each chunk's
gradients, the cumsum's, the sums over heads), from the saved inputs, y's
cotangent and the final state's (absent, ``None``, or a tensor); a backward
counts five launches (``LAUNCHES`` and ``BACKWARD_LAUNCHES``). On the CPU it
takes the plain backward, ``ref.ssd_chunked_bwd``. The launches are the
custom op ``repro_torch::ssd_scan_bwd`` (fake implementation and FLOP
formula as the forward's). No atomics: the same inputs give bitwise the
same gradients. The backward runs in a profiler range,
``ssd_scan.backward``, that gives its device time.
"""
from __future__ import annotations

import ctypes
import dataclasses
import functools
from pathlib import Path
from typing import Optional

import torch
from torch.utils.flop_counter import register_flop_formula

from repro_torch.common import ceil_div, round_up
from repro_torch.kernels import build as kbuild
from repro_torch.kernels import ref

SOURCE = Path(__file__).resolve().parent / "csrc" / "ssd_scan.cu"
BWD_SOURCE = SOURCE.with_name("ssd_scan_bwd.cu")
SOURCES = (SOURCE, BWD_SOURCE)

#: kernel launches so far, forward and backward (the plain version is not
#: counted). Reset it to 0 to count one run.
LAUNCHES = 0
#: of those, the backward's (five a backward)
BACKWARD_LAUNCHES = 0

MAX_P, MAX_N, MAX_CHUNK = 64, 128, 4096
#: CTAs of a cluster that share a (batch, head)'s chunks, at most (portable)
MAX_CLUSTER = 8
#: shared memory a block may take on an H100, bytes
MAX_SMEM = 232448
#: (ring stages, C buffers) when the ring cannot hold a whole chunk's B and x
#: tiles, most first: the first whose shared memory fits
BUFFERS = ((3, 2), (2, 2), (2, 1))
#: the kernel's tiles: positions of a B or x tile, rows of a C tile, P padded
TJ, TI, PW = 64, 128, 64
_DTYPES = {torch.float32: 0, torch.bfloat16: 1}
_lib: Optional[ctypes.CDLL] = None
_bwd_lib: Optional[ctypes.CDLL] = None


@dataclasses.dataclass(frozen=True)
class Plan:
    """What one launch runs: ``chunk`` positions a chunk (``min(chunk, S)``),
    ``chunks`` of them per (batch, head), ``cluster`` CTAs per (batch, head)
    walking ``groups`` groups of ``cluster`` chunks (rank r owns chunk
    ``g * cluster + r`` of group g; ranks past the last chunk only pass the
    state on), ``stages`` ring stages of B and x tiles (``resident`` when
    they hold a whole chunk, loaded once; else the tiles stream through them
    and the y pass loads them again), ``cbufs`` C buffers, ``smem`` bytes of
    shared memory a CTA, ``ctas`` in all."""
    chunk: int
    chunks: int
    cluster: int
    groups: int
    stages: int
    resident: bool
    cbufs: int
    smem: int
    ctas: int


def smem_bytes(n: int, chunk: int, dtype: torch.dtype, stages: int, cbufs: int) -> int:
    """A CTA's shared memory for state size ``n`` and a chunk of ``chunk``
    positions: the ring, the C buffers, the (P, N) fp32 state, two floats a
    position over the chunk, 64 bytes of scalars, the mbarriers and 1024
    bytes to align the base. ``Layout`` in csrc/ssd_scan.cu computes the
    same."""
    e = torch.empty((), dtype=dtype).element_size()
    nw = 64 if n <= 64 else 128
    stage = TJ * (PW + nw) * e
    c_tile = TI * nw * e
    state = PW * (nw + 4) * 4
    qw = round_up(chunk, TJ)
    return stages * stage + cbufs * c_tile + state + 8 * qw + 64 + 8 * (stages + cbufs) + 1024


@functools.lru_cache(maxsize=1024)  # the model's shapes repeat at every layer
def plan(b: int, s: int, h: int, p: int, n: int, chunk: int, dtype: torch.dtype,
         sms: int = 132) -> Plan:
    """The launch of one scan (see ``Plan``) on a card of ``sms`` SMs. A
    (batch, head) with more than one chunk takes a cluster of 2 CTAs; of 4
    or 8 only while the CTAs would fill less than a quarter of the SMs; never
    more than its chunks, rounded up to a power of two, nor ``MAX_CLUSTER``.
    A longer sequence walks its chunks in groups of that many. (On an H100,
    clusters of 2 walking more groups were faster than clusters of 4 or 8
    at mamba2-370m's prefill and at B 2 S 4096, and clusters of 8 the
    fastest at B 1 H 8 S 4096; PERF.md, scripts/ssd_scan_variants.py.) The
    ring holds
    the chunk's tiles (resident) where that fits ``MAX_SMEM`` with two C
    buffers or one; else the buffers are the first of ``BUFFERS`` that
    fits. Raises on a shape the kernel does not take."""
    if min(b, s, h, p, n, chunk) <= 0 or p > MAX_P or n > MAX_N:
        raise ValueError(f"ssd_scan takes head_dim <= {MAX_P} and state <= {MAX_N}, "
                         f"got b {b} s {s} h {h} p {p} n {n} chunk {chunk}")
    q = min(chunk, s)
    if q > MAX_CHUNK:
        raise ValueError(f"chunk must be in [1, {MAX_CHUNK}], got {chunk}")
    nc = ceil_div(s, q)
    cluster = 1
    while cluster < min(nc, MAX_CLUSTER) and (cluster < 2 or 4 * b * h * cluster < sms):
        cluster *= 2
    tiles = ceil_div(q, TJ)
    for stages, cbufs in ((tiles, 2), (tiles, 1)) + BUFFERS:
        smem = smem_bytes(n, q, dtype, stages, cbufs)
        if smem <= MAX_SMEM:
            return Plan(q, nc, cluster, ceil_div(nc, cluster), stages, stages >= tiles, cbufs,
                        smem, b * h * cluster)
    raise ValueError(f"ssd_scan: no buffers fit {MAX_SMEM} bytes at n {n}, chunk {q}, "
                     f"{dtype}")


def build() -> Path:
    """Compile the forward's and the backward's libraries if these sources
    have not been built yet (in parallel); returns the forward's path."""
    return kbuild.build(*SOURCES)[0]


def _library() -> ctypes.CDLL:
    global _lib
    if _lib is None:
        lib = ctypes.CDLL(str(build()))
        vp, i32 = ctypes.c_void_p, ctypes.c_int
        lib.ssd_scan_launch.argtypes = [
            i32, vp, vp, vp, vp, vp, vp, vp, i32, i32, i32, i32, i32, i32, i32, i32, i32, i32,
            vp, vp,
        ]
        lib.ssd_scan_launch.restype = i32
        lib.ssd_scan_smem.argtypes = [i32, i32, i32, i32, i32]
        lib.ssd_scan_smem.restype = i32
        _lib = lib
    return _lib


def _bwd_library() -> ctypes.CDLL:
    global _bwd_lib
    if _bwd_lib is None:
        lib = ctypes.CDLL(str(kbuild.build(BWD_SOURCE)[0]))
        vp, i32 = ctypes.c_void_p, ctypes.c_int
        lib.ssd_scan_bwd_launch.argtypes = [i32] + [vp] * 13 + [i32] * 7 + [vp, vp]
        lib.ssd_scan_bwd_launch.restype = i32
        lib.ssd_scan_bwd_workspace.argtypes = [i32] * 6
        lib.ssd_scan_bwd_workspace.restype = ctypes.c_longlong
        _bwd_lib = lib
    return _bwd_lib


def _tma_strides(t: torch.Tensor) -> Optional[tuple[int, int, int]]:
    """The (batch, position, head or group) element strides a TMA map reads
    ``t`` (B, S, heads, inner) through: each on 16 bytes, and the start too;
    an axis of one element takes any such stride. None when ``t`` has none."""
    align = 16 // t.element_size()
    if not kbuild.start_aligned(t) or t.stride(3) != 1:
        return None
    out = []
    for axis in range(3):
        stride = t.stride(axis) if t.shape[axis] > 1 else round_up(t.shape[3], align)
        if stride <= 0 or stride % align:
            return None
        out.append(stride)
    return tuple(out)


def _operand(t: torch.Tensor) -> tuple[torch.Tensor, tuple[int, int, int]]:
    """(t, its strides) where a TMA map can read ``t`` as it lies; else a copy
    whose rows are padded to 16 bytes (a fresh allocation), and its strides."""
    strides = _tma_strides(t)
    if strides is not None:
        return t, strides
    align = 16 // t.element_size()
    buf = t.new_empty(t.shape[:3] + (round_up(t.shape[3], align),))[..., :t.shape[3]]
    buf.copy_(t)
    return buf, _tma_strides(buf)


def launch(x: torch.Tensor, dt: torch.Tensor, A: torch.Tensor, B: torch.Tensor,
           C: torch.Tensor, *, chunk: int) -> tuple[torch.Tensor, torch.Tensor]:
    """One launch of the kernel. Returns (y, final_state) as new contiguous
    tensors. Raises on anything the kernel does not take. The launch itself
    (``_launch``) is the custom op ``repro_torch::ssd_scan``, called as one
    where ``kbuild.traced`` says so; on a fake or meta tensor the op runs
    its fake implementation, which launches nothing, after the same checks
    and operand copies as on the card."""
    if x.device.type not in ("cuda", "meta"):
        raise ValueError(f"the ssd_scan kernel runs on CUDA tensors, got {x.device}")
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
    (xk, _), (bk, _), (ck, _) = _operand(x), _operand(B), _operand(C)
    launch_op = torch.ops.repro_torch.ssd_scan if kbuild.traced(xk, dt, A, bk, ck) else _launch
    return launch_op(xk, dt, A, bk, ck, q)


def _launch(x: torch.Tensor, dt: torch.Tensor, A: torch.Tensor, B: torch.Tensor,
            C: torch.Tensor, chunk: int) -> tuple[torch.Tensor, torch.Tensor]:
    """The kernel's launch on ``launch``'s operands (x, B and C readable by
    TMA maps; ``chunk`` already ``min(chunk, S)``): new contiguous y and
    final state."""
    global LAUNCHES
    sms = kbuild.require_sm90(x, "ssd_scan")
    b, s, h, p = x.shape
    g, n = B.shape[2], B.shape[3]
    pl = plan(b, s, h, p, n, chunk, x.dtype, sms)
    y = torch.empty((b, s, h, p), device=x.device, dtype=x.dtype)
    state = torch.empty((b, h, p, n), device=x.device, dtype=torch.float32)
    strides = (ctypes.c_longlong * 15)(*_tma_strides(x), *y.stride()[:3], *dt.stride(),
                                       *_tma_strides(B), *_tma_strides(C))
    lib = _library()
    index = x.device.index
    args = (_DTYPES[x.dtype], x.data_ptr(), dt.data_ptr(), A.data_ptr(), B.data_ptr(),
            C.data_ptr(), y.data_ptr(), state.data_ptr(), b, s, h, g, p, n, chunk, pl.cluster,
            pl.stages, pl.cbufs, strides)
    if index == torch.cuda.current_device():
        err = lib.ssd_scan_launch(*args, torch.cuda.current_stream(index).cuda_stream)
    else:
        with torch.cuda.device(index):
            err = lib.ssd_scan_launch(*args, torch.cuda.current_stream(index).cuda_stream)
    if err != 0:
        raise RuntimeError(f"ssd_scan kernel launch failed: CUDA error {err}")
    LAUNCHES += 1
    return y, state


_op = torch.library.custom_op("repro_torch::ssd_scan", _launch, mutates_args=(),
                              device_types="cuda")


@_op.register_fake
def _(x, dt, A, B, C, chunk):
    b, s, h, p = x.shape
    return x.new_empty((b, s, h, p)), x.new_empty((b, h, p, B.shape[3]), dtype=torch.float32)


@register_flop_formula(torch.ops.repro_torch.ssd_scan)
def flops(x_shape, dt_shape, a_shape, b_shape, c_shape, chunk: int, *args, out_shape=None,
          **kwargs) -> int:
    """What the plain version (``ref.ssd_chunked``) counts: per chunk of Q
    positions, its four products (C·Bᵀ, the scores with x, C with the
    carried state, the state's update), 2·B·H·Q·(Q·N + Q·P + 2·P·N)."""
    b, s, h, p = x_shape
    n = b_shape[3]
    q = min(chunk, s)
    return ceil_div(s, q) * 2 * b * h * q * (q * n + q * p + 2 * p * n)


def launch_bwd(x: torch.Tensor, dt: torch.Tensor, A: torch.Tensor, B: torch.Tensor,
               C: torch.Tensor, dy: torch.Tensor, dstate: Optional[torch.Tensor], *,
               chunk: int) -> tuple[torch.Tensor, ...]:
    """The backward kernels' five launches: (dx, ddt, dA, dB, dC), new
    contiguous tensors in the inputs' dtypes, from the forward's inputs (as
    ``launch`` takes them), y's cotangent ``dy`` (x's shape and dtype) and
    the final state's ``dstate`` ((B, H, P, N) fp32, or None). Every tensor
    is read through its strides. Raises on anything the kernels do not
    take. The launches (``_launch_bwd``) are the custom op
    ``repro_torch::ssd_scan_bwd``, called as one where ``kbuild.traced``
    says so."""
    if x.device.type not in ("cuda", "meta"):
        raise ValueError(f"the ssd_scan backward runs on CUDA tensors, got {x.device}")
    if x.dtype not in _DTYPES:
        raise TypeError(f"ssd_scan takes float32 or bfloat16 x, got {x.dtype}")
    b, s, h, p = x.shape
    g, n = B.shape[2], B.shape[3]
    if (dt.shape != (b, s, h) or A.shape != (h,) or B.shape[:2] != (b, s) or B.shape != C.shape
            or h % g or p > MAX_P or n > MAX_N):
        raise ValueError(f"shapes the ssd_scan backward does not take: x {tuple(x.shape)}, "
                         f"dt {tuple(dt.shape)}, A {tuple(A.shape)}, B and C {tuple(B.shape)}")
    q = min(int(chunk), s)
    if not 1 <= q <= MAX_CHUNK:
        raise ValueError(f"chunk must be in [1, {MAX_CHUNK}], got {chunk}")
    for t, what in ((B, "B"), (C, "C"), (dy, "dy")):
        if t.device != x.device or t.dtype != x.dtype:
            raise ValueError(f"{what} must match x ({x.dtype} on {x.device}); "
                             f"got {t.dtype} on {t.device}")
    if dy.shape != x.shape:
        raise ValueError(f"dy {tuple(dy.shape)} does not match x {tuple(x.shape)}")
    for t, what in ((dt, "dt"), (A, "A")) + (((dstate, "dstate"),) if dstate is not None else ()):
        if t.device != x.device or t.dtype != torch.float32:
            raise ValueError(f"{what} must be float32 on {x.device}; got {t.dtype} on {t.device}")
    if dstate is not None:
        if dstate.shape != (b, h, p, n):
            raise ValueError(f"dstate {tuple(dstate.shape)} is not {(b, h, p, n)}")
        dstate = dstate.contiguous()
    A = A.contiguous()
    args = (x, dt, A, B, C, dy, dstate)
    traced = kbuild.traced(*(t for t in args if t is not None))
    launch_op = torch.ops.repro_torch.ssd_scan_bwd if traced else _launch_bwd
    return launch_op(*args, q)


def _launch_bwd(x: torch.Tensor, dt: torch.Tensor, A: torch.Tensor, B: torch.Tensor,
                C: torch.Tensor, dy: torch.Tensor, dstate: Optional[torch.Tensor],
                chunk: int) -> tuple[torch.Tensor, torch.Tensor, torch.Tensor, torch.Tensor,
                                     torch.Tensor]:
    """The backward's launches on ``launch_bwd``'s operands (``chunk``
    already ``min(chunk, S)``), with their fp32 workspace."""
    global LAUNCHES, BACKWARD_LAUNCHES
    kbuild.require_sm90(x, "ssd_scan")
    b, s, h, p = x.shape
    g, n = B.shape[2], B.shape[3]
    dx = torch.empty((b, s, h, p), device=x.device, dtype=x.dtype)
    ddt = torch.empty((b, s, h), device=x.device, dtype=torch.float32)
    dA = torch.empty((h,), device=x.device, dtype=torch.float32)
    dB = torch.empty((b, s, g, n), device=x.device, dtype=x.dtype)
    dC = torch.empty_like(dB)
    lib = _bwd_library()
    ws = torch.empty((lib.ssd_scan_bwd_workspace(b, s, h, p, n, chunk),), device=x.device,
                     dtype=torch.float32)
    strides = (ctypes.c_longlong * 19)(*x.stride(), *dt.stride(), *B.stride(), *C.stride(),
                                       *dy.stride())
    with torch.cuda.device(x.device):
        err = lib.ssd_scan_bwd_launch(
            _DTYPES[x.dtype], x.data_ptr(), dt.data_ptr(), A.data_ptr(), B.data_ptr(),
            C.data_ptr(), dy.data_ptr(), None if dstate is None else dstate.data_ptr(),
            dx.data_ptr(), ddt.data_ptr(), dA.data_ptr(), dB.data_ptr(), dC.data_ptr(),
            ws.data_ptr(), b, s, h, g, p, n, chunk, strides,
            torch.cuda.current_stream(x.device).cuda_stream)
    if err != 0:
        raise RuntimeError(f"ssd_scan backward launch failed: CUDA error {err}")
    LAUNCHES += 5
    BACKWARD_LAUNCHES += 5
    return dx, ddt, dA, dB, dC


_bwd_op = torch.library.custom_op("repro_torch::ssd_scan_bwd", _launch_bwd, mutates_args=(),
                                  device_types="cuda")


@_bwd_op.register_fake
def _(x, dt, A, B, C, dy, dstate, chunk):
    b, s, h, p = x.shape
    return (x.new_empty((b, s, h, p)), x.new_empty((b, s, h), dtype=torch.float32),
            x.new_empty((h,), dtype=torch.float32), x.new_empty(B.shape), x.new_empty(B.shape))


@register_flop_formula(torch.ops.repro_torch.ssd_scan_bwd)
def bwd_flops(x_shape, dt_shape, a_shape, b_shape, c_shape, dy_shape, dstate_shape, chunk: int,
              *args, out_shape=None, **kwargs) -> int:
    """What the plain backward (``ref.ssd_chunked_bwd``) counts: per chunk of
    Q positions, its products, 2·B·H·Q·(6·P·N + Q·(3·N + 2·P)): the two
    state terms, their use in dx, dB, dC and the cumsum's cotangent (six
    Q·P·N products), and C·Bᵀ, dy·xdtᵀ, dx's, dC's and dB's Q·Q products."""
    b, s, h, p = x_shape
    n = b_shape[3]
    q = min(chunk, s)
    return ceil_div(s, q) * 2 * b * h * q * (6 * p * n + q * (3 * n + 2 * p))


class SsdScan(torch.autograd.Function):
    """The kernel (or, on the CPU, the plain version), with the backward
    kernels (on the CPU the plain backward) as its gradient (see the module
    docstring)."""

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
        x, dt, A, B, C = ctx.saved_tensors
        if dy is None:  # only the final state is used
            dy = torch.zeros_like(x)
        with torch.profiler.record_function("ssd_scan.backward"):
            if x.device.type == "cpu":
                grads = ref.ssd_chunked_bwd(x, dt, A, B, C, dy, dstate, ctx.chunk)
            else:
                grads = launch_bwd(x, dt, A, B, C, dy, dstate, chunk=ctx.chunk)
        return tuple(g if need else None
                     for g, need in zip(grads, ctx.needs_input_grad[:5])) + (None,)


def ssd_scan(x: torch.Tensor, dt: torch.Tensor, A: torch.Tensor, B: torch.Tensor,
             C: torch.Tensor, *, chunk: int) -> tuple[torch.Tensor, torch.Tensor]:
    """(y (B,S,H,P) in x's dtype, final_state (B,H,P,N) fp32),
    differentiable in x, dt, A, B and C."""
    return SsdScan.apply(x, dt, A, B, C, chunk)
