"""The paper's NAS model families: IBN-based ConvNets (MobileNetV2 S1,
EfficientNet-B0 S2) and the evolved EdgeTPU space (per-layer IBN vs Fused-IBN,
tunable kernel / expansion / filter-multiplier / groups — Sec. 3.2).

PyTorch counterpart of ``repro/models/convnets.py``. The spec and layer-op
export half is a copy of the reference; ``init``, ``block_apply`` and
``forward`` are torch. The public layout stays the reference's: NHWC images
and HWIO weights in a plain nested dict, so a reference parameter tree
converts one to one (``params_from_reference``).

Every 1×1 convolution (expand, project, SE reduce/expand, head) is stride 1
with no bias, so on a contiguous NHWC tensor it is exactly
``x.reshape(-1, Cin) @ w.reshape(Cin, Cout)``; those products go through
``kernels.ops.ibn_pointwise`` (the hand-written CUDA kernel on the card).
Only the SE reduce conv has the conv → relu form the kernel's epilogue
fuses; the others run with ``act="none"`` and no bias, then GroupNorm and
the activation in plain torch. Stem, depthwise and fused k×k convolutions
use ``F.conv2d`` with XLA's ``"SAME"`` padding computed explicitly.
"""
from __future__ import annotations

import math
from dataclasses import dataclass, replace

import torch
import torch.nn.functional as F

from repro_torch.common import FifoDict, dtype_of, fold_seed, tree_from_numpy
from repro_torch.common import tree_leaves  # noqa: F401  (callers walk params with it)
from repro_torch.kernels import ops

# ---------------------------------------------------------------------------
# Specs
# ---------------------------------------------------------------------------


@dataclass(frozen=True)
class BlockSpec:
    op: str = "ibn"  # "ibn" | "fused"
    kernel: int = 3  # {3, 5, 7}
    expansion: int = 6  # {1, 3, 6}
    filters: int = 16  # output channels
    stride: int = 1
    groups: int = 1  # for the fused conv  {1, 2}
    se: bool = False  # squeeze-and-excite
    act: str = "relu"  # "relu" | "swish"

    def __hash__(self):
        # memoized (specs are dict keys on the search hot path: layer-op /
        # layer-matrix / accuracy caches); same field tuple the generated
        # __hash__ uses, so hash/eq semantics are unchanged
        h = self.__dict__.get("_hash")
        if h is None:
            h = hash((self.op, self.kernel, self.expansion, self.filters,
                      self.stride, self.groups, self.se, self.act))
            object.__setattr__(self, "_hash", h)
        return h


@dataclass(frozen=True)
class ConvNetSpec:
    name: str
    blocks: tuple[BlockSpec, ...]
    stem_filters: int = 32
    head_filters: int = 1280
    num_classes: int = 1000
    image_size: int = 224
    param_dtype: str = "float32"

    def __hash__(self):
        # memoized; see BlockSpec.__hash__
        h = self.__dict__.get("_hash")
        if h is None:
            h = hash((self.name, self.blocks, self.stem_filters,
                      self.head_filters, self.num_classes, self.image_size,
                      self.param_dtype))
            object.__setattr__(self, "_hash", h)
        return h


# ---------------------------------------------------------------------------
# Reference model families (Sec. 3.2.1 / 3.2.2)
# ---------------------------------------------------------------------------

# (expansion, filters, repeats, stride, kernel)
_MBV2_STAGES = [
    (1, 16, 1, 1, 3),
    (6, 24, 2, 2, 3),
    (6, 32, 3, 2, 3),
    (6, 64, 4, 2, 3),
    (6, 96, 3, 1, 3),
    (6, 160, 3, 2, 3),
    (6, 320, 1, 1, 3),
]

_EFFNET_B0_STAGES = [
    (1, 16, 1, 1, 3),
    (6, 24, 2, 2, 3),
    (6, 40, 2, 2, 5),
    (6, 80, 3, 2, 3),
    (6, 112, 3, 1, 5),
    (6, 192, 4, 2, 5),
    (6, 320, 1, 1, 3),
]


def _expand_stages(stages, se=False, act="relu") -> tuple[BlockSpec, ...]:
    blocks = []
    for exp, f, r, s, k in stages:
        for i in range(r):
            blocks.append(
                BlockSpec(
                    op="ibn", kernel=k, expansion=exp, filters=f,
                    stride=s if i == 0 else 1, se=se, act=act,
                )
            )
    return tuple(blocks)


def mobilenet_v2(num_classes=1000, image_size=224, width=1.0) -> ConvNetSpec:
    blocks = tuple(
        replace(b, filters=max(8, int(b.filters * width)))
        for b in _expand_stages(_MBV2_STAGES)
    )
    return ConvNetSpec(
        "mobilenet_v2", blocks, stem_filters=max(8, int(32 * width)),
        head_filters=1280, num_classes=num_classes, image_size=image_size,
    )


def efficientnet_b0(num_classes=1000, image_size=224, se=True, swish=True) -> ConvNetSpec:
    """'wo SE/Swish' baselines in Table 3 use se=False, swish=False."""
    blocks = _expand_stages(_EFFNET_B0_STAGES, se=se, act="swish" if swish else "relu")
    return ConvNetSpec(
        "efficientnet_b0", blocks, stem_filters=32, head_filters=1280,
        num_classes=num_classes, image_size=image_size,
    )


def manual_edgetpu(num_classes=1000, image_size=224, size="s") -> ConvNetSpec:
    """Manually crafted model on the evolved space (Sec. 3.2.2): Fused-IBN in
    the early layers, conventional IBN later."""
    base = efficientnet_b0(num_classes, image_size, se=False, swish=False)
    n_fused = 6 if size == "s" else 9
    blocks = tuple(
        replace(b, op="fused" if i < n_fused else "ibn")
        for i, b in enumerate(base.blocks)
    )
    width = 1.0 if size == "s" else 1.2
    blocks = tuple(replace(b, filters=int(b.filters * width)) for b in blocks)
    return ConvNetSpec(
        f"manual_edgetpu_{size}", blocks, stem_filters=32, head_filters=1280,
        num_classes=num_classes, image_size=image_size,
    )



# ---------------------------------------------------------------------------
# Functional model (torch)
# ---------------------------------------------------------------------------


def _conv_init(gen, kh, kw, cin, cout, dtype, device, groups=1):
    fan_in = kh * kw * cin // groups
    std = math.sqrt(2.0 / fan_in)
    w = torch.randn((kh, kw, cin // groups, cout), generator=gen) * std
    return w.to(device=device, dtype=dtype)


def _same_pads(size: int, k: int, stride: int) -> tuple[int, int]:
    """XLA's ``"SAME"`` padding of one spatial axis. The extra pixel of an
    odd total goes on the high side: a 3×3 stride-2 conv on an even size
    pads (0, 1), where ``padding=k // 2`` would pad (1, 1) and shift every
    output pixel."""
    total = max((-(-size // stride) - 1) * stride + k - size, 0)
    return total // 2, total - total // 2


def _conv(x, w, stride=1, groups=1):
    """NHWC ``x`` ⊛ HWIO ``w`` → NHWC, with lax ``"SAME"`` padding."""
    top, bottom = _same_pads(x.shape[1], w.shape[0], stride)
    left, right = _same_pads(x.shape[2], w.shape[1], stride)
    if top or bottom or left or right:
        x = F.pad(x, (0, 0, left, right, top, bottom))
    # HWIO -> OIHW; a grouped kernel keeps I = cin / groups, a depthwise
    # kernel (k, k, 1, C) becomes (C, 1, k, k)
    y = F.conv2d(x.permute(0, 3, 1, 2), w.permute(3, 2, 0, 1), stride=stride,
                 groups=groups)
    return y.permute(0, 2, 3, 1)


def _depthwise(x, w, stride=1):
    return _conv(x, w, stride, groups=x.shape[-1])


def _pointwise(x, w, act="none"):
    """Bias-free 1×1 conv of NHWC ``x`` with a (1, 1, Cin, Cout) kernel, as
    one (pixels × Cin) · (Cin × Cout) product through ``ibn_pointwise``."""
    cin, cout = w.shape[-2], w.shape[-1]
    y = ops.ibn_pointwise(x.reshape(-1, cin), w.reshape(cin, cout), None,
                          act=act)
    return y.reshape(x.shape[:-1] + (cout,))


def _gn_init(c, dtype, device):
    return {"scale": torch.ones((c,), dtype=dtype, device=device),
            "bias": torch.zeros((c,), dtype=dtype, device=device)}


def _gn(params, x, groups=8):
    """GroupNorm over NHWC ``x``: gcd(8, C) groups, population variance,
    eps 1e-5, computed in fp32 (as the reference)."""
    c = x.shape[-1]
    g = math.gcd(groups, c)
    xs = x.reshape(x.shape[:-1] + (g, c // g)).float()
    mean = xs.mean(dim=(1, 2, 4), keepdim=True)
    var = xs.var(dim=(1, 2, 4), correction=0, keepdim=True)
    xs = (xs - mean) * torch.rsqrt(var + 1e-5)
    return xs.reshape(x.shape) * params["scale"] + params["bias"]


def _act(x, kind):
    return F.silu(x) if kind == "swish" else F.relu(x)


def init_block_params(gen, spec: BlockSpec, cin: int, dtype, device) -> dict:
    mid = cin * spec.expansion
    p = {}
    if spec.op == "fused":
        p["fused_w"] = _conv_init(gen, spec.kernel, spec.kernel, cin, mid, dtype,
                                  device, groups=spec.groups)
        p["fused_gn"] = _gn_init(mid, dtype, device)
    else:
        p["expand_w"] = _conv_init(gen, 1, 1, cin, mid, dtype, device)
        p["expand_gn"] = _gn_init(mid, dtype, device)
        p["dw_w"] = _conv_init(gen, spec.kernel, spec.kernel, 1, mid, dtype, device)
        p["dw_gn"] = _gn_init(mid, dtype, device)
    if spec.se:
        se_dim = max(1, cin // 4)
        p["se_reduce"] = _conv_init(gen, 1, 1, mid, se_dim, dtype, device)
        p["se_expand"] = _conv_init(gen, 1, 1, se_dim, mid, dtype, device)
    p["project_w"] = _conv_init(gen, 1, 1, mid, spec.filters, dtype, device)
    p["project_gn"] = _gn_init(spec.filters, dtype, device)
    return p


def block_apply(p: dict, x, spec: BlockSpec):
    cin = x.shape[-1]
    h = x
    if spec.op == "fused":
        h = _act(_gn(p["fused_gn"], _conv(h, p["fused_w"], spec.stride, spec.groups)),
                 spec.act)
    else:
        h = _act(_gn(p["expand_gn"], _pointwise(h, p["expand_w"])), spec.act)
        h = _act(_gn(p["dw_gn"], _depthwise(h, p["dw_w"], spec.stride)), spec.act)
    if spec.se:
        s = h.mean(dim=(1, 2), keepdim=True)
        s = _pointwise(s, p["se_reduce"], act="relu")  # fused in the epilogue
        s = torch.sigmoid(_pointwise(s, p["se_expand"]))
        h = h * s
    h = _gn(p["project_gn"], _pointwise(h, p["project_w"]))
    if spec.stride == 1 and cin == spec.filters:
        h = h + x
    return h


def init(seed: int, spec: ConvNetSpec, device="cuda") -> dict:
    """Fresh parameters from ``seed`` (one named generator per layer group).
    Same shapes, layouts and init distributions as the reference's ``init``;
    not the same numbers, since ``jax.random`` is not reproduced."""
    dtype = dtype_of(spec.param_dtype)
    params = {
        "stem_w": _conv_init(fold_seed(seed, "stem"), 3, 3, 3, spec.stem_filters,
                             dtype, device),
        "stem_gn": _gn_init(spec.stem_filters, dtype, device),
        "blocks": [],
    }
    cin = spec.stem_filters
    for i, b in enumerate(spec.blocks):
        params["blocks"].append(
            init_block_params(fold_seed(seed, f"block{i}"), b, cin, dtype, device)
        )
        cin = b.filters
    params["head_w"] = _conv_init(fold_seed(seed, "head"), 1, 1, cin,
                                  spec.head_filters, dtype, device)
    params["head_gn"] = _gn_init(spec.head_filters, dtype, device)
    params["classifier"] = (
        torch.randn((spec.head_filters, spec.num_classes),
                    generator=fold_seed(seed, "cls")) * 0.01
    ).to(device=device, dtype=dtype)
    return params


def params_from_reference(np_params: dict, device="cuda") -> dict:
    """The reference's parameter tree, with numpy arrays for leaves
    (``jax.tree.map(np.asarray, params)``), as the port's parameters: the
    same nesting and HWIO layouts, as tensors on ``device``."""
    return tree_from_numpy(np_params, device)


def forward(params: dict, images: torch.Tensor, spec: ConvNetSpec) -> torch.Tensor:
    """images: (B, H, W, 3) -> logits (B, num_classes)."""
    x = _act(_gn(params["stem_gn"], _conv(images, params["stem_w"], 2)), "relu")
    for p, b in zip(params["blocks"], spec.blocks):
        x = block_apply(p, x, b)
    x = _act(_gn(params["head_gn"], _pointwise(x, params["head_w"])), "relu")
    x = x.mean(dim=(1, 2))
    return (x @ params["classifier"]).float()

# ---------------------------------------------------------------------------
# Layer-op export for the accelerator simulator
# ---------------------------------------------------------------------------


@dataclass(frozen=True)
class LayerOp:
    op: str          # conv | dwconv | matmul
    h: int
    w: int
    cin: int
    cout: int
    kernel: int
    stride: int
    groups: int = 1


_LAYER_OPS_CACHE: FifoDict = FifoDict(4096)


def layer_ops(spec: ConvNetSpec) -> list[LayerOp]:
    key = spec  # frozen dataclass: hashable
    hit = _LAYER_OPS_CACHE.get(key)
    if hit is not None:
        return hit
    out = _layer_ops_impl(spec)
    _LAYER_OPS_CACHE[key] = out
    return out


def _layer_ops_impl(spec: ConvNetSpec) -> list[LayerOp]:
    ops: list[LayerOp] = []
    size = spec.image_size
    ops.append(LayerOp("conv", size, size, 3, spec.stem_filters, 3, 2))
    size = (size + 1) // 2
    cin = spec.stem_filters
    for b in spec.blocks:
        mid = cin * b.expansion
        if b.op == "fused":
            ops.append(LayerOp("conv", size, size, cin, mid, b.kernel, b.stride,
                               b.groups))
            size = (size + b.stride - 1) // b.stride
        else:
            ops.append(LayerOp("conv", size, size, cin, mid, 1, 1))
            ops.append(LayerOp("dwconv", size, size, mid, mid, b.kernel, b.stride))
            size = (size + b.stride - 1) // b.stride
        if b.se:
            se_dim = max(1, cin // 4)
            ops.append(LayerOp("conv", 1, 1, mid, se_dim, 1, 1))
            ops.append(LayerOp("conv", 1, 1, se_dim, mid, 1, 1))
        ops.append(LayerOp("conv", size, size, mid, b.filters, 1, 1))
        cin = b.filters
    ops.append(LayerOp("conv", size, size, cin, spec.head_filters, 1, 1))
    ops.append(LayerOp("matmul", 1, 1, spec.head_filters, spec.num_classes, 1, 1))
    return ops


def block_rows(b: BlockSpec, cin: int, size: int) -> tuple[list, int]:
    """Flat numeric rows [is_dw, h, w, cin, cout, k, stride, groups] × layers
    for ONE block applied at input (cin, size); returns (flat, size_out).
    Mirrors the per-block body of ``_layer_ops_impl`` (column 0 encodes
    ``op == "dwconv"``) without constructing one dataclass per layer — the
    batched simulator (repro.core.simulator.layer_matrix) caches the
    np-ified rows per (block, cin, size), so the build cost amortizes across
    every candidate sharing a block configuration. The engine parity tests
    (batched vs looped records) pin the two implementations in sync."""
    flat: list = []
    ext = flat.extend
    mid = cin * b.expansion
    if b.op == "fused":
        ext((0, size, size, cin, mid, b.kernel, b.stride, b.groups))
        size = (size + b.stride - 1) // b.stride
    else:
        ext((0, size, size, cin, mid, 1, 1, 1))
        ext((1, size, size, mid, mid, b.kernel, b.stride, 1))
        size = (size + b.stride - 1) // b.stride
    if b.se:
        se_dim = max(1, cin // 4)
        ext((0, 1, 1, mid, se_dim, 1, 1, 1))
        ext((0, 1, 1, se_dim, mid, 1, 1, 1))
    ext((0, size, size, mid, b.filters, 1, 1, 1))
    return flat, size


def count_params(spec: ConvNetSpec) -> int:
    n = 0
    for op in layer_ops(spec):
        n += op.kernel * op.kernel * (op.cin // op.groups) * op.cout \
            if op.op != "dwconv" else op.kernel * op.kernel * op.cout
    return n


def count_flops(spec: ConvNetSpec) -> int:
    """Multiply-adds ×2 over a single image."""
    n = 0
    for op in layer_ops(spec):
        out_hw = -(-op.h // op.stride) * (-(-op.w // op.stride))
        if op.op == "dwconv":
            n += 2 * out_hw * op.cout * op.kernel * op.kernel
        else:
            n += 2 * out_hw * op.cout * op.kernel * op.kernel * op.cin // op.groups
    return n
