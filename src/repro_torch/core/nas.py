"""The paper's NAS search spaces.

S1  (Sec. 3.2.1): MobileNetV2 — kernel {3,5,7} + expansion {3,6} per inverted
    residual block (first block fixed at expansion 1). 17 blocks.
S2  (Sec. 3.2.1): EfficientNet-B0 — same knobs, 16 blocks.
S3  (Sec. 3.2.2): the evolved EdgeTPU space — adds per-layer op type
    {IBN, Fused-IBN}, filter-scaling multiplier and group count ("we use
    PyGlove to tune filter size, kernel size, expansion factor, and groups").
"""
from __future__ import annotations

from dataclasses import replace

from repro_torch.core.space import Choice, Space
from repro_torch.models import convnets as C


def _blockwise_space(
    base: C.ConvNetSpec,
    name: str,
    evolved: bool = False,
) -> Space:
    choices: list[Choice] = []
    for i, b in enumerate(base.blocks):
        choices.append(Choice(f"b{i}_kernel", (3, 5, 7)))
        if i > 0:
            choices.append(Choice(f"b{i}_exp", (3, 6)))
        if evolved:
            choices.append(Choice(f"b{i}_op", ("ibn", "fused")))
            choices.append(Choice(f"b{i}_filters", (0.75, 1.0, 1.25)))
            choices.append(Choice(f"b{i}_groups", (1, 2)))

    # Decoded blocks are memoized per (block index, cin, decisions): BlockSpec
    # is frozen, so sharing instances across decoded specs is safe, and batch
    # decoding (EvaluationEngine) skips most dataclasses.replace calls. Key
    # names are precomputed once (f-strings per decode call added up on the
    # engine hot path).
    block_cache: dict = {}
    _KN = [f"b{i}_kernel" for i in range(len(base.blocks))]
    _EN = [f"b{i}_exp" for i in range(len(base.blocks))]
    _ON = [f"b{i}_op" for i in range(len(base.blocks))]
    _FN = [f"b{i}_filters" for i in range(len(base.blocks))]
    _GN = [f"b{i}_groups" for i in range(len(base.blocks))]

    def _block(i: int, b: C.BlockSpec, cin: int, d: dict) -> C.BlockSpec:
        if evolved:
            key = (i, cin, d[_KN[i]], d.get(_EN[i]),
                   d[_ON[i]], d[_FN[i]], d[_GN[i]])
        else:
            # cin is a function of i alone when filters aren't searched
            key = (i, d[_KN[i]], d.get(_EN[i]))
        nb = block_cache.get(key)
        if nb is not None:
            return nb
        nb = replace(
            b,
            kernel=d[_KN[i]],
            expansion=d.get(_EN[i], 1 if i == 0 else b.expansion),
        )
        if evolved:
            filters = max(8, int(round(b.filters * d[_FN[i]] / 8)) * 8)
            groups = d[_GN[i]]
            if cin % groups != 0:  # grouped conv must divide cin
                groups = 1
            nb = replace(
                nb,
                op=d[_ON[i]],
                filters=filters,
                groups=groups,
            )
        block_cache[key] = nb
        return nb

    def decode(d: dict) -> C.ConvNetSpec:
        blocks = []
        cin = base.stem_filters
        for i, b in enumerate(base.blocks):
            nb = _block(i, b, cin, d)
            blocks.append(nb)
            cin = nb.filters
        return replace(base, blocks=tuple(blocks), name=name)

    return Space(choices, decode, name)


def _stamped(space: Space, factory: str, **kw) -> Space:
    # provenance makes registry spaces picklable (rebuilt via the factory in
    # the receiving process — see space.Space.provenance)
    space.provenance = (f"{__name__}:{factory}", kw)
    return space


def s1_mobilenetv2(num_classes=1000, image_size=224) -> Space:
    base = C.mobilenet_v2(num_classes, image_size)
    return _stamped(_blockwise_space(base, "s1_mbv2"), "s1_mobilenetv2",
                    num_classes=num_classes, image_size=image_size)


def s2_efficientnet(num_classes=1000, image_size=224,
                    se=False, swish=False) -> Space:
    base = C.efficientnet_b0(num_classes, image_size, se=se, swish=swish)
    return _stamped(_blockwise_space(base, "s2_effnet"), "s2_efficientnet",
                    num_classes=num_classes, image_size=image_size,
                    se=se, swish=swish)


def s3_evolved(num_classes=1000, image_size=224) -> Space:
    """The evolved EdgeTPU space: SE/Swish removed (they are 'not supported or
    inefficient in many specialized accelerators'), Fused-IBN enabled."""
    base = C.efficientnet_b0(num_classes, image_size, se=False, swish=False)
    return _stamped(_blockwise_space(base, "s3_evolved", evolved=True),
                    "s3_evolved", num_classes=num_classes,
                    image_size=image_size)


def tiny_space(num_classes=10, image_size=32, blocks=4) -> Space:
    """Reduced space for CPU-runnable end-to-end searches (tests/examples)."""
    base = C.mobilenet_v2(num_classes, image_size, width=0.35)
    base = replace(base, blocks=base.blocks[:blocks], head_filters=256)
    return _stamped(_blockwise_space(base, "tiny", evolved=True), "tiny_space",
                    num_classes=num_classes, image_size=image_size,
                    blocks=blocks)


SPACES = {
    "s1_mbv2": s1_mobilenetv2,
    "s2_effnet": s2_efficientnet,
    "s3_evolved": s3_evolved,
    "tiny": tiny_space,
}
