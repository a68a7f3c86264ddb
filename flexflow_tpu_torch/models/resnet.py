"""ResNet-50 and ResNeXt-50.

- `build_resnet50`: examples/cpp/ResNet/resnet.cc:39-112 — BottleneckBlock
  (1x1 → 3x3(stride) → 1x1(4x), projection shortcut on shape change, relu
  after add), stages [3,4,6,3] at widths [64,128,256,512].
- `build_resnext50`: examples/cpp/resnext50/resnext.cc — grouped 3x3
  (cardinality 32) bottlenecks.
"""

from __future__ import annotations

from ..fftype import ActiMode, PoolType


def _bottleneck(ff, input, out_channels, stride, prefix, groups=1,
                group_width=None):
    """resnet.cc:39-60 — faithfully no intermediate activations (the
    reference comments out batch_norm and keeps convs AC_MODE_NONE), single
    relu after the residual add."""
    mid = group_width or out_channels
    t = ff.conv2d(input, mid, 1, 1, 1, 1, 0, 0, name=f"{prefix}c1")
    t = ff.conv2d(t, mid, 3, 3, stride, stride, 1, 1, groups=groups,
                  name=f"{prefix}c2")
    t = ff.conv2d(t, 4 * out_channels, 1, 1, 1, 1, 0, 0, name=f"{prefix}c3")
    if stride > 1 or input.dims[1] != 4 * out_channels:
        input = ff.conv2d(input, 4 * out_channels, 1, 1, stride, stride, 0, 0,
                          name=f"{prefix}proj")
    t = ff.add(input, t, name=f"{prefix}add")
    return ff.relu(t, name=f"{prefix}out")


def _resnet_backbone(ff, input, groups=1, width_per_group=None):
    t = ff.conv2d(input, 64, 7, 7, 2, 2, 3, 3, name="stem_conv")
    t = ff.pool2d(t, 3, 3, 2, 2, 1, 1, name="stem_pool")
    stages = ((64, 3), (128, 4), (256, 6), (512, 3))
    for si, (width, blocks) in enumerate(stages):
        for bi in range(blocks):
            stride = 2 if (si > 0 and bi == 0) else 1
            # ResNeXt: 3x3 runs at cardinality*width_per_group*2^stage
            gw = groups * width_per_group * (2 ** si) if width_per_group else None
            t = _bottleneck(ff, t, width, stride, f"s{si}b{bi}_",
                            groups=groups, group_width=gw)
    return t


def build_resnet50(ff, batch_size: int | None = None, num_classes: int = 10,
                   image_hw: int = 224):
    bs = batch_size or ff.config.batch_size
    input = ff.create_tensor((bs, 3, image_hw, image_hw), name="input")
    t = _resnet_backbone(ff, input)
    t = ff.pool2d(t, 7, 7, 1, 1, 0, 0, PoolType.POOL_AVG, name="avgpool")
    t = ff.flat(t, name="flat")
    t = ff.dense(t, num_classes, name="fc")
    t = ff.softmax(t, name="softmax")
    return input, t


def build_resnext50(ff, batch_size: int | None = None, num_classes: int = 10,
                    image_hw: int = 224, cardinality: int = 32,
                    width_per_group: int = 4):
    bs = batch_size or ff.config.batch_size
    input = ff.create_tensor((bs, 3, image_hw, image_hw), name="input")
    t = _resnet_backbone(ff, input, groups=cardinality,
                         width_per_group=width_per_group)
    t = ff.pool2d(t, 7, 7, 1, 1, 0, 0, PoolType.POOL_AVG, name="avgpool")
    t = ff.flat(t, name="flat")
    t = ff.dense(t, num_classes, name="fc")
    t = ff.softmax(t, name="softmax")
    return input, t
