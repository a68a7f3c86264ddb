"""InceptionV3: examples/cpp/InceptionV3/inception.cc:27-176 (block structure
and channel counts copied faithfully; NCHW, concat on channel axis 1).
(Twin of `flexflow_tpu/models/inception.py`.)
"""

from __future__ import annotations

from ..fftype import ActiMode, PoolType

RELU = ActiMode.AC_MODE_RELU


def _inception_a(ff, x, pool_features, p):
    t1 = ff.conv2d(x, 64, 1, 1, 1, 1, 0, 0, RELU, name=f"{p}b1")
    t2 = ff.conv2d(x, 48, 1, 1, 1, 1, 0, 0, RELU, name=f"{p}b2a")
    t2 = ff.conv2d(t2, 64, 5, 5, 1, 1, 2, 2, RELU, name=f"{p}b2b")
    t3 = ff.conv2d(x, 64, 1, 1, 1, 1, 0, 0, RELU, name=f"{p}b3a")
    t3 = ff.conv2d(t3, 96, 3, 3, 1, 1, 1, 1, RELU, name=f"{p}b3b")
    t3 = ff.conv2d(t3, 96, 3, 3, 1, 1, 1, 1, RELU, name=f"{p}b3c")
    t4 = ff.pool2d(x, 3, 3, 1, 1, 1, 1, PoolType.POOL_AVG, name=f"{p}b4p")
    t4 = ff.conv2d(t4, pool_features, 1, 1, 1, 1, 0, 0, RELU, name=f"{p}b4c")
    return ff.concat([t1, t2, t3, t4], 1, name=f"{p}cat")


def _inception_b(ff, x, p):
    t1 = ff.conv2d(x, 384, 3, 3, 2, 2, 0, 0, name=f"{p}b1")
    t2 = ff.conv2d(x, 64, 1, 1, 1, 1, 0, 0, name=f"{p}b2a")
    t2 = ff.conv2d(t2, 96, 3, 3, 1, 1, 1, 1, name=f"{p}b2b")
    t2 = ff.conv2d(t2, 96, 3, 3, 2, 2, 0, 0, name=f"{p}b2c")
    t3 = ff.pool2d(x, 3, 3, 2, 2, 0, 0, name=f"{p}b3p")
    return ff.concat([t1, t2, t3], 1, name=f"{p}cat")


def _inception_c(ff, x, channels, p):
    t1 = ff.conv2d(x, 192, 1, 1, 1, 1, 0, 0, name=f"{p}b1")
    t2 = ff.conv2d(x, channels, 1, 1, 1, 1, 0, 0, name=f"{p}b2a")
    t2 = ff.conv2d(t2, channels, 1, 7, 1, 1, 0, 3, name=f"{p}b2b")
    t2 = ff.conv2d(t2, 192, 7, 1, 1, 1, 3, 0, name=f"{p}b2c")
    t3 = ff.conv2d(x, channels, 1, 1, 1, 1, 0, 0, name=f"{p}b3a")
    t3 = ff.conv2d(t3, channels, 7, 1, 1, 1, 3, 0, name=f"{p}b3b")
    t3 = ff.conv2d(t3, channels, 1, 7, 1, 1, 0, 3, name=f"{p}b3c")
    t3 = ff.conv2d(t3, channels, 7, 1, 1, 1, 3, 0, name=f"{p}b3d")
    t3 = ff.conv2d(t3, 192, 1, 7, 1, 1, 0, 3, name=f"{p}b3e")
    t4 = ff.pool2d(x, 3, 3, 1, 1, 1, 1, PoolType.POOL_AVG, name=f"{p}b4p")
    t4 = ff.conv2d(t4, 192, 1, 1, 1, 1, 0, 0, name=f"{p}b4c")
    return ff.concat([t1, t2, t3, t4], 1, name=f"{p}cat")


def _inception_d(ff, x, p):
    t1 = ff.conv2d(x, 192, 1, 1, 1, 1, 0, 0, name=f"{p}b1a")
    t1 = ff.conv2d(t1, 320, 3, 3, 2, 2, 0, 0, name=f"{p}b1b")
    t2 = ff.conv2d(x, 192, 1, 1, 1, 1, 0, 0, name=f"{p}b2a")
    t2 = ff.conv2d(t2, 192, 1, 7, 1, 1, 0, 3, name=f"{p}b2b")
    t2 = ff.conv2d(t2, 192, 7, 1, 1, 1, 3, 0, name=f"{p}b2c")
    t2 = ff.conv2d(t2, 192, 3, 3, 2, 2, 0, 0, name=f"{p}b2d")
    t3 = ff.pool2d(x, 3, 3, 2, 2, 0, 0, name=f"{p}b3p")
    return ff.concat([t1, t2, t3], 1, name=f"{p}cat")


def _inception_e(ff, x, p):
    t1 = ff.conv2d(x, 320, 1, 1, 1, 1, 0, 0, name=f"{p}b1")
    t2i = ff.conv2d(x, 384, 1, 1, 1, 1, 0, 0, name=f"{p}b2i")
    t2 = ff.conv2d(t2i, 384, 1, 3, 1, 1, 0, 1, name=f"{p}b2a")
    t3 = ff.conv2d(t2i, 384, 3, 1, 1, 1, 1, 0, name=f"{p}b2b")
    t3i = ff.conv2d(x, 448, 1, 1, 1, 1, 0, 0, name=f"{p}b3i")
    t3i = ff.conv2d(t3i, 384, 3, 3, 1, 1, 1, 1, name=f"{p}b3j")
    t4 = ff.conv2d(t3i, 384, 1, 3, 1, 1, 0, 1, name=f"{p}b3a")
    t5 = ff.conv2d(t3i, 384, 3, 1, 1, 1, 1, 0, name=f"{p}b3b")
    t6 = ff.pool2d(x, 3, 3, 1, 1, 1, 1, PoolType.POOL_AVG, name=f"{p}b4p")
    t6 = ff.conv2d(t6, 192, 1, 1, 1, 1, 0, 0, name=f"{p}b4c")
    return ff.concat([t1, t2, t3, t4, t5, t6], 1, name=f"{p}cat")


def build_inception_v3(ff, batch_size: int | None = None,
                       num_classes: int = 10, image_hw: int = 299):
    bs = batch_size or ff.config.batch_size
    input = ff.create_tensor((bs, 3, image_hw, image_hw), name="input")
    t = ff.conv2d(input, 32, 3, 3, 2, 2, 0, 0, RELU, name="stem1")
    t = ff.conv2d(t, 32, 3, 3, 1, 1, 0, 0, RELU, name="stem2")
    t = ff.conv2d(t, 64, 3, 3, 1, 1, 1, 1, RELU, name="stem3")
    t = ff.pool2d(t, 3, 3, 2, 2, 0, 0, name="stem_pool1")
    t = ff.conv2d(t, 80, 1, 1, 1, 1, 0, 0, RELU, name="stem4")
    t = ff.conv2d(t, 192, 3, 3, 1, 1, 1, 1, RELU, name="stem5")
    t = ff.pool2d(t, 3, 3, 2, 2, 0, 0, name="stem_pool2")
    t = _inception_a(ff, t, 32, "a1_")
    t = _inception_a(ff, t, 64, "a2_")
    t = _inception_a(ff, t, 64, "a3_")
    t = _inception_b(ff, t, "b1_")
    t = _inception_c(ff, t, 128, "c1_")
    t = _inception_c(ff, t, 160, "c2_")
    t = _inception_c(ff, t, 160, "c3_")
    t = _inception_c(ff, t, 192, "c4_")
    t = _inception_d(ff, t, "d1_")
    t = _inception_e(ff, t, "e1_")
    t = _inception_e(ff, t, "e2_")
    t = ff.pool2d(t, 8, 8, 1, 1, 0, 0, PoolType.POOL_AVG, name="avgpool")
    t = ff.flat(t, name="flat")
    t = ff.dense(t, num_classes, name="fc")
    t = ff.softmax(t, name="softmax")
    return input, t
