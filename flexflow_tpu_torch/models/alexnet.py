"""AlexNet (CIFAR-10 head): examples/cpp/AlexNet/alexnet.cc:70-84.
(Twin of `flexflow_tpu/models/alexnet.py`.)
"""

from __future__ import annotations

from ..fftype import ActiMode


def build_alexnet(ff, batch_size: int | None = None, num_classes: int = 10,
                  image_hw: int = 229):
    bs = batch_size or ff.config.batch_size
    input = ff.create_tensor((bs, 3, image_hw, image_hw), name="input")
    t = ff.conv2d(input, 64, 11, 11, 4, 4, 2, 2, ActiMode.AC_MODE_RELU,
                  name="conv1")
    t = ff.pool2d(t, 3, 3, 2, 2, 0, 0, name="pool1")
    t = ff.conv2d(t, 192, 5, 5, 1, 1, 2, 2, ActiMode.AC_MODE_RELU,
                  name="conv2")
    t = ff.pool2d(t, 3, 3, 2, 2, 0, 0, name="pool2")
    t = ff.conv2d(t, 384, 3, 3, 1, 1, 1, 1, ActiMode.AC_MODE_RELU,
                  name="conv3")
    t = ff.conv2d(t, 256, 3, 3, 1, 1, 1, 1, ActiMode.AC_MODE_RELU,
                  name="conv4")
    t = ff.conv2d(t, 256, 3, 3, 1, 1, 1, 1, ActiMode.AC_MODE_RELU,
                  name="conv5")
    t = ff.pool2d(t, 3, 3, 2, 2, 0, 0, name="pool3")
    t = ff.flat(t, name="flat")
    t = ff.dense(t, 4096, ActiMode.AC_MODE_RELU, name="fc6")
    t = ff.dense(t, 4096, ActiMode.AC_MODE_RELU, name="fc7")
    t = ff.dense(t, num_classes, name="fc8")
    t = ff.softmax(t, name="softmax")
    return input, t
