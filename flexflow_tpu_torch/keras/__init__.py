"""Keras frontend (reference python/flexflow/keras — SURVEY §2.5).

Same surface: `Input`, layer classes (Dense/Conv2D/MaxPooling2D/.../merge
layers), `Sequential` and functional `Model` with `compile(optimizer, loss,
metrics)` / `fit` / `evaluate`, string-named optimizers/losses/metrics. The
layer DAG is recorded symbolically and lowered onto an `FFModel` at compile,
exactly like the reference's BaseModel._create_flexflow_layers.
(Twin of `flexflow_tpu/keras/__init__.py`.)
"""

from .layers import (
    Activation,
    Add,
    AveragePooling2D,
    BatchNormalization,
    Concatenate,
    Conv2D,
    Dense,
    Dropout,
    Embedding,
    Flatten,
    Input,
    InputLayer,
    Layer,
    Maximum,
    Minimum,
    MaxPooling2D,
    Multiply,
    Permute,
    Reshape,
    Subtract,
    add,
    concatenate,
    subtract,
)
from . import callbacks, datasets
from .callbacks import (
    Callback,
    EpochVerifyMetrics,
    LearningRateScheduler,
    ModelCheckpoint,
    VerifyMetrics,
)
from .models import Model, Sequential
from .optimizers import SGD, Adam
