"""flexflow_tpu_torch: the PyTorch/CUDA port of flexflow_tpu, for one
NVIDIA H100.

It mirrors the JAX package's module layout and names. It trains the
flagship Transformer LM (FFConfig -> FFModel -> build_transformer_lm ->
compile(optimizer, loss_type, metrics) -> fit / eval / forward, backward,
update) and serves it (compile -> serve() -> ServingEngine.generate), with
hand-written Hopper kernels for the packed flash attention forward and
backward and the decode attention (CUDA C++), and the LayerNorm forward
and backward (Triton). It imports torch and numpy, never jax, and nothing
of flexflow_tpu.

Every tensor lives on `FFConfig.device`, "cuda" unless the caller asks
for "cpu"; without a CUDA device and without that request, building a
model raises.
"""

from . import ops  # registers every OpDef
from .config import FFConfig
from .convert import load_params
from .fftype import (
    ActiMode,
    AggrMode,
    CompMode,
    DataType,
    LossType,
    MetricsType,
    OperatorType,
)
from .initializer import (
    ConstantInitializer,
    GlorotUniformInitializer,
    Initializer,
    NormInitializer,
    UniformInitializer,
)
from .metrics import PerfMetrics
from .model import FFModel
from .optimizer import AdamOptimizer, Optimizer, SGDOptimizer
from . import serving
from .tensor import Tensor

__version__ = "0.1.0"
