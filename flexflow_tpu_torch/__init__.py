"""flexflow_tpu_torch: the PyTorch/CUDA port of flexflow_tpu, for NVIDIA
H100s.

It mirrors the JAX package's module layout and names. It trains the
flagship Transformer LM, the MLPs and ResNet-50 through the JAX
package's layer API (FFConfig -> FFModel -> builders -> compile(optimizer,
loss_type, metrics) -> fit / eval / forward, backward, update) and serves
the LM (compile -> serve() -> ServingEngine.generate), with hand-written
Hopper kernels (CUDA C++) for the flash attention forward and backward,
the decode attention and the LayerNorm forward and backward; telemetry/
writes the JAX package's trace and run metrics. A model trains on a mesh
of torch.distributed ranks (`--mesh`, one rank a device): data and tensor
parallel, with the weight update replicated or sharded (ZeRO stage 2/3).
It imports torch and numpy, never jax, and nothing of flexflow_tpu.

Every tensor lives on `FFConfig.device`, "cuda" unless the caller asks
for "cpu"; without a CUDA device and without that request, building a
model raises.
"""

from . import ops  # registers every OpDef
from . import parallel  # registers the parallel ops' OpDefs
from .config import FFConfig, FFIterationConfig
from .convert import load_params
from .fftype import (
    ActiMode,
    AggrMode,
    CompMode,
    DataType,
    LossType,
    MetricsType,
    OperatorType,
    ParameterSyncType,
    PoolType,
    RegularizerMode,
)
from .initializer import (
    ConstantInitializer,
    GlorotUniformInitializer,
    Initializer,
    NormInitializer,
    UniformInitializer,
    ZeroInitializer,
)
from .machine import MachineResource, MachineView, Mesh, MeshShape, build_mesh
from .metrics import Metrics, PerfMetrics
from .model import FFModel
from .optimizer import AdamOptimizer, Optimizer, SGDOptimizer
from .parallel import Strategy
from . import serving
from . import telemetry  # tracer + run metrics + leveled logging
from .tensor import ParallelDim, ParallelTensor, ParallelTensorShape, Tensor

__version__ = "0.1.0"
