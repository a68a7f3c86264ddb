"""PyTorch frontend (reference python/flexflow/torch/model.py, SURVEY §2.5).

`torch.fx`-symbolic-traces an `nn.Module`, propagates shapes from the
FFModel input tensors, and rebuilds the graph with FFModel builder calls
(`PyTorchModel.torch_to_ff`); `torch_to_flexflow` serializes the traced
graph to a `.ff` file that `PyTorchModel(filename)` can replay without
torch installed — the same two paths the reference offers.
(Twin of `flexflow_tpu/torch_frontend/__init__.py`.)
"""

from .model import PyTorchModel, torch_to_flexflow
