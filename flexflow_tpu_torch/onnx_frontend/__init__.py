"""ONNX frontend (reference python/flexflow/onnx/model.py, SURVEY §2.5).
(Twin of `flexflow_tpu/onnx_frontend/__init__.py`.)"""

from .model import ONNXModel
