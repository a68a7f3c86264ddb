"""Model zoo of the port: the flagship Transformer LM, the MLPs and
ResNet-50 / ResNeXt-50 (copies of the JAX package's builders, which call
only the FFModel API)."""

from .mlp import build_mlp_unify, build_mnist_mlp
from .resnet import build_resnet50, build_resnext50

from .transformer import (
    TRANSFORMER_LM_ZOO,
    TransformerLMConfig,
    build_transformer_lm,
    build_transformer_lm_decode,
    build_transformer_lm_pipelined,
    transformer_lm_flops_per_token,
    transformer_lm_param_count,
    transformer_lm_state_bytes_per_chip,
)

__all__ = [
    "TRANSFORMER_LM_ZOO",
    "build_mlp_unify",
    "build_mnist_mlp",
    "build_resnet50",
    "build_resnext50",
    "TransformerLMConfig",
    "build_transformer_lm",
    "build_transformer_lm_decode",
    "build_transformer_lm_pipelined",
    "transformer_lm_flops_per_token",
    "transformer_lm_param_count",
    "transformer_lm_state_bytes_per_chip",
]
