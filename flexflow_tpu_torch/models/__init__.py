"""Model zoo of the port (copies of the JAX package's builders, which call
only the FFModel API): every reference example family (AlexNet,
ResNet-50, ResNeXt-50, InceptionV3, Transformer, DLRM, XDL, CANDLE Uno,
MLP_Unify, MNIST MLP, MoE) and the flagship Transformer LM."""

from .alexnet import build_alexnet
from .candle_uno import CandleUnoConfig, build_candle_uno
from .dlrm import DLRMConfig, build_dlrm
from .inception import build_inception_v3
from .mlp import build_mlp_unify, build_mnist_mlp
from .moe import MoeConfig, build_moe, build_moe_encoder
from .resnet import build_resnet50, build_resnext50
from .transformer import (
    TRANSFORMER_LM_ZOO,
    TransformerConfig,
    TransformerLMConfig,
    build_transformer,
    build_transformer_lm,
    build_transformer_lm_decode,
    build_transformer_lm_pipelined,
    create_attention_encoder,
    transformer_lm_flops_per_token,
    transformer_lm_param_count,
    transformer_lm_state_bytes_per_chip,
)
from .xdl import XDLConfig, build_xdl

__all__ = [
    "TRANSFORMER_LM_ZOO",
    "CandleUnoConfig",
    "DLRMConfig",
    "MoeConfig",
    "TransformerConfig",
    "TransformerLMConfig",
    "XDLConfig",
    "build_alexnet",
    "build_candle_uno",
    "build_dlrm",
    "build_inception_v3",
    "build_mlp_unify",
    "build_mnist_mlp",
    "build_moe",
    "build_moe_encoder",
    "build_resnet50",
    "build_resnext50",
    "build_transformer",
    "build_transformer_lm",
    "build_transformer_lm_decode",
    "build_transformer_lm_pipelined",
    "create_attention_encoder",
    "transformer_lm_flops_per_token",
    "transformer_lm_param_count",
    "transformer_lm_state_bytes_per_chip",
    "build_xdl",
]
