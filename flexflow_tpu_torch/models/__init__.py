"""Model zoo of the port: the flagship Transformer LM (serving slice)."""

from .transformer import (
    TRANSFORMER_LM_ZOO,
    TransformerLMConfig,
    build_transformer_lm,
    build_transformer_lm_decode,
    transformer_lm_param_count,
)

__all__ = [
    "TRANSFORMER_LM_ZOO",
    "TransformerLMConfig",
    "build_transformer_lm",
    "build_transformer_lm_decode",
    "transformer_lm_param_count",
]
