"""The layers of the BERT slice."""

from analytics_zoo_tpu_torch.keras.layers.normalization import LayerNorm
from analytics_zoo_tpu_torch.keras.layers.self_attention import (
    BERT, MultiHeadAttention, PositionwiseFFN, TransformerBlock,
    TransformerLayer)

__all__ = ["BERT", "LayerNorm", "MultiHeadAttention", "PositionwiseFFN",
           "TransformerBlock", "TransformerLayer"]
