"""The ported layers: the BERT slice's, and the core and embedding layers
of the recommendation models."""

from analytics_zoo_tpu_torch.keras.engine import Input, Lambda, Layer
from analytics_zoo_tpu_torch.keras.layers.core import (
    Activation, Dense, ExpandDim, Flatten, Merge, Narrow, Reshape, Select,
    Squeeze)
from analytics_zoo_tpu_torch.keras.layers.embedding import Embedding
from analytics_zoo_tpu_torch.keras.layers.normalization import LayerNorm
from analytics_zoo_tpu_torch.keras.layers.self_attention import (
    BERT, MultiHeadAttention, PositionwiseFFN, TransformerBlock,
    TransformerLayer)

__all__ = ["Activation", "BERT", "Dense", "Embedding", "ExpandDim",
           "Flatten", "Input", "Lambda", "Layer", "LayerNorm", "Merge",
           "MultiHeadAttention", "Narrow", "PositionwiseFFN", "Reshape",
           "Select", "Squeeze", "TransformerBlock", "TransformerLayer"]
