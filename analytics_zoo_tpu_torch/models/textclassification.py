"""TextClassifier: token embedding, a CNN / LSTM / GRU encoder and a dense
head.

Port of ``analytics_zoo_tpu/models/textclassification.py``: the same
graph, layer names and parameter tree.  At its defaults (vocab 20,000,
200-wide tokens, 500 steps, a 256-wide encoder) it is the news20
classifier of the upstream example.  Takes ``device=`` (default: the
card; raises without one).
"""

from __future__ import annotations

from typing import Optional

import numpy as np

from analytics_zoo_tpu_torch.keras import layers as L
from analytics_zoo_tpu_torch.keras.engine import Input
from analytics_zoo_tpu_torch.models.common import ZooModel


class TextClassifier(ZooModel):
    def __init__(self, class_num: int, embedding_dim: Optional[int] = None,
                 sequence_length: int = 500, encoder: str = "cnn",
                 encoder_output_dim: int = 256,
                 token_length: Optional[int] = None,
                 vocab_size: int = 20000,
                 embedding_weights: Optional[np.ndarray] = None, **kw):
        token_length = token_length or embedding_dim or 200
        if embedding_weights is not None:
            vocab_size, token_length = embedding_weights.shape
        tokens = Input((sequence_length,), name="tokens")
        h = L.Embedding(vocab_size, token_length, weights=embedding_weights,
                        name="embed")(tokens)
        enc = encoder.lower()
        if enc == "cnn":
            h = L.Convolution1D(encoder_output_dim, 5, activation="relu",
                                name="conv")(h)
            h = L.GlobalMaxPooling1D()(h)
        elif enc == "lstm":
            h = L.LSTM(encoder_output_dim, name="lstm")(h)
        elif enc == "gru":
            h = L.GRU(encoder_output_dim, name="gru")(h)
        else:
            raise ValueError(f"unknown encoder {encoder}")
        h = L.Dense(128, activation="relu", name="fc")(h)
        h = L.Dropout(0.2)(h)
        out = L.Dense(class_num, activation="softmax", name="head")(h)
        super().__init__(input=tokens, output=out, **kw)
