"""BERT text estimators: the sequence classifier.

Port of ``_BertNet``, ``_ClassifierNet`` and ``BERTClassifier`` from
``analytics_zoo_tpu/tfpark/text_estimators.py`` for prediction.  Inputs
follow the reference feature order ``[input_ids, token_type_ids,
input_mask]``.  The default ``bert_config`` is the JAX package's small one
(hidden 128, 2 blocks), not BERT-base; pass BERT-base's widths explicitly.
Training and evaluation come with the training slice.
"""

from __future__ import annotations

from typing import Optional, Union

import numpy as np
import torch

from analytics_zoo_tpu_torch.common.context import resolve_device
from analytics_zoo_tpu_torch.keras.engine import KerasNet
from analytics_zoo_tpu_torch.keras.layers.self_attention import BERT, Dense

_TRAINING_SLICE = ("not ported yet (ROADMAP Queue 1: training, with the "
                   "attention backward kernels)")


class _BertNet(KerasNet):
    """BERT encoder + a head; subclasses implement the head."""

    def __init__(self, bert_config: Optional[dict] = None,
                 name: Optional[str] = None):
        super().__init__(name=name)
        cfg = dict(vocab=30522, hidden_size=128, n_block=2, n_head=2,
                   seq_len=128, intermediate_size=512)
        cfg.update(bert_config or {})
        self.cfg = cfg
        self.bert = BERT(**cfg, name=self.name + "_bert")

    def _head(self, seq_out, pooled):
        raise NotImplementedError

    def forward(self, x):
        input_ids, token_type_ids, input_mask = x
        seq_out, pooled = self.bert([input_ids, token_type_ids, input_mask])
        return self._head(seq_out, pooled)


class _ClassifierNet(_BertNet):
    def __init__(self, num_classes: int, **kw):
        self.num_classes = num_classes
        super().__init__(**kw)
        self.head = Dense(self.cfg["hidden_size"], num_classes)

    def _head(self, seq_out, pooled):
        return torch.softmax(self.head(pooled), dim=-1)


class BERTClassifier:
    """Sequence classification: class probabilities from the pooled
    output.  ``device`` is where the model lives (default: the card;
    raises when there is none); ``generator`` seeds the initial weights
    (``load_weights`` replaces them)."""

    def __init__(self, num_classes: int, bert_config: Optional[dict] = None,
                 device: Optional[Union[str, torch.device]] = None,
                 generator: Optional[torch.Generator] = None):
        self.device = resolve_device(device)
        self.net = _ClassifierNet(num_classes, bert_config=bert_config,
                                  name="bert_classifier")
        self.net.init(generator)
        self.net.to(self.device)

    def load_weights(self, params) -> "BERTClassifier":
        """Load a JAX-layout parameter tree (``interop.load_jax_params``)."""
        self.net.set_weights(params)
        return self

    def predict(self, x, batch_size: int = 32) -> np.ndarray:
        """Class probabilities for ``x = [input_ids, token_type_ids,
        input_mask]`` (arrays with a leading batch axis), ``batch_size``
        rows per forward."""
        arrays = [np.asarray(a) for a in x]
        outs = []
        for s in range(0, arrays[0].shape[0], batch_size):
            batch = [torch.from_numpy(np.ascontiguousarray(a[s:s + batch_size]))
                     .to(self.device) for a in arrays]
            outs.append(self.net.predict_fn(batch).float().cpu().numpy())
        return np.concatenate(outs)

    def train(self, *args, **kwargs):
        raise NotImplementedError(f"BERTClassifier.train is {_TRAINING_SLICE}")

    def evaluate(self, *args, **kwargs):
        raise NotImplementedError(
            f"BERTClassifier.evaluate is {_TRAINING_SLICE}")
