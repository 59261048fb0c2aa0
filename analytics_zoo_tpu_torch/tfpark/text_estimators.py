"""BERT text estimators: the sequence classifier.

Port of ``_BertNet``, ``_ClassifierNet``, ``BERTBaseEstimator`` and
``BERTClassifier`` from ``analytics_zoo_tpu/tfpark/text_estimators.py``:
train, evaluate and predict through the port's ``Estimator``.  Inputs
follow the reference feature order ``[input_ids, token_type_ids,
input_mask]``.  The default ``bert_config`` is the JAX package's small one
(hidden 128, 2 blocks), not BERT-base; pass BERT-base's widths
explicitly.  The NER and SQuAD heads are not ported.
"""

from __future__ import annotations

from typing import Optional, Sequence, Union

import numpy as np
import torch

from analytics_zoo_tpu_torch.common.context import resolve_device
from analytics_zoo_tpu_torch.common.triggers import MaxIteration
from analytics_zoo_tpu_torch.data.featureset import FeatureSet
from analytics_zoo_tpu_torch.estimator import Estimator
from analytics_zoo_tpu_torch.keras.engine import KerasNet
from analytics_zoo_tpu_torch.keras.layers.self_attention import BERT, Dense
from analytics_zoo_tpu_torch.tfpark.tf_dataset import TFDataset


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

    def forward(self, x, seed: Optional[int] = None):
        input_ids, token_type_ids, input_mask = x
        seq_out, pooled = self.bert([input_ids, token_type_ids, input_mask],
                                    seed=seed)
        return self._head(seq_out, pooled)


class _ClassifierNet(_BertNet):
    def __init__(self, num_classes: int, **kw):
        self.num_classes = num_classes
        super().__init__(**kw)
        self.head = Dense(self.cfg["hidden_size"], num_classes)

    def _head(self, seq_out, pooled):
        return torch.softmax(self.head(pooled), dim=-1)


class BERTBaseEstimator:
    """Shared train / evaluate / predict plumbing over a ``KerasNet`` that
    lives on ``device`` (default: the card; raises without one)."""

    loss_name = "sparse_categorical_crossentropy"

    def __init__(self, net: KerasNet, optimizer="adam",
                 model_dir: Optional[str] = None,
                 metrics: Optional[Sequence] = None,
                 mixed_precision: bool = False,
                 steps_per_dispatch: int = 1, grad_dtype=None,
                 shard_optimizer=None, grad_accum_steps=None,
                 shard_model=None,
                 device: Optional[Union[str, torch.device]] = None):
        self.device = resolve_device(device)
        self.net = net.to(self.device)
        self.optimizer = optimizer
        self.model_dir = model_dir
        self.metrics = list(metrics or [])
        self._train_kw = dict(
            checkpoint_dir=model_dir, mixed_precision=mixed_precision,
            steps_per_dispatch=steps_per_dispatch, grad_dtype=grad_dtype,
            shard_optimizer=shard_optimizer,
            grad_accum_steps=grad_accum_steps, shard_model=shard_model)
        self._train_est = None        # reused: keeps the optimizer state

    @staticmethod
    def _dataset(input_fn) -> TFDataset:
        ds = input_fn() if callable(input_fn) else input_fn
        if not isinstance(ds, TFDataset):
            raise TypeError("input_fn must yield a TFDataset")
        return ds

    def train(self, input_fn, steps: Optional[int] = None, epochs: int = 1,
              seed: Optional[int] = None) -> "BERTBaseEstimator":
        """Train on ``input_fn``'s dataset for ``epochs``, or ``steps``
        optimizer steps when given.  ``seed`` (an int, default 0) seeds
        dropout (see ``estimator/estimator.py``).  The weights train in
        place: ``net.get_weights()`` reads them in the JAX layout."""
        ds = self._dataset(input_fn)
        est = self._train_est
        if est is None:
            est = Estimator(self.net, self.optimizer, self.loss_name,
                            self.metrics, device=self.device,
                            **self._train_kw)
            self._train_est = est
        ds.check_train_batching()
        if steps:
            # each epoch is >= 1 step, so `steps` epochs always reach the
            # cumulative-offset trigger
            epochs = max(epochs, steps)
        est.train(ds.get_training_data(), batch_size=ds.effective_batch_size,
                  epochs=epochs,
                  end_trigger=(MaxIteration(est.global_step + steps)
                               if steps else None), seed=seed)
        return self

    def evaluate(self, input_fn, metrics: Optional[Sequence] = None):
        ds = self._dataset(input_fn)
        est = Estimator(self.net, None, self.loss_name,
                        list(metrics or self.metrics), device=self.device)
        return est.evaluate(ds.get_training_data(),
                            batch_size=ds.effective_batch_size)

    def predict(self, input_fn, batch_size: int = 32) -> np.ndarray:
        """Outputs for ``input_fn``'s dataset, or for ``[input_ids,
        token_type_ids, input_mask]`` arrays with a leading batch axis
        (``batch_size`` rows per forward)."""
        if isinstance(input_fn, TFDataset) or callable(input_fn):
            ds = self._dataset(input_fn)
            fs, batch_size = ds.get_training_data(), ds.effective_batch_size
        else:
            fs = FeatureSet.from_ndarrays(list(input_fn))
        return Estimator(self.net, device=self.device).predict(
            fs, batch_size=batch_size)


class BERTClassifier(BERTBaseEstimator):
    """Sequence classification: class probabilities from the pooled
    output.  ``generator`` seeds the initial weights (``load_weights``
    replaces them)."""

    def __init__(self, num_classes: int, bert_config: Optional[dict] = None,
                 optimizer="adam", model_dir: Optional[str] = None,
                 mixed_precision: bool = False, steps_per_dispatch: int = 1,
                 grad_dtype=None, shard_optimizer=None,
                 grad_accum_steps=None, shard_model=None,
                 device: Optional[Union[str, torch.device]] = None,
                 generator: Optional[torch.Generator] = None):
        net = _ClassifierNet(num_classes, bert_config=bert_config,
                             name="bert_classifier")
        net.init(generator)
        super().__init__(net, optimizer, model_dir, metrics=["accuracy"],
                         mixed_precision=mixed_precision,
                         steps_per_dispatch=steps_per_dispatch,
                         grad_dtype=grad_dtype,
                         shard_optimizer=shard_optimizer,
                         grad_accum_steps=grad_accum_steps,
                         shard_model=shard_model, device=device)

    def load_weights(self, params) -> "BERTClassifier":
        """Load a JAX-layout parameter tree (``interop.load_jax_params``)."""
        self.net.set_weights(params)
        return self
