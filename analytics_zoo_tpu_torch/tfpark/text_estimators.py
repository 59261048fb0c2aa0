"""BERT text estimators: sequence classification, token tagging (NER) and
extractive QA (SQuAD).

Port of ``analytics_zoo_tpu/tfpark/text_estimators.py``: ``_BertNet`` and
its three heads, ``BERTBaseEstimator``, ``BERTClassifier``, ``BERTNER``,
``BERTSQuAD`` and ``_squad_loss``.  Train, evaluate and predict run
through the port's ``Estimator``, with the JAX estimator's knobs:
``model_dir`` (checkpoints), ``mixed_precision``, ``steps_per_dispatch``
(CUDA graphs on the card), ``grad_dtype``, ``grad_accum_steps``,
``shard_optimizer`` and ``shard_model``, which shard the step over the
global context's mesh (``init_zoo_context``, or ``context_scope`` in the
calling thread), as in the JAX package.
Inputs follow the reference feature order ``[input_ids, token_type_ids,
input_mask]``.  Each head's tree is ``{"bert": ..., "head": {"W", "b"}}``.
The default ``bert_config`` is the JAX package's small one (hidden 128, 2
blocks), not BERT-base; pass BERT-base's widths explicitly.

NER's loss is ``sparse_categorical_crossentropy`` over every token, padding
included, as in the JAX package.  SQuAD's model gives the list
``[start_logits, end_logits]`` and its labels are the list ``[start, end]``
of positions; ``_squad_loss`` reads them on the device with no host read,
so a captured training step carries the list through its graph.
"""

from __future__ import annotations

from typing import Optional, Sequence, Union

import numpy as np
import torch
import torch.nn.functional as F

from analytics_zoo_tpu_torch.common.context import resolve_device
from analytics_zoo_tpu_torch.common.triggers import MaxIteration
from analytics_zoo_tpu_torch.data.featureset import FeatureSet
from analytics_zoo_tpu_torch.estimator import Estimator
from analytics_zoo_tpu_torch.keras.engine import KerasNet
from analytics_zoo_tpu_torch.keras.layers.self_attention import (
    BERT, projection)
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
        self.head = projection(self.cfg["hidden_size"], num_classes)

    def _head(self, seq_out, pooled):
        return torch.softmax(self.head(pooled), dim=-1)


class _NERNet(_BertNet):
    def __init__(self, num_entities: int, **kw):
        self.num_entities = num_entities
        super().__init__(**kw)
        self.head = projection(self.cfg["hidden_size"], num_entities)

    def _head(self, seq_out, pooled):
        return torch.softmax(self.head(seq_out), dim=-1)


class _SQuADNet(_BertNet):
    def __init__(self, **kw):
        super().__init__(**kw)
        self.head = projection(self.cfg["hidden_size"], 2)

    def _head(self, seq_out, pooled):
        logits = self.head(seq_out)                  # (B, T, 2)
        return [logits[..., 0], logits[..., 1]]      # start, end logits


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

    def load_weights(self, params) -> "BERTBaseEstimator":
        """Load a JAX-layout parameter tree (``interop.load_jax_params``)."""
        self.net.set_weights(params)
        return self


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


class BERTNER(BERTBaseEstimator):
    """Token-level entity tagging: per-token probabilities (B, T, C) from
    the sequence output.  ``generator`` seeds the initial weights."""

    def __init__(self, num_entities: int, bert_config: Optional[dict] = None,
                 optimizer="adam", model_dir: Optional[str] = None,
                 mixed_precision: bool = False, steps_per_dispatch: int = 1,
                 grad_dtype=None, shard_optimizer=None,
                 grad_accum_steps=None, shard_model=None,
                 device: Optional[Union[str, torch.device]] = None,
                 generator: Optional[torch.Generator] = None):
        net = _NERNet(num_entities, bert_config=bert_config, name="bert_ner")
        net.init(generator)
        super().__init__(net, optimizer, model_dir,
                         mixed_precision=mixed_precision,
                         steps_per_dispatch=steps_per_dispatch,
                         grad_dtype=grad_dtype,
                         shard_optimizer=shard_optimizer,
                         grad_accum_steps=grad_accum_steps,
                         shard_model=shard_model, device=device)


def _squad_loss(preds, labels):
    """The mean of the start and end sparse cross-entropies on logits
    (``-0.5 * (mean(log p_start[s]) + mean(log p_end[e]))``).  The
    positions are gathered as int64 (``gather``'s index type)."""
    start_logits, end_logits = preds
    start_pos, end_pos = labels

    def pick(logits, pos):
        logp = F.log_softmax(logits, dim=-1)
        return logp.gather(1, pos.reshape(-1, 1).long())[:, 0]
    return -0.5 * (torch.mean(pick(start_logits, start_pos))
                   + torch.mean(pick(end_logits, end_pos)))


class BERTSQuAD(BERTBaseEstimator):
    """Extractive QA: start / end span logits, each (B, T); ``predict``
    returns the list ``[start_logits, end_logits]``.  ``generator`` seeds
    the initial weights."""

    loss_name = staticmethod(_squad_loss)

    def __init__(self, bert_config: Optional[dict] = None, optimizer="adam",
                 model_dir: Optional[str] = None,
                 mixed_precision: bool = False, steps_per_dispatch: int = 1,
                 grad_dtype=None, shard_optimizer=None,
                 grad_accum_steps=None, shard_model=None,
                 device: Optional[Union[str, torch.device]] = None,
                 generator: Optional[torch.Generator] = None):
        net = _SQuADNet(bert_config=bert_config, name="bert_squad")
        net.init(generator)
        super().__init__(net, optimizer, model_dir,
                         mixed_precision=mixed_precision,
                         steps_per_dispatch=steps_per_dispatch,
                         grad_dtype=grad_dtype,
                         shard_optimizer=shard_optimizer,
                         grad_accum_steps=grad_accum_steps,
                         shard_model=shard_model, device=device)
        self.loss_name = _squad_loss
