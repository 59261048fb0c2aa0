"""ZooModel (a functional-graph model with a domain API on top) and the
Ranker mixin.

Port of ``Ranker`` and ``ZooModel`` from
``analytics_zoo_tpu/models/common.py``; ``save`` / ``load`` are
``KerasNet``'s.  ``Ranker`` scores listwise groups: it reads only what the
JAX one reads of a TextSet, ``text_set.features[i]["sample"]``, an
``(x, labels)`` pair whose rows are the query's ``text1_length`` ids then
the candidate's, so a JAX ``TextSet`` (or any object with that
``features`` list) serves it.
"""

from __future__ import annotations

import numpy as np
import torch

from analytics_zoo_tpu_torch.keras.engine import Model


class Ranker:
    """Ranking-metric validation mixin: NDCG@k and MAP over listwise groups
    (one feature per (query, candidate list)), candidates ranked by the
    model's scores."""

    def _check_initialized(self) -> None:
        """Raised at the call site (``_group_scores`` is a generator) when
        a layer still waits for its input's shape."""
        modules = self.modules() if hasattr(self, "modules") else []
        if any(not getattr(m, "built", True) for m in modules):
            raise RuntimeError("model not initialized; fit() or init() "
                               "first")

    def _scores(self, q: np.ndarray, d: np.ndarray) -> np.ndarray:
        """The model's scores of ``(query ids, candidate ids)`` rows, one
        forward over all of them on the model's device."""
        dev = self.device
        to = lambda a: torch.from_numpy(np.ascontiguousarray(a)).to(dev)
        return self.predict_fn([to(q), to(d)]).float().cpu().numpy()

    def _group_scores(self, text_set):
        split = self.text1_length
        groups = [f["sample"] for f in text_set.features]
        if not groups:
            return
        # one batched forward over every candidate row, then split by group
        xs = np.concatenate([x for x, _ in groups])
        scores = np.asarray(self._scores(xs[:, :split],
                                         xs[:, split:])).reshape(-1)
        off = 0
        for x, labels in groups:
            n = x.shape[0]
            yield scores[off:off + n], np.asarray(labels)
            off += n

    def evaluate_ndcg(self, x, k: int, threshold: float = 0.0) -> float:
        """Mean NDCG@k over the query groups."""
        if k <= 0:
            raise ValueError("k must be positive")
        self._check_initialized()
        out = []
        for scores, labels in self._group_scores(x):
            rel = (labels > threshold).astype(np.float64)
            order = np.argsort(-scores)
            discounts = 1.0 / np.log2(np.arange(2, 2 + min(k, len(order))))
            dcg = float(np.sum(rel[order[:k]] * discounts))
            ideal = np.sort(rel)[::-1]
            idcg = float(np.sum(ideal[:k] * discounts))
            out.append(dcg / idcg if idcg > 0 else 0.0)
        return float(np.mean(out)) if out else 0.0

    def evaluate_map(self, x, threshold: float = 0.0) -> float:
        """Mean average precision over the query groups."""
        self._check_initialized()
        out = []
        for scores, labels in self._group_scores(x):
            rel = (labels > threshold)
            order = np.argsort(-scores)
            hits = 0
            precisions = []
            for rank, idx in enumerate(order, start=1):
                if rel[idx]:
                    hits += 1
                    precisions.append(hits / rank)
            out.append(float(np.mean(precisions)) if precisions else 0.0)
        return float(np.mean(out)) if out else 0.0


class ZooModel(Model):
    """Subclasses build their graph and call ``super().__init__`` with its
    inputs and outputs (and ``device=``, default the card)."""

    def summary(self) -> str:
        """Parameter counts by layer (trainable parameters, as the JAX
        package counts its params tree), in graph order."""
        lines = [f"Model: {type(self).__name__}"]
        total = 0
        for layer in dict.fromkeys(self.layers):
            n = layer.param_count()
            if n:
                total += n
                lines.append(f"  {layer.name}: {n:,} params")
        lines.append(f"Total params: {total:,}")
        return "\n".join(lines)
