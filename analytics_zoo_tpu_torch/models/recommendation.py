"""Recommendation models: NeuralCF, WideAndDeep and SessionRecommender.

Port of ``analytics_zoo_tpu/models/recommendation.py``: the same graphs,
layer names and parameter trees, built from the port's functional
``Model``, with the ``Recommender`` helper API
(``predict_user_item_pair`` / ``recommend_for_user`` /
``recommend_for_item``) and the host-side feature assembly
(``get_wide_tensor`` / ``get_deep_tensors`` / ``assemble_feature_dict``,
copies of the JAX package's numpy code).  The embedding gathers and the
towers' products are PyTorch calls: the JAX package computes them outside
any Pallas kernel.  ``SessionRecommender`` is a GRU over the session's
items, with an optional multi-hot history tower, and
``recommend_for_session``.

The models take ``device=`` (default: the card; raises without one).
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import Dict, List, Optional, Sequence

import numpy as np

from analytics_zoo_tpu_torch.data.featureset import FeatureSet
from analytics_zoo_tpu_torch.keras import layers as L
from analytics_zoo_tpu_torch.keras.engine import Input
from analytics_zoo_tpu_torch.models.common import ZooModel


@dataclass
class UserItemFeature:
    """(user, item, label) sample triple."""
    user_id: int
    item_id: int
    label: int = 1


class NeuralCF(ZooModel):
    """Neural Collaborative Filtering (He et al.): a GMF tower (the
    elementwise product of the mf embeddings) and an MLP tower (the
    concatenated embeddings through ``hidden_layers``), concatenated into
    a ``class_num``-way softmax.

    With ``fused_tables=True`` (the default, with ``include_mf``) the MLP
    and MF embeddings of an entity live in one table of width
    ``embed + mf_embed``, split after the gather.  The parameter layout
    differs from ``fused_tables=False``, as in the JAX package.  Ids are
    1-based: each table has ``count + 1`` rows."""

    def __init__(self, user_count: int, item_count: int, class_num: int = 2,
                 user_embed: int = 20, item_embed: int = 20,
                 hidden_layers: Sequence[int] = (40, 20, 10),
                 include_mf: bool = True, mf_embed: int = 20,
                 fused_tables: bool = True, **kw):
        # plain attributes may precede nn.Module.__init__
        self.user_count = user_count
        self.item_count = item_count
        self.class_num = class_num
        self.include_mf = include_mf
        self.fused_tables = fused_tables and include_mf

        user = Input((1,), name="user")
        item = Input((1,), name="item")
        if self.fused_tables:
            u_all = L.Flatten()(L.Embedding(
                user_count + 1, user_embed + mf_embed,
                name="user_embed")(user))
            i_all = L.Flatten()(L.Embedding(
                item_count + 1, item_embed + mf_embed,
                name="item_embed")(item))
            u = L.Narrow(1, 0, user_embed, name="u_mlp")(u_all)
            i = L.Narrow(1, 0, item_embed, name="i_mlp")(i_all)
            mf_u = L.Narrow(1, user_embed, mf_embed, name="u_mf")(u_all)
            mf_i = L.Narrow(1, item_embed, mf_embed, name="i_mf")(i_all)
        else:
            u = L.Flatten()(L.Embedding(user_count + 1, user_embed,
                                        name="user_embed")(user))
            i = L.Flatten()(L.Embedding(item_count + 1, item_embed,
                                        name="item_embed")(item))
            if include_mf:
                mf_u = L.Flatten()(L.Embedding(user_count + 1, mf_embed,
                                               name="mf_user_embed")(user))
                mf_i = L.Flatten()(L.Embedding(item_count + 1, mf_embed,
                                               name="mf_item_embed")(item))
        mlp = L.Merge(mode="concat")([u, i])
        for idx, width in enumerate(hidden_layers):
            mlp = L.Dense(width, activation="relu",
                          name=f"mlp_dense_{idx}")(mlp)
        if include_mf:
            gmf = L.Merge(mode="mul")([mf_u, mf_i])
            merged = L.Merge(mode="concat")([gmf, mlp])
        else:
            merged = mlp
        out = L.Dense(class_num, activation="softmax", name="head")(merged)
        super().__init__(input=[user, item], output=out, **kw)

    # ---- Recommender API --------------------------------------------------
    def _scores(self, users: np.ndarray, items: np.ndarray,
                batch_size: int) -> np.ndarray:
        fs = FeatureSet.from_ndarrays(
            {"user": users[:, None], "item": items[:, None]}, shuffle=False)
        return self.predict(fs, batch_size=batch_size)

    def predict_user_item_pair(self, pairs: Sequence[UserItemFeature],
                               batch_size: int = 1024) -> np.ndarray:
        users = np.array([p.user_id for p in pairs], np.int32)
        items = np.array([p.item_id for p in pairs], np.int32)
        return self._scores(users, items, batch_size)

    def recommend_for_user(self, user_id: int, max_items: int,
                           candidate_items: Optional[Sequence[int]] = None,
                           batch_size: int = 1024):
        items = np.asarray(candidate_items if candidate_items is not None
                           else np.arange(1, self.item_count + 1), np.int32)
        users = np.full_like(items, user_id)
        probs = self._scores(users, items, batch_size)
        score = probs[:, -1] if probs.ndim == 2 else probs
        order = np.argsort(-score)[:max_items]
        return [(int(items[j]), float(score[j])) for j in order]

    def recommend_for_item(self, item_id: int, max_users: int,
                           candidate_users: Optional[Sequence[int]] = None,
                           batch_size: int = 1024):
        users = np.asarray(candidate_users if candidate_users is not None
                           else np.arange(1, self.user_count + 1), np.int32)
        items = np.full_like(users, item_id)
        probs = self._scores(users, items, batch_size)
        score = probs[:, -1] if probs.ndim == 2 else probs
        order = np.argsort(-score)[:max_users]
        return [(int(users[j]), float(score[j])) for j in order]


_MODEL_TYPES = ("wide", "deep", "wide_n_deep")


@dataclass
class ColumnFeatureInfo:
    """Feature-column schema for WideAndDeep."""
    wide_base_cols: Sequence[str] = ()
    wide_base_dims: Sequence[int] = ()
    wide_cross_cols: Sequence[str] = ()
    wide_cross_dims: Sequence[int] = ()
    indicator_cols: Sequence[str] = ()
    indicator_dims: Sequence[int] = ()
    embed_cols: Sequence[str] = ()
    embed_in_dims: Sequence[int] = ()
    embed_out_dims: Sequence[int] = ()
    continuous_cols: Sequence[str] = ()


class WideAndDeep(ZooModel):
    """Wide & Deep (Cheng et al.).

    Inputs (dict):
      - ``wide``: dense multi-hot 0/1 vector over the wide space, shape
        (B, W) float where W = sum(wide_base_dims) + sum(wide_cross_dims).
      - one int column per embed col, shape (B, 1)
      - ``indicator``: concatenated one-hot, shape (B, sum indicator_dims)
      - ``continuous``: (B, len(continuous_cols))
    """

    def __init__(self, model_type: str = "wide_n_deep",
                 class_num: int = 2,
                 column_info: ColumnFeatureInfo = None,
                 hidden_layers: Sequence[int] = (40, 20, 10), **kw):
        if model_type not in _MODEL_TYPES:
            raise ValueError(
                f"bad model_type {model_type!r}; use one of {_MODEL_TYPES}")
        if column_info is None:
            raise ValueError("column_info is required")
        self.model_type = model_type
        self.column_info = column_info
        ci = column_info
        self.wide_dim = int(sum(ci.wide_base_dims) + sum(ci.wide_cross_dims))

        inputs = []
        towers = []
        if model_type in ("wide", "wide_n_deep"):
            wide = Input((self.wide_dim,), name="wide")
            inputs.append(wide)
            towers.append(L.Dense(class_num, bias=False, name="wide_linear")(
                wide))
        if model_type in ("deep", "wide_n_deep"):
            deep_parts = []
            embed_inputs = []
            for col, din, dout in zip(ci.embed_cols, ci.embed_in_dims,
                                      ci.embed_out_dims):
                inp = Input((1,), name=col)
                embed_inputs.append(inp)
                emb = L.Embedding(din + 1, dout, name=f"embed_{col}")(inp)
                deep_parts.append(L.Flatten()(emb))
            inputs.extend(embed_inputs)
            if ci.indicator_cols:
                ind = Input((int(sum(ci.indicator_dims)),), name="indicator")
                inputs.append(ind)
                deep_parts.append(ind)
            if ci.continuous_cols:
                cont = Input((len(ci.continuous_cols),), name="continuous")
                inputs.append(cont)
                deep_parts.append(cont)
            if not deep_parts:
                raise ValueError(
                    "deep tower needs at least one embed/indicator/"
                    "continuous column in ColumnFeatureInfo")
            deep = (L.Merge(mode="concat")(deep_parts)
                    if len(deep_parts) > 1 else deep_parts[0])
            for idx, width in enumerate(hidden_layers):
                deep = L.Dense(width, activation="relu",
                               name=f"deep_dense_{idx}")(deep)
            towers.append(L.Dense(class_num, name="deep_head")(deep))
        merged = (L.Merge(mode="sum")(towers) if len(towers) > 1
                  else towers[0])
        out = L.Activation("softmax")(merged)
        super().__init__(input=inputs, output=out, **kw)


def _one_hot_blocks(columns: Dict[str, np.ndarray], cols, dims,
                    n: int) -> List[np.ndarray]:
    """Per-column one-hot blocks; ids wrap with ``% dim`` (the reference's
    hash-bucket semantics)."""
    parts = []
    for col, dim in zip(cols, dims):
        idx = np.asarray(columns[col]).reshape(n).astype(np.int64) % dim
        oh = np.zeros((n, dim), np.float32)
        oh[np.arange(n), idx] = 1.0
        parts.append(oh)
    return parts


def get_wide_tensor(columns: Dict[str, np.ndarray],
                    column_info: ColumnFeatureInfo) -> np.ndarray:
    """The one-hot wide tensor from raw columns: base columns one-hot and
    pre-hashed cross columns."""
    ci = column_info
    if not columns:
        raise ValueError("empty column dict: nothing to assemble")
    first = next(iter(columns.values()))
    n = np.asarray(first).shape[0]
    parts = (_one_hot_blocks(columns, ci.wide_base_cols,
                             ci.wide_base_dims, n)
             + _one_hot_blocks(columns, ci.wide_cross_cols,
                               ci.wide_cross_dims, n))
    if not parts:
        raise ValueError("column_info declares no wide columns")
    return np.concatenate(parts, axis=1)


def get_deep_tensors(columns: Dict[str, np.ndarray],
                     column_info: ColumnFeatureInfo) -> Dict[str, np.ndarray]:
    """The deep tower's inputs from raw columns: embed indices per column,
    concatenated indicator one-hots, stacked continuous features."""
    ci = column_info
    if not columns:
        raise ValueError("empty column dict: nothing to assemble")
    first = next(iter(columns.values()))
    n = np.asarray(first).shape[0]
    out: Dict[str, np.ndarray] = {}
    for col, din in zip(ci.embed_cols, ci.embed_in_dims):
        idx = np.asarray(columns[col]).reshape(n, 1).astype(np.int64)
        # the same wrap as the one-hot columns: the table has din + 1 rows
        out[col] = (idx % (din + 1)).astype(np.int32)
    if ci.indicator_cols:
        out["indicator"] = np.concatenate(
            _one_hot_blocks(columns, ci.indicator_cols, ci.indicator_dims,
                            n), axis=1)
    if ci.continuous_cols:
        out["continuous"] = np.stack(
            [np.asarray(columns[c]).reshape(n).astype(np.float32)
             for c in ci.continuous_cols], axis=1)
    return out


def assemble_feature_dict(columns: Dict[str, np.ndarray],
                          column_info: ColumnFeatureInfo,
                          model_type: str = "wide_n_deep"
                          ) -> Dict[str, np.ndarray]:
    """Raw column dict (or DataFrame via ``dict(df)``) -> the WideAndDeep
    input dict for the chosen model_type."""
    if model_type not in _MODEL_TYPES:
        raise ValueError(
            f"bad model_type {model_type!r}; use one of {_MODEL_TYPES}")
    out: Dict[str, np.ndarray] = {}
    if model_type in ("wide", "wide_n_deep"):
        out["wide"] = get_wide_tensor(columns, column_info)
    if model_type in ("deep", "wide_n_deep"):
        out.update(get_deep_tensors(columns, column_info))
    return out


class SessionRecommender(ZooModel):
    """Session-based recommender: GRUs over the session's item sequence,
    with an optional MLP over the user's history, into an
    ``item_count + 1``-way softmax (ids are 1-based)."""

    def __init__(self, item_count: int, item_embed: int = 20,
                 rnn_hidden_layers: Sequence[int] = (40, 20),
                 session_length: int = 10, include_history: bool = False,
                 mlp_hidden_layers: Sequence[int] = (40, 20),
                 history_length: int = 5, **kw):
        self.item_count = item_count
        self.include_history = include_history
        session = Input((session_length,), name="session")
        inputs = [session]
        h = L.Embedding(item_count + 1, item_embed, name="session_embed")(
            session)
        for idx, width in enumerate(rnn_hidden_layers[:-1]):
            h = L.GRU(width, return_sequences=True, name=f"gru_{idx}")(h)
        h = L.GRU(rnn_hidden_layers[-1], name="gru_last")(h)
        if include_history:
            history = Input((history_length,), name="history")
            inputs.append(history)
            hh = L.Flatten()(L.Embedding(item_count + 1, item_embed,
                                         name="history_embed")(history))
            for idx, width in enumerate(mlp_hidden_layers):
                hh = L.Dense(width, activation="relu",
                             name=f"hist_dense_{idx}")(hh)
            h = L.Merge(mode="concat")([h, hh])
        out = L.Dense(item_count + 1, activation="softmax", name="head")(h)
        super().__init__(input=inputs, output=out, **kw)

    def recommend_for_session(self, sessions: np.ndarray, max_items: int,
                              zero_based_label: bool = True,
                              batch_size: int = 1024):
        """The top ``max_items`` (item, probability) of each session, as
        the JAX model ranks them (its input: the sessions alone)."""
        fs = FeatureSet.from_ndarrays(np.asarray(sessions, np.int32),
                                      shuffle=False)
        probs = self.predict(fs, batch_size=batch_size)
        out = []
        for row in probs:
            order = np.argsort(-row)[:max_items]
            out.append([(int(j) if zero_based_label else int(j) + 1,
                         float(row[j])) for j in order])
        return out
