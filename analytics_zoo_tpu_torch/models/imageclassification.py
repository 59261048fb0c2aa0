"""ImageClassifier: the lenet, VGG-style and resnet-lite backbones over
the layer catalogue, with top-N labelling.

Port of ``analytics_zoo_tpu/models/imageclassification.py``: the same
graphs, auto-named layers and parameter trees (build two models from
``keras.engine.reset_uids()`` to compare), and ``label_output``.  Takes
``device=`` (default: the card; raises without one).
"""

from __future__ import annotations

from typing import Optional, Sequence

import numpy as np

from analytics_zoo_tpu_torch.keras import layers as L
from analytics_zoo_tpu_torch.keras.engine import Input
from analytics_zoo_tpu_torch.models.common import ZooModel


def _lenet(inp, class_num):
    h = L.Convolution2D(6, 5, 5, activation="tanh",
                        border_mode="same")(inp)
    h = L.MaxPooling2D()(h)
    h = L.Convolution2D(16, 5, 5, activation="tanh")(h)
    h = L.MaxPooling2D()(h)
    h = L.Flatten()(h)
    h = L.Dense(120, activation="tanh")(h)
    h = L.Dense(84, activation="tanh")(h)
    return L.Dense(class_num, activation="softmax")(h)


def _vgg_lite(inp, class_num):
    h = inp
    for filters in (32, 64, 128):
        h = L.Convolution2D(filters, 3, 3, activation="relu",
                            border_mode="same")(h)
        h = L.Convolution2D(filters, 3, 3, activation="relu",
                            border_mode="same")(h)
        h = L.MaxPooling2D()(h)
    h = L.Flatten()(h)
    h = L.Dense(256, activation="relu")(h)
    h = L.Dropout(0.5)(h)
    return L.Dense(class_num, activation="softmax")(h)


def _resnet_lite(inp, class_num):
    h = L.Convolution2D(32, 3, 3, activation="relu", border_mode="same")(inp)
    for filters in (32, 64):
        shortcut = h
        b = L.Convolution2D(filters, 3, 3, activation="relu",
                            border_mode="same")(h)
        b = L.Convolution2D(filters, 3, 3, border_mode="same")(b)
        if filters != 32:
            shortcut = L.Convolution2D(filters, 1, 1,
                                       border_mode="same")(shortcut)
        h = L.Activation("relu")(L.Merge(mode="sum")([b, shortcut]))
        h = L.MaxPooling2D()(h)
    h = L.GlobalAveragePooling2D()(h)
    return L.Dense(class_num, activation="softmax")(h)


_BACKBONES = {"lenet": _lenet, "vgg": _vgg_lite, "resnet": _resnet_lite}


class ImageClassifier(ZooModel):
    def __init__(self, class_num: int, image_shape=(28, 28, 1),
                 backbone: str = "lenet",
                 labels: Optional[Sequence[str]] = None, **kw):
        try:
            builder = _BACKBONES[backbone]
        except KeyError:
            raise ValueError(f"unknown backbone {backbone}") from None
        self.labels = list(labels) if labels else None
        inp = Input(image_shape, name="image")
        out = builder(inp, class_num)
        super().__init__(input=inp, output=out, **kw)

    def label_output(self, probs: np.ndarray, top_n: int = 5):
        """Top-N (label, prob) per image."""
        out = []
        for row in np.atleast_2d(probs):
            order = np.argsort(-row)[:top_n]
            out.append([
                (self.labels[j] if self.labels else int(j), float(row[j]))
                for j in order])
        return out
