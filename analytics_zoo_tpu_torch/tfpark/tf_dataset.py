"""TFDataset: the TFPark dataset facade.

Port of ``TFDataset`` from ``analytics_zoo_tpu/tfpark/tf_dataset.py``
(``__init__``, ``effective_batch_size``, ``check_train_batching``,
``get_training_data`` and the factories ``from_ndarrays``,
``from_dataframe``, ``from_tfrecord_file``, ``from_feature_set`` and
``from_generator``).  The two batch modes are kept: ``batch_size`` is the
global training batch, and ``batch_per_thread`` the per-device inference
batch.  The port runs on one device, so the device count in both rules is
1.  ``from_ndarrays(memory_type="DEVICE")`` keeps the training batches
resident on the card (``FeatureSet.cache_device``).  The RDD, image-set,
text-set, string / bytes and ``tf.data`` factories need ``feature/`` and
the rest of ``tfpark/`` (ROADMAP Queue 1 item 6) and raise naming it.
"""

from __future__ import annotations

from typing import Callable, Sequence

from analytics_zoo_tpu_torch.common.unported import QUEUE_ITEMS
from analytics_zoo_tpu_torch.data.featureset import (FeatureSet,
                                                     GeneratorFeatureSet)

NUM_DEVICES = 1


def _unported(name: str):
    def stub(*args, **kwargs):
        raise NotImplementedError(f"TFDataset.{name} is not ported yet "
                                  f"({QUEUE_ITEMS[6]})")
    stub.__name__ = name
    return stub


class TFDataset:
    """Dataset facade carrying batching semantics."""

    def __init__(self, featureset, batch_size: int = -1,
                 batch_per_thread: int = -1, has_labels: bool = True,
                 validation_featureset=None):
        if (batch_size > 0) == (batch_per_thread > 0):
            raise ValueError(
                "one and only one of batch_size and batch_per_thread should "
                "be specified")
        self.featureset = featureset
        self.validation_featureset = validation_featureset
        self.has_labels = has_labels
        self.batch_size = batch_size
        self.batch_per_thread = batch_per_thread

    @property
    def effective_batch_size(self) -> int:
        """Global batch actually used per step."""
        if self.batch_size > 0:
            return self.batch_size
        return self.batch_per_thread * NUM_DEVICES

    def check_train_batching(self) -> None:
        """Fail fast when every training epoch would yield zero batches
        (training drops ragged remainders)."""
        if self.effective_batch_size > len(self):
            raise ValueError(
                f"batch size {self.effective_batch_size} exceeds dataset "
                f"size {len(self)}: every epoch would yield zero batches")

    def get_training_data(self):
        return self.featureset

    def get_validation_data(self):
        return self.validation_featureset

    def __len__(self):
        return len(self.featureset)

    @staticmethod
    def from_ndarrays(tensors, batch_size: int = -1,
                      batch_per_thread: int = -1, val_tensors=None,
                      memory_type: str = "DRAM") -> "TFDataset":
        """``(features,)`` or ``(features, labels)`` numpy trees.
        ``memory_type="DEVICE"`` keeps the training batches resident on the
        card across epochs (``FeatureSet.cache_device``); ``val_tensors``
        is the validation set, read by ``get_validation_data``."""
        feats, labels = _split_tensors(tensors)
        fs = FeatureSet.from_ndarrays(feats, labels)
        if memory_type.upper() in ("DEVICE", "HBM"):
            fs = fs.cache_device()
        val = None
        if val_tensors is not None:
            vf, vl = _split_tensors(val_tensors)
            val = FeatureSet.from_ndarrays(vf, vl)
        return TFDataset(fs, batch_size, batch_per_thread,
                         has_labels=labels is not None,
                         validation_featureset=val)

    @staticmethod
    def from_dataframe(df, feature_cols: Sequence[str],
                       labels_cols: Sequence[str] = (),
                       batch_size: int = -1, batch_per_thread: int = -1,
                       val_df=None) -> "TFDataset":
        """A DataFrame's columns (``FeatureSet.from_dataframe``)."""
        labels = list(labels_cols) or None
        fs = FeatureSet.from_dataframe(df, feature_cols, labels)
        val = (FeatureSet.from_dataframe(val_df, feature_cols, labels)
               if val_df is not None else None)
        return TFDataset(fs, batch_size, batch_per_thread,
                         has_labels=bool(labels_cols),
                         validation_featureset=val)

    @staticmethod
    def from_tfrecord_file(file_path, feature_keys=None, label_keys=None,
                           batch_size: int = -1, batch_per_thread: int = -1,
                           validation_file_path=None) -> "TFDataset":
        """TFRecord files of ``tf.Example`` records
        (``FeatureSet.from_tfrecord_file``): ``feature_keys`` /
        ``label_keys`` pick and order the tensors; default every key,
        sorted, no labels."""
        fs = FeatureSet.from_tfrecord_file(file_path, feature_keys,
                                           label_keys)
        val = (FeatureSet.from_tfrecord_file(validation_file_path,
                                             feature_keys, label_keys)
               if validation_file_path is not None else None)
        return TFDataset(fs, batch_size, batch_per_thread,
                         has_labels=bool(label_keys),
                         validation_featureset=val)

    @staticmethod
    def from_feature_set(dataset, batch_size: int = -1,
                         batch_per_thread: int = -1,
                         validation_dataset=None) -> "TFDataset":
        """Adopt an existing FeatureSet of any tier."""
        return TFDataset(dataset, batch_size, batch_per_thread,
                         validation_featureset=validation_dataset)

    @staticmethod
    def from_generator(generator: Callable, size: int, batch_size: int = -1,
                       batch_per_thread: int = -1) -> "TFDataset":
        """A callable returning an iterator of ``(features, labels)``
        tuples (``GeneratorFeatureSet``)."""
        return TFDataset(GeneratorFeatureSet(generator, size), batch_size,
                         batch_per_thread)

    from_rdd = staticmethod(_unported("from_rdd"))
    from_image_set = staticmethod(_unported("from_image_set"))
    from_text_set = staticmethod(_unported("from_text_set"))
    from_string_rdd = staticmethod(_unported("from_string_rdd"))
    from_bytes_rdd = staticmethod(_unported("from_bytes_rdd"))
    from_tf_data_dataset = staticmethod(_unported("from_tf_data_dataset"))


def _split_tensors(tensors):
    if isinstance(tensors, tuple) and len(tensors) == 2:
        return tensors
    return tensors, None
