"""TFDataset: the TFPark dataset facade, for ndarrays.

Port of ``TFDataset`` from ``analytics_zoo_tpu/tfpark/tf_dataset.py``
(``__init__``, ``from_ndarrays``, ``effective_batch_size``,
``check_train_batching``, ``get_training_data``).  The two batch modes
are kept: ``batch_size`` is the global training batch, and
``batch_per_thread`` the per-device inference batch.  The port runs on one
device, so the device count in both rules is 1.  The DRAM tier and the
DEVICE tier (``memory_type="DEVICE"``: the training batches resident on
the card, ``FeatureSet.cache_device``) are ported, with the validation set
(``validation_featureset=``, ``val_tensors=``); the other factories are
not (ROADMAP Queue 1 item 3).
"""

from __future__ import annotations

from analytics_zoo_tpu_torch.data.featureset import FeatureSet

NUM_DEVICES = 1


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


def _split_tensors(tensors):
    if isinstance(tensors, tuple) and len(tensors) == 2:
        return tensors
    return tensors, None
