"""TFDataset: the TFPark dataset facade, for ndarrays.

Port of ``TFDataset`` from ``analytics_zoo_tpu/tfpark/tf_dataset.py``
(``__init__``, ``from_ndarrays``, ``effective_batch_size``,
``check_train_batching``, ``get_training_data``).  The two batch modes
are kept: ``batch_size`` is the global training batch, and
``batch_per_thread`` the per-device inference batch.  The port runs on one
device, so the device count in both rules is 1.  Only the DRAM tier is
ported; validation sets and the other factories are not.
"""

from __future__ import annotations

from analytics_zoo_tpu_torch.data.featureset import FeatureSet

NUM_DEVICES = 1


class TFDataset:
    """Dataset facade carrying batching semantics."""

    def __init__(self, featureset, batch_size: int = -1,
                 batch_per_thread: int = -1):
        if (batch_size > 0) == (batch_per_thread > 0):
            raise ValueError(
                "one and only one of batch_size and batch_per_thread should "
                "be specified")
        self.featureset = featureset
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

    def __len__(self):
        return len(self.featureset)

    @staticmethod
    def from_ndarrays(tensors, batch_size: int = -1,
                      batch_per_thread: int = -1,
                      memory_type: str = "DRAM") -> "TFDataset":
        """``(features,)`` or ``(features, labels)`` numpy trees.  Only the
        host (DRAM) tier is ported: ``memory_type="DEVICE"`` raises."""
        if memory_type.upper() in ("DEVICE", "HBM"):
            raise NotImplementedError(
                "TFDataset memory_type='DEVICE' (batches resident on the "
                "card) is not ported yet (ROADMAP Queue 1 item 3: data/)")
        feats, labels = (tensors if isinstance(tensors, tuple)
                         and len(tensors) == 2 else (tensors, None))
        return TFDataset(FeatureSet.from_ndarrays(feats, labels), batch_size,
                         batch_per_thread)
