"""The training engine, its checkpoints and the local estimator."""

from analytics_zoo_tpu_torch.estimator.checkpoint import (
    latest_checkpoint, restore_checkpoint, save_checkpoint)
from analytics_zoo_tpu_torch.estimator.estimator import Estimator
from analytics_zoo_tpu_torch.estimator.local_estimator import LocalEstimator

__all__ = ["Estimator", "LocalEstimator", "latest_checkpoint",
           "restore_checkpoint", "save_checkpoint"]
