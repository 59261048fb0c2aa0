"""The training engine and its checkpoints."""

from analytics_zoo_tpu_torch.estimator.checkpoint import (
    latest_checkpoint, restore_checkpoint, save_checkpoint)
from analytics_zoo_tpu_torch.estimator.estimator import Estimator

__all__ = ["Estimator", "latest_checkpoint", "restore_checkpoint",
           "save_checkpoint"]
