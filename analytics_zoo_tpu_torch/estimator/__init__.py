"""The training engine."""

from analytics_zoo_tpu_torch.estimator.estimator import Estimator

__all__ = ["Estimator"]
