"""Concurrent inference over a loaded model, and the native
micro-batching service in front of it."""

from analytics_zoo_tpu_torch.inference.inference_model import InferenceModel
from analytics_zoo_tpu_torch.inference.batching import BatchingService

__all__ = ["BatchingService", "InferenceModel"]
