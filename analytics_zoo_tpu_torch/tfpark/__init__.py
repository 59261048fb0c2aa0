"""BERT text estimators."""

from analytics_zoo_tpu_torch.tfpark.text_estimators import BERTClassifier

__all__ = ["BERTClassifier"]
