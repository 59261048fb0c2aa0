"""TFPark: the BERT text estimators and the dataset facade."""

from analytics_zoo_tpu_torch.tfpark.text_estimators import (
    BERTBaseEstimator, BERTClassifier, BERTNER, BERTSQuAD)
from analytics_zoo_tpu_torch.tfpark.tf_dataset import TFDataset

__all__ = ["BERTBaseEstimator", "BERTClassifier", "BERTNER", "BERTSQuAD",
           "TFDataset"]
