"""Model zoo: the decoder LM that LLM serving runs
(``models/generation.py``), the recommendation models
(``models/recommendation.py``), TextClassifier, AnomalyDetector,
ImageClassifier, KNRM (with the ``Ranker`` metrics) and Seq2seq."""

from analytics_zoo_tpu_torch.models.anomalydetection import AnomalyDetector
from analytics_zoo_tpu_torch.models.common import Ranker, ZooModel
from analytics_zoo_tpu_torch.models.generation import DecoderLM
from analytics_zoo_tpu_torch.models.imageclassification import (
    ImageClassifier)
from analytics_zoo_tpu_torch.models.recommendation import (
    ColumnFeatureInfo, NeuralCF, SessionRecommender, UserItemFeature,
    WideAndDeep, assemble_feature_dict, get_deep_tensors, get_wide_tensor)
from analytics_zoo_tpu_torch.models.seq2seq import Seq2seq
from analytics_zoo_tpu_torch.models.textclassification import TextClassifier
from analytics_zoo_tpu_torch.models.textmatching import KNRM

__all__ = ["AnomalyDetector", "ColumnFeatureInfo", "DecoderLM",
           "ImageClassifier", "KNRM", "NeuralCF", "Ranker", "Seq2seq",
           "SessionRecommender", "TextClassifier", "UserItemFeature",
           "WideAndDeep", "ZooModel",
           "assemble_feature_dict", "get_deep_tensors", "get_wide_tensor"]
