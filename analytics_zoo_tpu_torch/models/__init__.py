"""Model zoo: the decoder LM that LLM serving runs
(``models/generation.py``) and the recommendation models
(``models/recommendation.py``)."""

from analytics_zoo_tpu_torch.models.common import ZooModel
from analytics_zoo_tpu_torch.models.generation import DecoderLM
from analytics_zoo_tpu_torch.models.recommendation import (
    ColumnFeatureInfo, NeuralCF, UserItemFeature, WideAndDeep,
    assemble_feature_dict, get_deep_tensors, get_wide_tensor)

__all__ = ["ColumnFeatureInfo", "DecoderLM", "NeuralCF", "UserItemFeature",
           "WideAndDeep", "ZooModel", "assemble_feature_dict",
           "get_deep_tensors", "get_wide_tensor"]
