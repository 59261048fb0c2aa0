"""Model zoo: so far the decoder LM that LLM serving runs
(``models/generation.py``)."""

from analytics_zoo_tpu_torch.models.generation import DecoderLM

__all__ = ["DecoderLM"]
