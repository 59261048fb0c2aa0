"""Attention and dropout, with the hand-written CUDA kernels (``ops/csrc``)."""

from analytics_zoo_tpu_torch.ops.attention import flash_attention
from analytics_zoo_tpu_torch.ops.dropout import hash_dropout

__all__ = ["flash_attention", "hash_dropout"]
