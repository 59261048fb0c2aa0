"""Attention and its hand-written CUDA kernel (``ops/csrc``)."""

from analytics_zoo_tpu_torch.ops.attention import flash_attention

__all__ = ["flash_attention"]
