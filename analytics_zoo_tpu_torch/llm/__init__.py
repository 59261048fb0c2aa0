"""Generative LLM serving: paged KV cache, continuous-batching scheduler,
token streaming on the binary wire."""

from analytics_zoo_tpu_torch.llm.kv_cache import (     # noqa: F401
    BlockPool, BlockPoolExhausted, BlockTable, PagedKVCache)
from analytics_zoo_tpu_torch.llm.prefix_cache import (  # noqa: F401
    RadixPrefixCache)
from analytics_zoo_tpu_torch.llm.scheduler import (    # noqa: F401
    ContinuousBatchingScheduler, GenSequence)
from analytics_zoo_tpu_torch.llm.engine import LLMServing      # noqa: F401
from analytics_zoo_tpu_torch.llm.client import GenerationClient  # noqa: F401
