"""mxnet_tpu_torch.serving.generation — continuous-batching LM generation
over a paged KV cache (Orca's iteration-level scheduling, vLLM's paged
memory model), the PyTorch counterpart of
``mxnet_tpu.serving.generation``."""
from .engine import (GenerationConfig, GenerationService, GenerationStepError,
                     GenerationStream)
from .kv_cache import BlockAllocator, PagedKVCache, blocks_for
from .prefix_cache import PrefixCacheIndex
from .programs import GenerationPrograms

__all__ = ["GenerationService", "GenerationConfig", "GenerationStream",
           "GenerationStepError", "PagedKVCache", "BlockAllocator",
           "GenerationPrograms", "PrefixCacheIndex", "blocks_for"]
