"""mxnet_tpu_torch.serving — the port's serving layer: the
continuous-batching generation engine, its bucketing helpers and error
types.  The micro-batching ``InferenceService`` and the router come with
later slices."""
from .batcher import (BACKPRESSURE_POLICIES, DeadlineExceededError,
                      QueueFullError, RequestShedError, ServingClosedError,
                      ServingError)
from .bucketing import (batch_buckets, bucket_batch, bucket_seq_len,
                        pad_tokens_right, seq_buckets)
from .generation import (GenerationConfig, GenerationService,
                         GenerationStepError, GenerationStream)
from . import generation

__all__ = ["ServingError", "QueueFullError", "DeadlineExceededError",
           "RequestShedError", "ServingClosedError", "BACKPRESSURE_POLICIES",
           "batch_buckets", "bucket_batch", "seq_buckets", "bucket_seq_len",
           "pad_tokens_right", "GenerationService", "GenerationConfig",
           "GenerationStream", "GenerationStepError", "generation"]
