"""mxnet_tpu_torch.serving — the port's serving layer: the
continuous-batching generation engine, the multi-replica
``GenerationRouter``, serving metrics, the bucketing helpers and error
types.  The micro-batching ``InferenceService`` comes with a later
slice."""
from .batcher import (BACKPRESSURE_POLICIES, DeadlineExceededError,
                      QueueFullError, RequestShedError, ServingClosedError,
                      ServingError)
from .bucketing import (batch_buckets, bucket_batch, bucket_seq_len,
                        pad_tokens_right, seq_buckets)
from .generation import (GenerationConfig, GenerationService,
                         GenerationStepError, GenerationStream)
from . import generation
from . import metrics
from .metrics import ServingMetrics
from .router import (GenerationRouter, NoHealthyReplicaError,
                     ReplicaDeadError, RouterConfig, RouterStream)
from . import router

__all__ = ["ServingError", "QueueFullError", "DeadlineExceededError",
           "RequestShedError", "ServingClosedError", "BACKPRESSURE_POLICIES",
           "batch_buckets", "bucket_batch", "seq_buckets", "bucket_seq_len",
           "pad_tokens_right", "GenerationService", "GenerationConfig",
           "GenerationStream", "GenerationStepError", "generation",
           "GenerationRouter", "RouterConfig", "RouterStream",
           "ReplicaDeadError", "NoHealthyReplicaError", "ServingMetrics",
           "metrics", "router"]
