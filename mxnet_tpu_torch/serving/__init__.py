"""mxnet_tpu_torch.serving — online inference serving (PyTorch
counterpart of ``mxnet_tpu.serving``): the micro-batching
``InferenceService`` over a Module, Executor, Gluon block or callable
(dynamic micro-batching, shape-bucketed executors, warmup, backpressure,
deadlines, serving metrics), the continuous-batching generation engine,
the multi-replica ``GenerationRouter``, the bucketing helpers and the
error types."""
from .batcher import (BACKPRESSURE_POLICIES, DeadlineExceededError,
                      QueueFullError, RequestShedError, ServingClosedError,
                      ServingConfig, ServingError)
from .bucketing import (assemble_batch, batch_buckets, bucket_batch,
                        bucket_seq_len, bucket_shape, next_pow2,
                        pad_batch_rows, pad_sample, pad_tokens_right,
                        seq_buckets)
from .metrics import ServingMetrics
from .service import InferenceService
from .generation import (GenerationConfig, GenerationService,
                         GenerationStepError, GenerationStream)
from .router import (GenerationRouter, NoHealthyReplicaError,
                     ReplicaDeadError, RouterConfig, RouterStream)
from . import generation
from . import metrics
from . import router

__all__ = ["InferenceService", "ServingConfig", "ServingMetrics",
           "ServingError", "QueueFullError", "DeadlineExceededError",
           "RequestShedError", "ServingClosedError", "BACKPRESSURE_POLICIES",
           "next_pow2", "batch_buckets", "bucket_batch", "bucket_shape",
           "pad_sample", "pad_batch_rows", "assemble_batch",
           "seq_buckets", "bucket_seq_len", "pad_tokens_right",
           "GenerationService", "GenerationConfig", "GenerationStream",
           "GenerationStepError", "GenerationRouter", "RouterConfig",
           "RouterStream", "ReplicaDeadError", "NoHealthyReplicaError",
           "generation", "metrics", "router"]
