"""Parallelism and distribution of the port.

PyTorch counterpart of ``mxnet_tpu/parallel/``, one process per device
over ``torch.distributed``:

- mesh.py            named meshes over the world's ranks (NCCL on the
                     card, gloo on the CPU), the spec records that cut and
                     gather arrays
- collectives.py     differentiable named-axis collectives
- data_parallel.py   ``DataParallelTrainer``, with or without a mesh, and
                     the pure functions of a Gluon block's parameters
- compression.py     2-bit gradient compression with error feedback
- ring_attention.py  ring attention over the sequence axis, and the
                     single-device attention
- sequence_parallel.py  Ulysses attention (dense or flash)
- transformer.py     the decoder LM, its single-device step, the dp x sp
                     sharded step, its tensor-parallel forward and the
                     dp x mp partitioned step
- partition_rules.py regex -> PartitionSpec sharding rules of named
                     parameters (tensor-parallel and FSDP storage)
- pipeline.py        GPipe pipeline parallelism over a ``pp`` axis
- moe.py             Switch-style top-1 mixture of experts over ``ep``
"""
from . import (collectives, compression, data_parallel, mesh, moe,
               partition_rules, pipeline, ring_attention, sequence_parallel,
               transformer)
from .compression import GradientCompression
from .data_parallel import (DataParallelTrainer, block_apply_fn,
                            block_train_fn)
from .mesh import MeshConfig, dp_mesh, get_mesh, local_mesh, make_mesh
from .partition_rules import (make_param_specs, make_shard_and_gather_fns,
                              match_partition_rules)
from .ring_attention import (local_attention, ring_attention,
                             ring_attention_sharded)
from .sequence_parallel import ulysses_attention, ulysses_attention_sharded
from .transformer import (TransformerConfig, lm_loss, make_sharded_train_step,
                          params_from_jax, shard_batch, train_step,
                          transformer_lm_apply, transformer_lm_decode,
                          transformer_lm_init)

__all__ = ["MeshConfig", "get_mesh", "make_mesh", "local_mesh", "dp_mesh",
           "mesh", "collectives", "compression", "data_parallel",
           "ring_attention", "sequence_parallel", "transformer",
           "GradientCompression", "DataParallelTrainer", "block_apply_fn",
           "block_train_fn", "ring_attention_sharded", "local_attention",
           "ulysses_attention", "ulysses_attention_sharded",
           "TransformerConfig", "params_from_jax", "transformer_lm_apply",
           "transformer_lm_decode", "transformer_lm_init", "lm_loss",
           "train_step", "make_sharded_train_step", "shard_batch",
           "partition_rules", "match_partition_rules", "make_param_specs",
           "make_shard_and_gather_fns", "pipeline", "moe"]
