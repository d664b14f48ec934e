"""Model code of the port: the decoder-only transformer LM, its
single-device attention, and its training loss and step; pure functions
of a Gluon block's parameters and the mesh-less ``DataParallelTrainer``
(``data_parallel``) with its 2-bit gradient compression
(``compression``)."""
from . import compression, data_parallel, ring_attention, transformer
from .compression import GradientCompression
from .data_parallel import (DataParallelTrainer, block_apply_fn,
                            block_train_fn)
from .ring_attention import local_attention
from .transformer import (TransformerConfig, lm_loss, params_from_jax,
                          train_step, transformer_lm_apply,
                          transformer_lm_decode, transformer_lm_init)

__all__ = ["compression", "data_parallel", "ring_attention", "transformer",
           "GradientCompression", "DataParallelTrainer", "block_apply_fn",
           "block_train_fn", "local_attention",
           "TransformerConfig", "params_from_jax", "transformer_lm_apply",
           "transformer_lm_decode", "transformer_lm_init", "lm_loss",
           "train_step"]
