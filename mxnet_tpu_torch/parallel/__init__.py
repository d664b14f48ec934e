"""Model code of the port: the decoder-only transformer LM, its
single-device attention, and its training loss and step."""
from . import ring_attention, transformer
from .ring_attention import local_attention
from .transformer import (TransformerConfig, lm_loss, params_from_jax,
                          train_step, transformer_lm_apply,
                          transformer_lm_decode, transformer_lm_init)

__all__ = ["ring_attention", "transformer", "local_attention",
           "TransformerConfig", "params_from_jax", "transformer_lm_apply",
           "transformer_lm_decode", "transformer_lm_init", "lm_loss",
           "train_step"]
