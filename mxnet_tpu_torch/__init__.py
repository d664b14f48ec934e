"""mxnet_tpu_torch — the PyTorch/CUDA port of mxnet_tpu, for NVIDIA Hopper.

The JAX package ``mxnet_tpu`` is the reference; this package grows beside
it slice by slice, with the same module paths and names, in PyTorch idiom.
Every kernel the reference wrote in Pallas for the TPU is a kernel written
by hand for Hopper (``ops/csrc/*.cu``, built at first use), each with a
plain PyTorch version that CPU tensors take.  The package imports torch and
numpy, never jax and nothing of ``mxnet_tpu``.

Ported so far: the decoder-only transformer LM, the continuous-batching
generation engine over a paged KV cache (fused LayerNorm and paged
attention kernels), and the LM's single-device training step with flash
attention (forward, dQ and dK/dV kernels).  Entry points run on ``cuda``
unless the caller passes ``device="cpu"``.
"""
from . import base, context, ops, parallel, serving
from .base import MXNetError
from .context import resolve_device

__version__ = "0.1.0"

__all__ = ["MXNetError", "resolve_device", "base", "context", "ops",
           "parallel", "serving"]
