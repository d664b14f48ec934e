"""mxnet_tpu_torch — the PyTorch/CUDA port of mxnet_tpu, for NVIDIA Hopper.

The JAX package ``mxnet_tpu`` is the reference; this package grows beside
it slice by slice, with the same module paths and names, in PyTorch idiom.
Every kernel the reference wrote in Pallas for the TPU is a kernel written
by hand for Hopper (``ops/csrc/*.cu``, built at first use), each with a
plain PyTorch version that CPU tensors take.  The package imports torch and
numpy, never jax and nothing of ``mxnet_tpu``.

Ported so far: the decoder-only transformer LM, the continuous-batching
generation engine over a paged KV cache (fused LayerNorm and paged
attention kernels), the LM's single-device training step with flash
attention (forward, dQ and dK/dV kernels), Gluon with the model zoo's
ResNets, trained channels-last through the BatchNorm stats and normalize
kernels, and the imperative Gluon training loop: ``NDArray``, the autograd
tape API, the optimizers, the local/device kvstore (2-bit compression
through the pack and unpack kernels), ``gluon.Trainer``, ``DataLoader``
and parameter files.  Entry points run on ``cuda`` (``mx.gpu()``, the
default context) unless the caller passes the CPU (``ctx=mx.cpu()`` or
``device="cpu"``).
"""
from . import (autograd, base, context, gluon, initializer, kvstore,
               ndarray, ops, optimizer, parallel, serving)
from . import initializer as init
from . import kvstore as kv
from . import ndarray as nd
from .base import MXNetError
from .context import (Context, cpu, current_context, gpu, num_devices,
                      resolve_device, tpu)

__version__ = "0.1.0"

__all__ = ["MXNetError", "Context", "cpu", "gpu", "tpu", "current_context",
           "num_devices", "resolve_device", "autograd", "base", "context",
           "gluon", "init", "initializer", "kv", "kvstore", "nd", "ndarray",
           "ops", "optimizer", "parallel", "serving"]
