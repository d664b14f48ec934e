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
and parameter files; and the symbolic path: ``Symbol`` (graph JSON byte
for byte the reference's), the ``Executor``, ``Module.fit`` with its
metrics, callbacks, data iterators, learning-rate schedulers and
checkpoint files; sequence models: the fused ``RNN`` op, ``mx.rnn``
cells with ``BucketSentenceIter``, ``BucketingModule``,
``SequentialModule``, ``Monitor`` and ``gluon.rnn``; and the RecordIO
image feed (``recordio``, ``io.ImageRecordIter``); and training over
several processes: named meshes over ``torch.distributed`` (NCCL on the
cards, gloo on the CPU) with differentiable collectives, the mesh
``DataParallelTrainer``, ring and Ulysses sequence parallelism in the
dp x sp LM step, and the ``dist_sync``/``dist_async`` parameter server
(``kvstore_dist``, ``kvstore_server``); and automatic mixed precision
(``amp``: the graph casting policy, loss scaling in the fused step,
Gluon ``amp.init``); fault-tolerant ``Module.fit`` (``checkpoint``:
async checksummed checkpoints, resume, preemption), device-side train
telemetry and the micro-batching ``serving.InferenceService``; int8
quantization (``quantization``: calibration, graph conversion, int8
serving; ``contrib.quantization``, the reference's QuantizeGraph pass),
every optimizer of the reference, and user ops in Python
(``operator``: ``nd.Custom``/``sym.Custom``); sparse storage
(``nd.sparse`` row-sparse and csr arrays, ``io.LibSVMIter``, csr
arguments of the executor, the row-sparse kvstore) and control flow
(``sym.contrib``/``nd.contrib`` ``foreach``, ``while_loop``, ``cond``);
images and detection (``image``: ``ImageIter``, the augmenters,
``ImageDetIter``; ``nd.image``, ``gluon.data.vision``; the SSD, RPN, ROI,
spatial-transform and CTC ops, ``gluon.loss.CTCLoss``).  Entry points run on ``cuda`` (``mx.gpu()``, the default
context) unless the caller passes the CPU (``ctx=mx.cpu()``,
``context=mx.cpu()`` or ``device="cpu"``).
"""
from . import (attribute, autograd, base, callback, checkpoint, context, engine,
               executor, executor_manager, fault, gluon, initializer, io, kvstore,
               lr_scheduler, metric, model, module, monitor, name, ndarray,
               observability, ops, optimizer, parallel, profiler, random,
               recordio, rnn, serving, symbol)
from . import initializer as init
from . import kvstore as kv
from . import module as mod
from . import ndarray as nd
from . import symbol as sym
from .model import load_checkpoint, save_checkpoint
from .module import Module
from .symbol import Symbol
from .attribute import AttrScope
from .base import MXNetError
from .context import (Context, cpu, current_context, gpu, num_devices,
                      resolve_device, tpu)
from . import kvstore_server
from . import amp
from . import contrib, operator, quantization
from . import image

random._install_samplers()

__version__ = "0.1.0"

__all__ = ["MXNetError", "amp", "contrib", "image", "operator", "quantization",
           "Context", "cpu", "gpu", "tpu", "current_context",
           "num_devices", "resolve_device", "attribute", "autograd", "base",
           "callback", "checkpoint", "context", "engine", "executor", "fault", "gluon",
           "init", "initializer", "kvstore_server", "observability",
           "profiler",
           "io", "kv", "kvstore", "lr_scheduler", "metric", "mod", "model",
           "module", "Module", "monitor", "name", "nd", "ndarray", "ops",
           "optimizer", "parallel", "random", "recordio", "rnn", "serving",
           "sym", "symbol", "Symbol",
           "save_checkpoint", "load_checkpoint"]
