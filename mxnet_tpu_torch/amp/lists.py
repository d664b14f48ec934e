"""AMP op and block casting lists (reference: ``mxnet_tpu/amp/lists.py``,
copied; MXNet's ``contrib.amp`` FP16_FUNCS / FP32_FUNCS split).

- ``TARGET_DTYPE_OPS``: the matmul and convolution family (tensor cores
  on the H100: cuBLAS and cuDNN underneath).  Their float inputs are cast
  to the target dtype.
- ``FP32_OPS``: softmax, losses, norms, wide reductions, exp/log.  A
  low-precision value reaching them is cast back to f32.
- Everything else propagates the dtype its inputs arrive in.

``_GLUON_TARGET_BLOCKS`` / ``_GLUON_FP32_BLOCKS`` are the Gluon analogue
for :func:`mxnet_tpu_torch.amp.init`, by Block class name.
"""

TARGET_DTYPE_OPS = (
    "FullyConnected",
    "Convolution",
    "Deconvolution",
    "RNN",
    "dot",
    "batch_dot",
)

FP32_OPS = (
    "softmax",
    "log_softmax",
    "softmin",
    "SoftmaxActivation",
    "SoftmaxOutput",
    "softmax_cross_entropy",
    "BatchNorm",
    "LayerNorm",
    "InstanceNorm",
    "L2Normalization",
    "LRN",
    "norm",
    "sum",
    "mean",
    "prod",
    "exp",
    "log",
    "smooth_l1",
    "LinearRegressionOutput",
    "MAERegressionOutput",
    "LogisticRegressionOutput",
    "MakeLoss",
)

# Gluon block class names for amp.init (leaf blocks only)
_GLUON_TARGET_BLOCKS = (
    "Dense",
    "Conv1D", "Conv2D", "Conv3D",
    "Conv1DTranspose", "Conv2DTranspose", "Conv3DTranspose",
)

_GLUON_FP32_BLOCKS = (
    "BatchNorm",
    "LayerNorm",
    "InstanceNorm",
)
