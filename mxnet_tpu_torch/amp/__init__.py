"""mxnet_tpu_torch.amp — automatic mixed precision.

PyTorch counterpart of ``mxnet_tpu/amp`` (MXNet's ``contrib.amp``;
Micikevicius et al., 2018).  Three pieces:

1. **Casting policy.** :func:`convert_symbol` rewrites a symbolic graph so
   that the matmul and convolution family runs in bf16/fp16 (cuBLAS and
   cuDNN on the tensor cores) while softmax, norms and losses stay f32,
   with the minimal set of casts; :func:`init` applies the same policy to
   a Gluon block tree by casting parameters and wrapping forwards.
2. **Loss scaling.** :class:`LossScaler` rides ``Executor.fused_step``:
   scaled head cotangent, unscaled gradients, the finite check (summed
   over the mesh on the SPMD route, so every rank skips the same steps),
   the skipped update and the scale update.
3. **Master weights.** ``multi_precision`` optimizers keep an f32 master
   of each low-precision weight and recast the weight from it every
   step, on the fused step as on the legacy one.

``Module`` reads the environment at ``bind`` (``TPUMX_AMP=1``,
``TPUMX_AMP_DTYPE``, ``TPUMX_AMP_LOSS_SCALE``, :func:`active_config`);
the functions here are the explicit API.
"""
from __future__ import annotations

import os
from typing import Optional

import torch

from ..base import MXNetError
from .convert import (_canonical, convert_symbol, count_amp_casts,
                      remove_amp_cast)
from .lists import (FP32_OPS, TARGET_DTYPE_OPS, _GLUON_FP32_BLOCKS,
                    _GLUON_TARGET_BLOCKS)
from .loss_scaler import LossScaler

__all__ = ["convert_symbol", "remove_amp_cast", "count_amp_casts",
           "LossScaler", "AmpConfig", "enabled", "target_dtype",
           "active_config", "make_loss_scaler", "init"]


def enabled() -> bool:
    """Whether AMP is on for ``Module`` (``TPUMX_AMP=1``; default off)."""
    return os.environ.get("TPUMX_AMP", "0") == "1"


def target_dtype() -> str:
    """The compute dtype (``TPUMX_AMP_DTYPE``, default bfloat16; float16
    wants loss scaling)."""
    return _canonical(os.environ.get("TPUMX_AMP_DTYPE", "bfloat16"))


class AmpConfig:
    """The AMP settings of one ``Module`` bind: the compute dtype and the
    loss-scale policy (``"dynamic"``, a static float, or None)."""

    def __init__(self, dtype: str, loss_scale):
        self.dtype = dtype
        self.loss_scale = loss_scale

    def __repr__(self):
        return f"AmpConfig(dtype={self.dtype!r}, loss_scale={self.loss_scale!r})"


def active_config() -> Optional[AmpConfig]:
    """The configuration the environment gives, or None with AMP off.

    ``TPUMX_AMP_LOSS_SCALE``: unset gives ``dynamic`` for float16 and no
    scaling for bfloat16 (bf16 has f32's exponent range); ``dynamic``; a
    float for a static scale; ``0``/``none``/``off``/``false`` for none.
    Anything else raises ``MXNetError``."""
    if not enabled():
        return None
    dtype = target_dtype()
    raw = os.environ.get("TPUMX_AMP_LOSS_SCALE", "").strip().lower()
    if raw == "":
        loss_scale = "dynamic" if dtype == "float16" else None
    elif raw in ("0", "none", "off", "false"):
        loss_scale = None
    elif raw == "dynamic":
        loss_scale = "dynamic"
    else:
        try:
            loss_scale = float(raw)
        except ValueError:
            raise MXNetError(
                f"TPUMX_AMP_LOSS_SCALE={raw!r}: expected 'dynamic', a float, "
                "or 'none'") from None
        if loss_scale <= 0:
            loss_scale = None
    return AmpConfig(dtype, loss_scale)


def make_loss_scaler(cfg: Optional[AmpConfig]) -> Optional[LossScaler]:
    """The :class:`LossScaler` of the config's policy (None without
    scaling)."""
    if cfg is None or cfg.loss_scale is None:
        return None
    if cfg.loss_scale == "dynamic":
        return LossScaler(dynamic=True)
    return LossScaler(init_scale=float(cfg.loss_scale), dynamic=False)


# -- Gluon ---------------------------------------------------------------------
def _wrap_forward_cast(block, dtype: str) -> None:
    """An instance-level ``forward`` that casts floating tensor inputs to
    ``dtype`` first (a block's ``__call__`` finds the instance attribute
    before the class's method, so the caller's tensors stay as they
    are).  Symbols pass through: an exported graph gets no casts."""
    from ..base import torch_dtype

    target = torch_dtype(dtype)
    orig = block.forward

    def forward(*args, **kwargs):
        args = tuple(a.to(target) if isinstance(a, torch.Tensor)
                     and a.is_floating_point() and a.dtype != target else a
                     for a in args)
        return orig(*args, **kwargs)

    block.forward = forward
    block._amp_dtype = _canonical(dtype)


def init(block, target_dtype: str = "bfloat16"):
    """Apply the AMP policy to a Gluon block tree, in place, and return
    it.  Leaf blocks on the low-precision list (``Dense``, ``Conv*``) get
    their parameters cast to ``target_dtype`` and an input cast; blocks
    on the f32 list (``BatchNorm``, ``LayerNorm``, ``InstanceNorm``) keep
    f32 parameters and cast their input to f32.  Everything else runs in
    the dtype its inputs arrive in.  Train with ``multi_precision=True``
    (f32 master weights)."""
    dtype = _canonical(target_dtype)
    if dtype not in ("bfloat16", "float16"):
        raise MXNetError(
            f"amp.init: target_dtype must be bfloat16 or float16, "
            f"got {target_dtype!r}")

    def visit(b):
        cls = type(b).__name__
        if getattr(b, "_amp_dtype", None) is not None:
            return
        if cls in _GLUON_TARGET_BLOCKS:
            for p in b._reg_params.values():
                if p is not None:
                    p.cast(dtype)
            _wrap_forward_cast(b, dtype)
        elif cls in _GLUON_FP32_BLOCKS:
            _wrap_forward_cast(b, "float32")
        if hasattr(b, "_clear_cache"):
            b._clear_cache()

    block.apply(visit)
    return block
