"""Data-parallel training on one device, and pure functions of a Gluon
block's parameters.

PyTorch counterpart of ``mxnet_tpu/parallel/data_parallel.py``:

- ``block_train_fn`` and ``block_apply_fn``: ``fn(params, aux, x) ->
  (out, new_aux)`` over ``{parameter name: tensor}`` dicts, through
  ``torch.func.functional_call`` (the block's own tensors are never
  touched).  ``params`` are the differentiable leaves, ``aux`` the
  ``grad_req == "null"`` state (BatchNorm running statistics, frozen
  parameters); the state writes layers make in the forward come back as
  ``new_aux``, so the caller threads aux through its steps as the
  reference does.
- ``DataParallelTrainer`` without a mesh: the reference's fused step
  (forward, backward, SGD with momentum and weight decay, or a user
  ``update_fn``) and its 2-bit compressed variant, which quantizes and
  dequantizes every float32 gradient against an error-feedback residual
  (``GradientCompression``, the CUDA pack and unpack kernels on the card)
  before the update.  Meshes come with the distributed slice.
"""
from __future__ import annotations

from typing import Callable, Dict, Optional

import numpy as np
import torch

from .. import autograd
from ..base import MXNetError
from ..gluon.block import Block
from ..gluon.parameter import capture_writes
from .compression import GradientCompression

__all__ = ["DataParallelTrainer", "block_apply_fn", "block_train_fn"]


def _tensor_paths(block: Block, pd) -> Dict[str, str]:
    """Each parameter name -> the dotted path of its tensor in ``block``
    (the first block of the tree that holds it)."""
    mods = {id(m): p for p, m in block.named_modules(remove_duplicate=False)}
    paths = {}
    for name, p in pd.items():
        for owner, attr in p._owners:
            if id(owner) in mods:
                paths[name] = f"{mods[id(owner)]}.{attr}" \
                    if mods[id(owner)] else attr
                break
        else:
            raise MXNetError(f"parameter {name} is held by no block of "
                             f"{block.name}")
    return paths


def block_train_fn(block: Block, is_train: bool = True):
    """``(fn, init_params, init_aux)``: ``fn(params, aux, x) -> (out,
    new_aux)`` runs ``block`` on ``x`` with the given tensors in
    ``autograd`` training mode ``is_train``; ``init_params`` and
    ``init_aux`` are the block's current tensors, detached."""
    pd = block.collect_params()
    param_names = [n for n in pd if pd[n].grad_req != "null"]
    aux_names = [n for n in pd if pd[n].grad_req == "null"]
    try:
        init_params = {n: pd[n]._tensor().detach() for n in param_names}
        init_aux = {n: pd[n]._tensor().detach() for n in aux_names}
    except MXNetError as e:
        raise RuntimeError(
            "block has uninitialized (deferred-shape) parameters; run one "
            "forward pass or construct layers with in_units/in_channels "
            "first") from e
    paths = _tensor_paths(block, pd)

    def apply_fn(params: Dict[str, torch.Tensor],
                 aux: Dict[str, torch.Tensor], x):
        tensors = {paths[n]: params[n] for n in param_names}
        tensors.update({paths[n]: aux[n] for n in aux_names})
        with capture_writes() as cap, autograd.pause(train_mode=is_train):
            out = torch.func.functional_call(block, tensors, (x,))
        return out, {n: cap.writes.get(n, aux[n]) for n in aux_names}

    return apply_fn, init_params, init_aux


def block_apply_fn(block: Block, is_train: bool = True):
    """``(fn, params)``: ``fn(params, x) -> out`` over every parameter
    (aux included); the state writes of the forward are dropped.  For
    training use :func:`block_train_fn`, which returns them."""
    train_fn, init_params, init_aux = block_train_fn(block, is_train)
    aux_names = set(init_aux)

    def apply_fn(params: Dict[str, torch.Tensor], x):
        out, _ = train_fn({k: v for k, v in params.items()
                           if k not in aux_names},
                          {k: params[k] for k in aux_names}, x)
        return out

    return apply_fn, {**init_params, **init_aux}


class DataParallelTrainer:
    """One fused train step per call (reference: ``DataParallelTrainer``),
    on the block's own device.

    ``loss_fn(pred, y)`` returns a per-sample loss; a Gluon ``Loss`` block
    goes in as it is and runs under ``autograd.pause(train_mode=True)``.
    The step's loss is the f32 mean of it.  ``compute_dtype`` casts the
    parameters and ``x`` inside the loss (the aux state is not cast); the
    gradients, momenta and update stay in the parameters' dtype.  The
    optimizer is SGD, ``m = momentum * m + g`` and ``p = p * (1 - lr *
    weight_decay) - lr * m``, unless ``update_fn(params, momenta, grads) ->
    (params, momenta)`` replaces it.

    ``compression_params`` (``{"type": "2bit", "threshold": t}``, with
    ``GradientCompression``'s keywords) quantizes and dequantizes every
    gradient, in f32, against its residual in ``residuals[name][0]`` before
    the update, so only ``+-t`` or 0 reaches the optimizer and the rest is
    carried to the next step.  ``residuals`` has a leading device axis of
    1, as the reference's mesh-less trainer has.

    ``dp_axis`` and ``donate`` are accepted for the reference's
    signature.  There ``donate`` lets XLA reuse the step's input buffers;
    here every step returns new tensors (``params``, ``momenta``,
    ``aux``, ``residuals``), so no buffer is reused and none of the
    block's is ever written: :meth:`write_back` copies the trained values
    into the block.

    ``mesh`` must be ``None``: meshes are not ported yet.
    """

    def __init__(self, block: Block, loss_fn: Callable, lr: float = 0.1,
                 momentum: float = 0.9, weight_decay: float = 0.0,
                 mesh=None, dp_axis: str = "dp", compute_dtype=None,
                 update_fn: Optional[Callable] = None, donate: bool = True,
                 compression_params: Optional[Dict] = None):
        if mesh is not None:
            raise MXNetError(
                "DataParallelTrainer: a mesh is not ported yet (ROADMAP.md, "
                "Queue 1, item 5: multi-process distributed); pass "
                "mesh=None")
        self._block = block
        if isinstance(loss_fn, Block):
            _loss_block = loss_fn

            def loss_fn(pred, y):  # noqa: F811
                with autograd.pause(train_mode=True):
                    return _loss_block(pred, y)

        self._loss_fn = loss_fn
        self._lr = lr
        self._momentum = momentum
        self._wd = weight_decay
        self._compute_dtype = compute_dtype
        self._update_fn = update_fn
        self._apply_fn, self.params, self.aux = block_train_fn(
            block, is_train=True)
        self.momenta = {k: torch.zeros_like(v)
                        for k, v in self.params.items()}
        self._compression = None
        self.residuals = None
        if compression_params is not None:
            self._compression = GradientCompression(**compression_params)
            if self._compression.type == "none":
                self._compression = None
        if self._compression is not None:
            self.residuals = {
                k: torch.zeros((1,) + tuple(v.shape), dtype=torch.float32,
                               device=v.device)
                for k, v in self.params.items()}
        first = next(iter({**self.params, **self.aux}.values()), None)
        self._device = first.device if first is not None \
            else torch.device("cpu")

    def _input(self, a):
        """A numpy array or tensor on the block's device; float64 numpy
        input becomes float32, as the reference's default dtype is."""
        if isinstance(a, np.ndarray) and a.dtype == np.float64:
            a = a.astype(np.float32)
        return torch.as_tensor(a, device=self._device)

    def _loss_and_grads(self, x, y):
        """The mean f32 loss, the gradient of every parameter and the new
        aux state, at the current parameters."""
        cdt = self._compute_dtype
        leaves = {k: v.detach().requires_grad_()
                  for k, v in self.params.items()}
        with torch.enable_grad():
            p = leaves if cdt is None else {k: v.to(cdt)
                                            for k, v in leaves.items()}
            pred, new_aux = self._apply_fn(p, self.aux,
                                           x if cdt is None else x.to(cdt))
            loss = self._loss_fn(pred, y).float().mean()
            grads = torch.autograd.grad(loss, list(leaves.values()),
                                        allow_unused=True)
        grads = {k: torch.zeros_like(v) if g is None else g
                 for (k, v), g in zip(leaves.items(), grads)}
        return loss.detach(), grads, {k: v.detach()
                                      for k, v in new_aux.items()}

    def _apply_update(self, params, momenta, grads):
        if self._update_fn is not None:
            return self._update_fn(params, momenta, grads)
        lr, mom, wd = self._lr, self._momentum, self._wd
        new_momenta = {k: mom * momenta[k] + grads[k] for k in momenta}
        new_params = {k: p * (1.0 - lr * wd)
                      - lr * new_momenta[k].to(p.dtype)
                      for k, p in params.items()}
        return new_params, new_momenta

    def _compress(self, grads):
        """Each gradient through the 2-bit round trip against its
        residual: (dequantized gradients, new residuals)."""
        gc = self._compression
        dq, new_res = {}, {}
        for k, g in grads.items():
            d, r = gc.quantize_dequantize(g.float().contiguous(),
                                          self.residuals[k][0])
            dq[k] = d
            new_res[k] = r[None]
        return dq, new_res

    def step(self, x, y, rng=None):
        """One train step on ``(x, y)`` (numpy arrays or tensors, moved to
        the block's device); returns the mean loss, an f32 0-d tensor.
        ``rng`` is accepted for the reference's signature: nothing in the
        step draws random numbers."""
        x, y = self._input(x), self._input(y)
        loss, grads, new_aux = self._loss_and_grads(x, y)
        with torch.no_grad():
            if self._compression is not None:
                grads, self.residuals = self._compress(grads)
            self.params, self.momenta = self._apply_update(
                self.params, self.momenta, grads)
        self.aux = new_aux
        return loss

    def write_back(self):
        """Copy the trained params and aux state into the block's
        ``Parameter``s."""
        pd = self._block.collect_params()
        for name, v in {**self.params, **self.aux}.items():
            pd[name].set_data(v)
