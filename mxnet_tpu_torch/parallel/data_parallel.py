"""Pure functions of a Gluon block's parameters.

PyTorch counterpart of ``block_train_fn`` and ``block_apply_fn`` of
``mxnet_tpu/parallel/data_parallel.py``: ``fn(params, aux, x) -> (out,
new_aux)`` over ``{parameter name: tensor}`` dicts, through
``torch.func.functional_call`` (the block's own tensors are never
touched).  ``params`` are the differentiable leaves, ``aux`` the
``grad_req == "null"`` state (BatchNorm running statistics, frozen
parameters); the state writes layers make in the forward come back as
``new_aux``, so the caller threads aux through its steps as the reference
does.  ``DataParallelTrainer`` and meshes come with the distributed
slice.
"""
from __future__ import annotations

from typing import Dict

import torch

from .. import autograd
from ..base import MXNetError
from ..gluon.block import Block
from ..gluon.parameter import capture_writes

__all__ = ["block_apply_fn", "block_train_fn"]


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
        init_params = {n: pd[n].data().detach() for n in param_names}
        init_aux = {n: pd[n].data().detach() for n in aux_names}
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
