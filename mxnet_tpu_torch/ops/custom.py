"""The graph op ``Custom`` (reference: NNVM op 'Custom',
src/operator/custom/custom.cc): a :class:`~mxnet_tpu_torch.operator.
CustomOpProp` registered under ``op_type`` (``mx.operator.register``),
looked up at each call, runs the user's ``forward`` on NDArrays, and its
gradient is a ``torch.autograd.Function`` whose backward calls the user's
``backward``.  The shape solver's meta tensors take the prop's shapes and
run no body; a call on a real device notes a host sync, so a hybridized
program that runs one is not captured as a CUDA graph
(``gluon.cached_op.note_host_sync``)."""
from __future__ import annotations

import torch

from .. import autograd
from ..base import MXNetError, np_dtype, torch_dtype
from .registry import register


def _prop_of(attrs: dict):
    from ..operator import _CUSTOM_REGISTRY

    op_type = attrs.get("op_type")
    if op_type not in _CUSTOM_REGISTRY:
        raise MXNetError(
            f"custom op {op_type!r} not registered; known: "
            f"{sorted(_CUSTOM_REGISTRY)}")
    return _CUSTOM_REGISTRY[op_type](
        **{k: v for k, v in attrs.items() if k not in ("op_type", "_training")})


def _np_dtypes(tensors):
    return [np_dtype(t.dtype) for t in tensors]


def _out_specs(prop, in_shapes, in_dtypes):
    """[(shape, torch dtype)] of the outputs, from the prop's
    ``infer_shape`` and ``infer_type``."""
    _, out_shapes, _ = prop.infer_shape([list(s) for s in in_shapes])
    _, out_types, _ = prop.infer_type(list(in_dtypes))
    return [(tuple(int(d) for d in s), torch_dtype(t))
            for s, t in zip(out_shapes, out_types)]


class _CustomFunction(torch.autograd.Function):
    """The user's ``forward`` as a Function whose backward is the user's
    ``backward``."""

    @staticmethod
    def forward(ctx, op, is_train, specs, device, *inputs):
        from ..ndarray.ndarray import NDArray

        ins = [NDArray(t.detach()) for t in inputs]
        outs = [NDArray(torch.zeros(s, dtype=dt, device=device))
                for s, dt in specs]
        with autograd.pause(train_mode=is_train):
            op.forward(is_train=is_train, req=["write"] * len(outs),
                       in_data=ins, out_data=outs, aux=[])
        results = [o._data.to(device) for o in outs]
        ctx.op = op
        ctx.n_in = len(inputs)
        ctx.save_for_backward(*inputs, *results)
        return tuple(results)

    @staticmethod
    def backward(ctx, *gouts):
        from ..ndarray.ndarray import NDArray

        saved = ctx.saved_tensors
        ins = [NDArray(t.detach()) for t in saved[:ctx.n_in]]
        outs = [NDArray(t.detach()) for t in saved[ctx.n_in:]]
        ograds = [NDArray(torch.zeros_like(o._data) if g is None else g)
                  for o, g in zip(outs, gouts)]
        igrads = [NDArray(torch.zeros_like(i._data)) for i in ins]
        with autograd.pause():
            ctx.op.backward(req=["write"] * len(ins), out_grad=ograds,
                            in_data=ins, out_data=outs, in_grad=igrads,
                            aux=[])
        grads = [g._data.to(device=i._data.device, dtype=i._data.dtype)
                 if i._data.is_floating_point() else None
                 for g, i in zip(igrads, ins)]
        return (None, None, None, None) + tuple(grads)


def _n_outputs(attrs: dict) -> int:
    return len(_prop_of(attrs).list_outputs())


@register("Custom", num_outputs=_n_outputs)
def custom(*arrays, op_type=None, _training=False, **kwargs):
    """A registered :class:`CustomOpProp`'s op (``op_type``) on the
    inputs; its other attributes go to the prop's constructor."""
    from ..context import current_context, resolve_device
    from ..gluon import cached_op

    prop = _prop_of(dict(kwargs, op_type=op_type))
    specs = _out_specs(prop, [tuple(a.shape) for a in arrays],
                       _np_dtypes(arrays))
    device = arrays[0].device if arrays else \
        resolve_device(current_context())
    if device.type == "meta":
        # the shape solver: the prop's shapes, no body
        outs = tuple(torch.empty(s, dtype=dt, device=device)
                     for s, dt in specs)
        return outs if len(outs) > 1 else outs[0]
    cached_op.note_host_sync("Custom")
    op = prop.create_operator(None, [list(a.shape) for a in arrays],
                              _np_dtypes(arrays))
    outs = _CustomFunction.apply(op, bool(_training), specs, device,
                                 *arrays)
    return outs if len(outs) > 1 else outs[0]
