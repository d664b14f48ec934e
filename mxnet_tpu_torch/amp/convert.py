"""The graph casting policy: ``convert_symbol``, ``remove_amp_cast``,
``count_amp_casts``.

PyTorch counterpart of ``mxnet_tpu/amp/convert.py`` (reference: MXNet's
``contrib/amp/amp.py convert_symbol``).  A static dtype tag propagates
through the DAG (``"f32"``, the target, or unknown), so only the minimal
set of ``amp_cast`` nodes is inserted: a chain of convolutions pays one
cast in, a pure-f32 region none.  Parameters stay f32 variables; the cast
into bf16/fp16 happens in the graph, under autograd, so their gradients
come back f32.  The walk is :func:`mxnet_tpu_torch.symbol.rewrite.
rewrite_graph`; this module supplies the policy: the op lists, the
``amp_cast`` node, and ``out_grad=True`` on the loss heads so that the
loss-scaled cotangent reaches the gradients.
"""
from __future__ import annotations

from typing import Optional, Sequence

from ..base import MXNetError, dtype_name
from .lists import FP32_OPS, TARGET_DTYPE_OPS

__all__ = ["convert_symbol", "remove_amp_cast", "count_amp_casts"]

_LOW_DTYPES = ("bfloat16", "float16")

# loss heads whose backward ignores the incoming cotangent unless
# out_grad: a converted graph sets it, so the scaled seed propagates
# (with the executor's ones seed the multiply changes nothing)
_HEAD_OUT_GRAD_OPS = ("SoftmaxOutput", "LinearRegressionOutput",
                      "MAERegressionOutput", "LogisticRegressionOutput")


def _canonical(dtype) -> str:
    try:
        return dtype_name(dtype)
    except (MXNetError, KeyError):
        return str(dtype)


def convert_symbol(symbol, target_dtype: str = "bfloat16",
                   target_dtype_ops: Optional[Sequence[str]] = None,
                   fp32_ops: Optional[Sequence[str]] = None):
    """A new Symbol computing the same function with AMP casts inserted
    (the input symbol is left untouched).  Argument and aux names are
    unchanged (only ``amp_cast<n>`` op nodes are added), so binding and
    checkpoints work as before; :func:`remove_amp_cast` gives the
    original graph back."""
    from ..ops.registry import get_op
    from ..symbol.graph import Node
    from ..symbol.rewrite import PROPAGATE, rewrite_graph

    target = _canonical(target_dtype)
    if target not in _LOW_DTYPES:
        raise MXNetError(
            f"amp.convert_symbol: target_dtype must be one of {_LOW_DTYPES}, "
            f"got {target_dtype!r}")
    tset = frozenset(target_dtype_ops if target_dtype_ops is not None
                     else TARGET_DTYPE_OPS)
    fset = frozenset(fp32_ops if fp32_ops is not None else FP32_OPS)
    cast_op = get_op("amp_cast")

    def make_cast(entry, dtype, ordinal):
        node = Node("op", f"amp_cast{ordinal}", op=cast_op,
                    attrs={"dtype": dtype}, inputs=[entry])
        return node, ("f32" if dtype == "float32" else dtype)

    def visit(node, inputs, ctx):
        opname = node.op.name
        if opname in tset:
            inputs = [e if ctx.tag_of(e) == target
                      else ctx.convert(e, target) for e in inputs]
            out_tag = target
        elif opname in fset:
            # BatchNorm's aux inputs are never cast: the executor commits
            # the running statistics by the aux variables' names, and
            # they are f32 anyway
            inputs = [e if (ctx.tag_of(e) == "f32"
                            or e.node.attr_dict.get("__is_aux__"))
                      else ctx.convert(e, "float32") for e in inputs]
            out_tag = "f32"
        else:
            out_tag = PROPAGATE
        attrs = dict(node.attrs)
        if opname in _HEAD_OUT_GRAD_OPS and "out_grad" not in attrs:
            attrs["out_grad"] = True
        return inputs, attrs, out_tag

    # variables are tagged f32: simple_bind makes them f32 unless the
    # caller's type_dict says otherwise, and a low-precision variable
    # costs at worst one identity cast
    return rewrite_graph(symbol, visit, make_conversion=make_cast,
                         default_tag="f32")


def remove_amp_cast(symbol):
    """Every ``amp_cast`` node stripped: the original-precision graph
    (``save_checkpoint``'s and ``export``'s default, so a checkpoint of a
    converted model loads anywhere)."""
    from ..symbol.rewrite import strip_ops

    return strip_ops(symbol, ("amp_cast",))


def count_amp_casts(symbol) -> int:
    """The number of ``amp_cast`` nodes in a symbol."""
    from ..symbol.graph import topo_order

    return sum(1 for n in topo_order(symbol._entries)
               if n.kind == "op" and n.op.name == "amp_cast")
