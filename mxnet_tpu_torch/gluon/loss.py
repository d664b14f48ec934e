"""Gluon losses.

PyTorch counterpart of ``mxnet_tpu/gluon/loss.py`` (reference:
python/mxnet/gluon/loss.py): the same classes, constructor arguments,
``weight`` / ``sample_weight`` handling and per-sample ``_batch_mean``.
Each loss is a ``HybridBlock`` whose ``hybrid_forward`` calls the op
namespace ``F`` by the reference's op names: called with ``NDArray``s
(the imperative loop) a loss returns an NDArray, called with
``torch.Tensor``s a tensor.  ``CTCLoss`` needs the
``CTCLoss`` op, which is not ported yet: constructing it raises.
"""
from __future__ import annotations

from ..base import MXNetError
from .block import HybridBlock

__all__ = ["Loss", "L2Loss", "L1Loss", "SigmoidBinaryCrossEntropyLoss",
           "SigmoidBCELoss", "SoftmaxCrossEntropyLoss", "SoftmaxCELoss",
           "KLDivLoss", "CTCLoss", "HuberLoss", "HingeLoss",
           "SquaredHingeLoss", "LogisticLoss", "TripletLoss",
           "CosineEmbeddingLoss"]


def _apply_weighting(F, loss, weight=None, sample_weight=None):
    if sample_weight is not None:
        loss = F.broadcast_mul(loss, sample_weight)
    if weight is not None:
        loss = loss * weight
    return loss


def _reshape_like(F, x, y):
    return F.reshape_like(x, y)


class Loss(HybridBlock):
    def __init__(self, weight, batch_axis, **kwargs):
        super().__init__(**kwargs)
        self._weight = weight
        self._batch_axis = batch_axis

    def __repr__(self):
        return (f"{self.__class__.__name__}(batch_axis={self._batch_axis}, "
                f"w={self._weight})")

    def hybrid_forward(self, F, x, *args, **kwargs):
        raise NotImplementedError


def _batch_mean(F, loss, batch_axis):
    axes = [a for a in range(loss.ndim) if a != batch_axis]
    if axes:
        return F.mean(loss, axis=tuple(axes))
    return loss


class L2Loss(Loss):
    def __init__(self, weight=1.0, batch_axis=0, **kwargs):
        super().__init__(weight, batch_axis, **kwargs)

    def hybrid_forward(self, F, pred, label, sample_weight=None):
        label = _reshape_like(F, label, pred)
        loss = F.square(label - pred)
        loss = _apply_weighting(F, loss, self._weight / 2, sample_weight)
        return _batch_mean(F, loss, self._batch_axis)


class L1Loss(Loss):
    def __init__(self, weight=None, batch_axis=0, **kwargs):
        super().__init__(weight, batch_axis, **kwargs)

    def hybrid_forward(self, F, pred, label, sample_weight=None):
        label = _reshape_like(F, label, pred)
        loss = F.abs(label - pred)
        loss = _apply_weighting(F, loss, self._weight, sample_weight)
        return _batch_mean(F, loss, self._batch_axis)


class SigmoidBinaryCrossEntropyLoss(Loss):
    def __init__(self, from_sigmoid=False, weight=None, batch_axis=0,
                 **kwargs):
        super().__init__(weight, batch_axis, **kwargs)
        self._from_sigmoid = from_sigmoid

    def hybrid_forward(self, F, pred, label, sample_weight=None,
                       pos_weight=None):
        label = _reshape_like(F, label, pred)
        if not self._from_sigmoid:
            # numerically stable: max(x,0) - x*z + log(1+exp(-|x|))
            loss = F.relu(pred) - pred * label + \
                F.Activation(-F.abs(pred), act_type="softrelu")
            if pos_weight is not None:
                loss = loss + (pos_weight - 1) * label * (
                    F.Activation(-F.abs(pred), act_type="softrelu")
                    + F.relu(-pred))
        else:
            eps = 1e-12
            if pos_weight is None:
                loss = -(F.log(pred + eps) * label
                         + F.log(1. - pred + eps) * (1. - label))
            else:
                loss = -(F.log(pred + eps) * label * pos_weight
                         + F.log(1. - pred + eps) * (1. - label))
        loss = _apply_weighting(F, loss, self._weight, sample_weight)
        return _batch_mean(F, loss, self._batch_axis)


SigmoidBCELoss = SigmoidBinaryCrossEntropyLoss


class SoftmaxCrossEntropyLoss(Loss):
    def __init__(self, axis=-1, sparse_label=True, from_logits=False,
                 weight=None, batch_axis=0, **kwargs):
        super().__init__(weight, batch_axis, **kwargs)
        self._axis = axis
        self._sparse_label = sparse_label
        self._from_logits = from_logits

    def hybrid_forward(self, F, pred, label, sample_weight=None):
        if not self._from_logits:
            pred = F.log_softmax(pred, axis=self._axis)
        if self._sparse_label:
            loss = -F.pick(pred, label, axis=self._axis, keepdims=True)
        else:
            label = _reshape_like(F, label, pred)
            loss = -F.sum(pred * label, axis=self._axis, keepdims=True)
        loss = _apply_weighting(F, loss, self._weight, sample_weight)
        return _batch_mean(F, loss, self._batch_axis)


SoftmaxCELoss = SoftmaxCrossEntropyLoss


class KLDivLoss(Loss):
    def __init__(self, from_logits=True, axis=-1, weight=None, batch_axis=0,
                 **kwargs):
        super().__init__(weight, batch_axis, **kwargs)
        self._from_logits = from_logits
        self._axis = axis

    def hybrid_forward(self, F, pred, label, sample_weight=None):
        if not self._from_logits:
            pred = F.log_softmax(pred, axis=self._axis)
        loss = label * (F.log(label + 1e-12) - pred)
        loss = _apply_weighting(F, loss, self._weight, sample_weight)
        return _batch_mean(F, loss, self._batch_axis)


class CTCLoss(Loss):
    """Not ported yet: it needs the ``CTCLoss`` op (ROADMAP.md, Queue 1,
    item 6, with the rest of ``rnn``)."""

    def __init__(self, layout="NTC", label_layout="NT", weight=None,
                 **kwargs):
        raise MXNetError("CTCLoss is not ported yet: it needs the CTCLoss "
                         "op (ROADMAP.md, Queue 1, item 6)")


class HuberLoss(Loss):
    def __init__(self, rho=1, weight=None, batch_axis=0, **kwargs):
        super().__init__(weight, batch_axis, **kwargs)
        self._rho = rho

    def hybrid_forward(self, F, pred, label, sample_weight=None):
        label = _reshape_like(F, label, pred)
        loss = F.abs(label - pred)
        loss = F.where(loss > self._rho,
                       loss - 0.5 * self._rho,
                       (0.5 / self._rho) * F.square(loss))
        loss = _apply_weighting(F, loss, self._weight, sample_weight)
        return _batch_mean(F, loss, self._batch_axis)


class HingeLoss(Loss):
    def __init__(self, margin=1, weight=None, batch_axis=0, **kwargs):
        super().__init__(weight, batch_axis, **kwargs)
        self._margin = margin

    def hybrid_forward(self, F, pred, label, sample_weight=None):
        label = _reshape_like(F, label, pred)
        loss = F.relu(self._margin - pred * label)
        loss = _apply_weighting(F, loss, self._weight, sample_weight)
        return _batch_mean(F, loss, self._batch_axis)


class SquaredHingeLoss(Loss):
    def __init__(self, margin=1, weight=None, batch_axis=0, **kwargs):
        super().__init__(weight, batch_axis, **kwargs)
        self._margin = margin

    def hybrid_forward(self, F, pred, label, sample_weight=None):
        label = _reshape_like(F, label, pred)
        loss = F.square(F.relu(self._margin - pred * label))
        loss = _apply_weighting(F, loss, self._weight, sample_weight)
        return _batch_mean(F, loss, self._batch_axis)


class LogisticLoss(Loss):
    def __init__(self, weight=None, batch_axis=0, label_format="signed",
                 **kwargs):
        super().__init__(weight, batch_axis, **kwargs)
        self._label_format = label_format

    def hybrid_forward(self, F, pred, label, sample_weight=None):
        label = _reshape_like(F, label, pred)
        if self._label_format == "signed":
            label = (label + 1.0) / 2.0
        loss = F.relu(pred) - pred * label + \
            F.Activation(-F.abs(pred), act_type="softrelu")
        loss = _apply_weighting(F, loss, self._weight, sample_weight)
        return _batch_mean(F, loss, self._batch_axis)


class TripletLoss(Loss):
    def __init__(self, margin=1, weight=None, batch_axis=0, **kwargs):
        super().__init__(weight, batch_axis, **kwargs)
        self._margin = margin

    def hybrid_forward(self, F, pred, positive, negative, sample_weight=None):
        positive = _reshape_like(F, positive, pred)
        negative = _reshape_like(F, negative, pred)
        loss = F.sum(F.square(positive - pred) - F.square(negative - pred),
                     axis=self._batch_axis, exclude=True)
        loss = F.relu(loss + self._margin)
        loss = _apply_weighting(F, loss, self._weight, sample_weight)
        return loss


class CosineEmbeddingLoss(Loss):
    def __init__(self, weight=None, batch_axis=0, margin=0, **kwargs):
        super().__init__(weight, batch_axis, **kwargs)
        self._margin = margin

    def hybrid_forward(self, F, input1, input2, label, sample_weight=None):
        input1 = input1.reshape((input1.shape[0], -1))
        input2 = input2.reshape((input2.shape[0], -1))
        cos = F.sum(input1 * input2, axis=-1) / (
            F.norm(input1, axis=-1) * F.norm(input2, axis=-1) + 1e-12)
        label = label.reshape((-1,))
        loss = F.where(label == 1, 1.0 - cos, F.relu(cos - self._margin))
        loss = _apply_weighting(F, loss, self._weight, sample_weight)
        return loss
