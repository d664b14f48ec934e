"""Evaluation metrics: ``EvalMetric`` and every metric of the reference
(``Accuracy``, ``TopKAccuracy``, ``F1``, ``MCC``, ``Perplexity``,
``MAE``, ``MSE``, ``RMSE``, ``CrossEntropy``, ``NegativeLogLikelihood``,
``PearsonCorrelation``, ``Loss``, ``Torch``, ``Caffe``, ``CustomMetric``,
``CompositeEvalMetric``), ``np`` and ``create``.

PyTorch counterpart of ``mxnet_tpu/metric.py`` (reference:
python/mxnet/metric.py).  Metrics accumulate on the host: each update
converts its labels and predictions to numpy (``_to_np``, one device to
host copy an array), as the reference's host path does.
``update_device`` (what ``Module.update_metric`` calls) is ``update``.
"""
from __future__ import annotations

import math

import numpy as _np

from .ndarray.ndarray import NDArray

__all__ = ["EvalMetric", "CompositeEvalMetric", "Accuracy", "TopKAccuracy", "F1",
           "MCC", "Perplexity", "MAE", "MSE", "RMSE", "CrossEntropy",
           "NegativeLogLikelihood", "PearsonCorrelation", "Loss", "Torch", "Caffe",
           "CustomMetric", "np", "create", "register"]

_REG = {}


def register(name=None, *aliases):
    """Class decorator: ``create(name)`` (any case) and each alias builds
    the class."""
    def _reg(klass):
        for k in ((name or klass.__name__), *aliases):
            k = k.lower()
            if k in _REG and _REG[k] is not klass:
                raise ValueError(f"metric {k!r} is already registered")
            _REG[k] = klass
        return klass
    return _reg


def _to_np(x):
    if isinstance(x, NDArray):
        return x.asnumpy()
    if hasattr(x, "detach"):
        return x.detach().cpu().numpy()
    return _np.asarray(x)


def check_label_shapes(labels, preds, shape=False):
    if len(labels) != len(preds):
        raise ValueError(f"labels/preds count mismatch: {len(labels)} vs {len(preds)}")


class EvalMetric:
    def __init__(self, name, output_names=None, label_names=None, **kwargs):
        self.name = str(name)
        self.output_names = output_names
        self.label_names = label_names
        self._kwargs = kwargs
        self.reset()

    def update(self, labels, preds):
        raise NotImplementedError

    def update_device(self, labels, preds):
        """``update`` (the port accumulates on the host)."""
        self.update(labels, preds)

    def update_dict(self, label, pred, device=False):
        if self.output_names is not None:
            pred = [pred[n] for n in self.output_names if n in pred]
        else:
            pred = list(pred.values())
        if self.label_names is not None:
            label = [label[n] for n in self.label_names if n in label]
        else:
            label = list(label.values())
        if device:
            self.update_device(label, pred)
        else:
            self.update(label, pred)

    def reset(self):
        self.num_inst = 0
        self.sum_metric = 0.0

    def get(self):
        if self.num_inst == 0:
            return (self.name, float("nan"))
        return (self.name, self.sum_metric / self.num_inst)

    def get_name_value(self):
        name, value = self.get()
        if not isinstance(name, list):
            name = [name]
        if not isinstance(value, list):
            value = [value]
        return list(zip(name, value))

    def get_config(self):
        config = dict(self._kwargs)
        config.update({"metric": self.__class__.__name__, "name": self.name})
        return config

    def __str__(self):
        return f"EvalMetric: {dict(self.get_name_value())}"


class CompositeEvalMetric(EvalMetric):
    def __init__(self, metrics=None, name="composite", output_names=None,
                 label_names=None):
        super().__init__(name, output_names, label_names)
        self.metrics = [create(m) if isinstance(m, str) else m for m in (metrics or [])]

    def add(self, metric):
        self.metrics.append(create(metric) if isinstance(metric, str) else metric)

    def get_metric(self, index):
        return self.metrics[index]

    def update(self, labels, preds):
        for m in self.metrics:
            m.update(labels, preds)

    def reset(self):
        for m in getattr(self, "metrics", []):
            m.reset()

    def get(self):
        names, values = [], []
        for m in self.metrics:
            n, v = m.get()
            names.append(n) if not isinstance(n, list) else names.extend(n)
            values.append(v) if not isinstance(v, list) else values.extend(v)
        return (names, values)


@register("acc", "accuracy")
class Accuracy(EvalMetric):
    def __init__(self, axis=1, name="accuracy", output_names=None, label_names=None):
        super().__init__(name, output_names, label_names, axis=axis)
        self.axis = axis

    def update(self, labels, preds):
        check_label_shapes(labels, preds)
        for label, pred in zip(labels, preds):
            p = _to_np(pred)
            l = _to_np(label).astype(_np.int64)
            # reference: argmax whenever shapes differ — the ubiquitous
            # (N,1) label with (N,C) preds included, not just ndim mismatch
            if p.shape != l.shape:
                p = _np.argmax(p, axis=self.axis)
            p = p.astype(_np.int64).reshape(-1)
            l = l.reshape(-1)
            self.sum_metric += float((p == l).sum())
            self.num_inst += l.size

@register("top_k_accuracy", "top_k_acc")
class TopKAccuracy(EvalMetric):
    def __init__(self, top_k=1, name="top_k_accuracy", output_names=None,
                 label_names=None):
        super().__init__(f"{name}_{top_k}", output_names, label_names, top_k=top_k)
        self.top_k = top_k

    def update(self, labels, preds):
        for label, pred in zip(labels, preds):
            p = _to_np(pred)
            # reference flattens the label; an (N,1) label would otherwise
            # broadcast (N,k) against (N,1,1) and count cross-sample hits
            l = _to_np(label).astype(_np.int64).reshape(-1)
            topk = _np.argsort(-p.reshape(len(l), -1), axis=-1)[:, :self.top_k]
            hits = (topk == l[:, None]).any(axis=-1)
            self.sum_metric += float(hits.sum())
            self.num_inst += l.size

@register("f1")
class F1(EvalMetric):
    def __init__(self, name="f1", output_names=None, label_names=None, average="macro"):
        super().__init__(name, output_names, label_names)
        self.average = average
        self.reset_stats()

    def reset_stats(self):
        self._tp = self._fp = self._fn = 0.0

    def reset(self):
        super().reset()
        if hasattr(self, "_tp"):
            self.reset_stats()
        else:
            self.reset_stats()

    @staticmethod
    def _f1_of(tp, fp, fn):
        prec = tp / (tp + fp) if tp + fp else 0.0
        rec = tp / (tp + fn) if tp + fn else 0.0
        return 2 * prec * rec / (prec + rec) if prec + rec else 0.0

    def update(self, labels, preds):
        for label, pred in zip(labels, preds):
            p = _to_np(pred)
            l = _to_np(label).astype(_np.int64).flatten()
            if p.ndim > 1:
                p = _np.argmax(p, axis=-1)
            p = p.astype(_np.int64).flatten()
            tp = float(((p == 1) & (l == 1)).sum())
            fp = float(((p == 1) & (l == 0)).sum())
            fn = float(((p == 0) & (l == 1)).sum())
            if self.average == "macro":
                # reference semantics: per-update F1 values, averaged
                self.sum_metric += self._f1_of(tp, fp, fn)
                self.num_inst += 1
            else:  # micro: pooled cumulative counts
                self._tp += tp
                self._fp += fp
                self._fn += fn
                self.sum_metric = self._f1_of(self._tp, self._fp, self._fn)
                self.num_inst = 1


@register("mcc")
class MCC(EvalMetric):
    def __init__(self, name="mcc", output_names=None, label_names=None, average="macro"):
        super().__init__(name, output_names, label_names)
        self.average = average
        self._tp = self._fp = self._tn = self._fn = 0.0

    def reset(self):
        super().reset()
        self._tp = self._fp = self._tn = self._fn = 0.0

    @staticmethod
    def _mcc_of(tp, fp, tn, fn):
        denom = math.sqrt((tp + fp) * (tp + fn) * (tn + fp) * (tn + fn))
        return ((tp * tn - fp * fn) / denom) if denom else 0.0

    def update(self, labels, preds):
        for label, pred in zip(labels, preds):
            p = _to_np(pred)
            l = _to_np(label).astype(_np.int64).flatten()
            if p.ndim > 1:
                p = _np.argmax(p, axis=-1)
            p = p.astype(_np.int64).flatten()
            tp = float(((p == 1) & (l == 1)).sum())
            fp = float(((p == 1) & (l == 0)).sum())
            tn = float(((p == 0) & (l == 0)).sum())
            fn = float(((p == 0) & (l == 1)).sum())
            if self.average == "macro":
                # reference semantics: per-update MCC values, averaged
                self.sum_metric += self._mcc_of(tp, fp, tn, fn)
                self.num_inst += 1
            else:  # micro: pooled cumulative counts
                self._tp += tp
                self._fp += fp
                self._tn += tn
                self._fn += fn
                self.sum_metric = self._mcc_of(self._tp, self._fp,
                                               self._tn, self._fn)
                self.num_inst = 1


@register("perplexity")
class Perplexity(EvalMetric):
    def __init__(self, ignore_label=None, axis=-1, name="perplexity",
                 output_names=None, label_names=None):
        super().__init__(name, output_names, label_names, ignore_label=ignore_label)
        self.ignore_label = ignore_label
        self.axis = axis

    def update(self, labels, preds):
        # accumulate pooled NLL; get() exponentiates once —
        # exp(sum_loss/total_num), matching the reference (metric.py Perplexity)
        for label, pred in zip(labels, preds):
            p = _to_np(pred)
            l = _to_np(label).astype(_np.int64).flatten()
            # honor the class axis (reference picks along self.axis); move it
            # last, flatten the rest
            ax = self.axis % p.ndim
            if ax != p.ndim - 1:
                p = _np.moveaxis(p, ax, -1)
            p = p.reshape(-1, p.shape[-1])
            # clip indices like the reference's pick(mode='clip'): ignored
            # labels may be out of class range (e.g. pad id == num classes)
            lc = _np.clip(l, 0, p.shape[1] - 1)
            probs = p[_np.arange(l.size), lc]
            num = l.size
            if self.ignore_label is not None:
                ignore = (l == self.ignore_label)
                probs = _np.where(ignore, 1.0, probs)
                num -= int(ignore.sum())
            self.sum_metric += -float(_np.log(_np.maximum(probs, 1e-10)).sum())
            self.num_inst += max(num, 0)

    def get(self):
        if self.num_inst == 0:
            return (self.name, float("nan"))
        return (self.name, math.exp(self.sum_metric / self.num_inst))


@register("mae")
class MAE(EvalMetric):
    def __init__(self, name="mae", output_names=None, label_names=None):
        super().__init__(name, output_names, label_names)

    def update(self, labels, preds):
        for label, pred in zip(labels, preds):
            p, l = _to_np(pred), _to_np(label)
            # reference reshapes each 1-D side to (N,1): never broadcast a
            # 1-D/2-D pair into an (N,N) matrix, and allow (N,)/(N,C)
            if l.ndim == 1:
                l = l.reshape(-1, 1)
            if p.ndim == 1:
                p = p.reshape(-1, 1)
            self.sum_metric += float(_np.abs(l - p).mean())
            self.num_inst += 1

@register("mse")
class MSE(EvalMetric):
    def __init__(self, name="mse", output_names=None, label_names=None):
        super().__init__(name, output_names, label_names)

    def update(self, labels, preds):
        for label, pred in zip(labels, preds):
            p, l = _to_np(pred), _to_np(label)
            # reference reshapes each 1-D side to (N,1): never broadcast a
            # 1-D/2-D pair into an (N,N) matrix, and allow (N,)/(N,C)
            if l.ndim == 1:
                l = l.reshape(-1, 1)
            if p.ndim == 1:
                p = p.reshape(-1, 1)
            self.sum_metric += float(((l - p) ** 2).mean())
            self.num_inst += 1

@register("rmse")
class RMSE(EvalMetric):
    def __init__(self, name="rmse", output_names=None, label_names=None):
        super().__init__(name, output_names, label_names)

    def update(self, labels, preds):
        for label, pred in zip(labels, preds):
            p, l = _to_np(pred), _to_np(label)
            # reference reshapes each 1-D side to (N,1): never broadcast a
            # 1-D/2-D pair into an (N,N) matrix, and allow (N,)/(N,C)
            if l.ndim == 1:
                l = l.reshape(-1, 1)
            if p.ndim == 1:
                p = p.reshape(-1, 1)
            self.sum_metric += float(math.sqrt(((l - p) ** 2).mean()))
            self.num_inst += 1

@register("ce", "cross-entropy")
class CrossEntropy(EvalMetric):
    def __init__(self, eps=1e-12, name="cross-entropy", output_names=None,
                 label_names=None):
        super().__init__(name, output_names, label_names, eps=eps)
        self.eps = eps

    def update(self, labels, preds):
        for label, pred in zip(labels, preds):
            p = _to_np(pred)
            l = _to_np(label).astype(_np.int64).flatten()
            p = p.reshape(-1, p.shape[-1])
            prob = p[_np.arange(l.size), l]
            self.sum_metric += float(-_np.log(prob + self.eps).sum())
            self.num_inst += l.size

@register("nll_loss")
class NegativeLogLikelihood(CrossEntropy):
    def __init__(self, eps=1e-12, name="nll-loss", output_names=None,
                 label_names=None):
        super().__init__(eps=eps, name=name, output_names=output_names,
                         label_names=label_names)


@register("pearsonr")
class PearsonCorrelation(EvalMetric):
    def __init__(self, name="pearsonr", output_names=None, label_names=None):
        super().__init__(name, output_names, label_names)

    def update(self, labels, preds):
        for label, pred in zip(labels, preds):
            p, l = _to_np(pred).flatten(), _to_np(label).flatten()
            if p.size < 2:
                continue
            r = _np.corrcoef(p, l)[0, 1]
            self.sum_metric += float(r)
            self.num_inst += 1


@register("loss")
class Loss(EvalMetric):
    def __init__(self, name="loss", output_names=None, label_names=None):
        super().__init__(name, output_names, label_names)

    def update(self, _, preds):
        for pred in preds:
            p = _to_np(pred)
            self.sum_metric += float(p.sum())
            self.num_inst += p.size

@register("torch")
class Torch(Loss):
    def __init__(self, name="torch", output_names=None, label_names=None):
        super().__init__(name, output_names, label_names)


@register("caffe")
class Caffe(Loss):
    def __init__(self, name="caffe", output_names=None, label_names=None):
        super().__init__(name, output_names, label_names)


class CustomMetric(EvalMetric):
    def __init__(self, feval, name=None, allow_extra_outputs=False,
                 output_names=None, label_names=None):
        name = name or getattr(feval, "__name__", "custom")
        super().__init__(f"custom({name})", output_names, label_names)
        self._feval = feval
        self._allow_extra_outputs = allow_extra_outputs

    def update(self, labels, preds):
        if not self._allow_extra_outputs:
            check_label_shapes(labels, preds)
        for label, pred in zip(labels, preds):
            reval = self._feval(_to_np(label), _to_np(pred))
            if isinstance(reval, tuple):
                num, val = reval
                self.sum_metric += val
                self.num_inst += num
            else:
                self.sum_metric += reval
                self.num_inst += 1


def np(numpy_feval, name=None, allow_extra_outputs=False):
    """Wrap a numpy feval into a metric (reference: metric.np)."""
    return CustomMetric(numpy_feval, name, allow_extra_outputs)


def create(metric, *args, **kwargs):
    if callable(metric):
        return CustomMetric(metric, *args, **kwargs)
    if isinstance(metric, EvalMetric):
        return metric
    if isinstance(metric, list):
        composite = CompositeEvalMetric()
        for m in metric:
            composite.add(create(m, *args, **kwargs))
        return composite
    try:
        klass = _REG[metric.lower()]
    except KeyError:
        raise KeyError(f"metric {metric!r} is not registered; known: "
                       f"{sorted(_REG)}") from None
    return klass(*args, **kwargs)
