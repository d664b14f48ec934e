"""Optimizers.

PyTorch counterpart of ``mxnet_tpu/optimizer.py``: the ``Optimizer`` base
(``lr_mult``/``wd_mult`` by name and through ``param_dict``,
``rescale_grad``, ``clip_gradient``, ``multi_precision``,
``begin_num_update``/``num_update``, ``set_learning_rate``),
``register``/``create``, every optimizer the reference registers (``SGD``,
``NAG``, ``Adam``, ``AdaGrad``, ``RMSProp``, ``Signum``, ``FTML``,
``LBSGD``, ``DCASGD``, ``SGLD``, ``AdaDelta``, ``Ftrl``, ``Adamax``,
``Nadam`` and ``Test``, each computing as the reference does, with its
states), and the ``Updater``.  ``SGLD``'s noise comes from the port's
threefry stream, key for key the reference's.

Updates run in place on the weight's and the states' tensors, under
``torch.no_grad()``, so an update through a Gluon ``Parameter``'s
``NDArray`` is the block's weight.  With ``multi_precision`` a float16 or
bfloat16 weight keeps a float32 master copy in its state, updated in
float32 and rounded into the weight.

``Updater(index_list, grad_list, weight_list)`` applies a list of updates
at once: for ``SGD``, the Gluon loop's optimizer, as one pass of
``torch._foreach_*`` ops over the list (the reference's ``_batch_fused``
compiles them into one program), each op the same elementwise arithmetic,
in the same order, as the per-parameter ``update``, so both give the same
bits.  The per-parameter loop stays the ground truth and takes every other
optimizer, and any list holding a sparse weight or gradient
(``ndarray.sparse``): such an update runs the dense rule on the dense
values, and a sparse weight takes the result back (its pattern the new
weight's non-zero rows), as the reference's does.

Optimizer state files: ``Updater.get_states(dump_optimizer=False)`` is a
pickled ``{index: numpy arrays}`` dict that loads in either package
(bfloat16 states are written as float32).  With ``dump_optimizer=True`` the
optimizer object is pickled too, and its class belongs to one package: a
file the JAX package wrote that way is refused by ``set_states`` (with
``MXNetError``), and the JAX package cannot read this package's.

An ``lr_scheduler`` (``lr_scheduler.py``) takes the optimizer's
``learning_rate`` as its ``base_lr`` and gives the rate of every update,
read at ``num_update`` (the ``_foreach`` pass reads it once a step, after
the step's update counts).  ``sym=`` reads each variable's
``__lr_mult__``/``__wd_mult__`` attributes, as ``Module.init_optimizer``
passes its symbol; a ``set_wd_mult`` call keeps the symbol's.
"""
from __future__ import annotations

import io
import math
import pickle
from typing import Dict

import numpy as np
import torch

from .base import MXNetError
from .ndarray.ndarray import NDArray

__all__ = ["Optimizer", "SGD", "Signum", "FTML", "LBSGD", "DCASGD", "NAG",
           "SGLD", "Adam", "AdaGrad", "RMSProp", "AdaDelta", "Ftrl",
           "Adamax", "Nadam", "Test", "register", "create", "Updater",
           "get_updater"]

_REG: Dict[str, type] = {}


def register(klass):
    """Class decorator: ``create(name)`` builds ``klass`` (any case)."""
    _REG[klass.__name__.lower()] = klass
    return klass


def create(name, **kwargs) -> "Optimizer":
    if isinstance(name, Optimizer):
        return name
    try:
        klass = _REG[name.lower()]
    except KeyError:
        raise MXNetError(f"unknown optimizer {name!r} (registered: "
                         f"{sorted(_REG)})") from None
    return klass(**kwargs)


def _zeros(weight):
    return NDArray(torch.zeros_like(weight._data.detach()))


class Optimizer:
    #: whether ``_update_list`` applies a list of updates with _foreach ops
    multi_tensor = False

    def __init__(self, rescale_grad=1.0, param_idx2name=None, wd=0.0,
                 clip_gradient=None, learning_rate=0.01, lr_scheduler=None,
                 sym=None, begin_num_update=0, multi_precision=False,
                 param_dict=None, **kwargs):
        self.rescale_grad = rescale_grad
        self.lr = learning_rate
        self.lr_scheduler = lr_scheduler
        if lr_scheduler is not None:
            self.lr_scheduler.base_lr = learning_rate
        self.wd = wd
        self.clip_gradient = clip_gradient
        self.begin_num_update = begin_num_update
        self.num_update = begin_num_update
        self.multi_precision = multi_precision
        self._index_update_count: Dict = {}
        self.idx2name = dict(param_idx2name or {})
        self.param_dict = param_dict or {}
        self.lr_mult: Dict[str, float] = {}
        self.wd_mult: Dict[str, float] = {}
        self._sym_wd_mult: Dict[str, float] = {}
        if sym is not None:
            for name, a in sym.attr_dict().items():
                if "__lr_mult__" in a:
                    self.lr_mult[name] = float(a["__lr_mult__"])
                if "__wd_mult__" in a:
                    self.wd_mult[name] = float(a["__wd_mult__"])
                    self._sym_wd_mult[name] = float(a["__wd_mult__"])

    def __getstate__(self):
        # param_dict holds the Gluon Parameters (and through them their
        # blocks): the Trainer re-attaches it after loading
        state = dict(self.__dict__)
        state["param_dict"] = {}
        return state

    # -- bookkeeping --------------------------------------------------------
    def set_learning_rate(self, lr):
        self.lr = lr

    @property
    def learning_rate(self):
        if self.lr_scheduler is not None:
            return self.lr_scheduler(self.num_update)
        return self.lr

    def set_lr_mult(self, args_lr_mult):
        self.lr_mult.update(args_lr_mult)

    def set_wd_mult(self, args_wd_mult):
        self.wd_mult = {}
        for n in self.idx2name.values():
            if not (n.endswith("_weight") or n.endswith("_gamma")):
                self.wd_mult[n] = 0.0
        self.wd_mult.update(self._sym_wd_mult)
        self.wd_mult.update(args_wd_mult)

    def _update_count(self, index):
        if index not in self._index_update_count:
            self._index_update_count[index] = self.begin_num_update
        self._index_update_count[index] += 1
        self.num_update = max(self._index_update_count[index],
                              self.num_update)

    def _get_lr_mult(self, index):
        if index in self.param_dict:
            return getattr(self.param_dict[index], "lr_mult", 1.0)
        name = self.idx2name.get(index, index if isinstance(index, str)
                                 else None)
        return self.lr_mult.get(name, 1.0)

    def _get_wd_mult(self, index):
        if index in self.param_dict:
            return getattr(self.param_dict[index], "wd_mult", 1.0)
        name = self.idx2name.get(index, index if isinstance(index, str)
                                 else None)
        return self.wd_mult.get(name, 1.0)

    def _get_lr(self, index):
        lr = self.lr_scheduler(self.num_update) if self.lr_scheduler \
            else self.lr
        return lr * self._get_lr_mult(index)

    def _get_wd(self, index):
        return self.wd * self._get_wd_mult(index)

    def _preprocess(self, g):
        """``g * rescale_grad``, clipped to ``+-clip_gradient``."""
        g = torch.mul(g, self.rescale_grad)
        if self.clip_gradient is not None:
            g = torch.clamp(g, -self.clip_gradient, self.clip_gradient)
        return g

    def _preprocess_list(self, gs):
        gs = torch._foreach_mul(gs, self.rescale_grad)
        if self.clip_gradient is not None:
            torch._foreach_clamp_min_(gs, -self.clip_gradient)
            torch._foreach_clamp_max_(gs, self.clip_gradient)
        return gs

    def _needs_master(self, weight):
        return self.multi_precision and weight._data.dtype in (
            torch.float16, torch.bfloat16)

    # -- API ----------------------------------------------------------------
    def create_state(self, index, weight):
        return None

    def create_state_multi_precision(self, index, weight):
        if self._needs_master(weight):
            master = NDArray(weight._data.detach().float())
            return (master, self.create_state(index, master))
        return self.create_state(index, weight)

    def update(self, index, weight, grad, state):
        raise NotImplementedError

    def update_multi_precision(self, index, weight, grad, state):
        if self._needs_master(weight):
            master, inner = state
            self.update(index, master, NDArray(grad._data.float()), inner)
            with torch.no_grad():
                weight._data.copy_(master._data)
        else:
            self.update(index, weight, grad, state)

    def update_multi_precision_list(self, indices, weights, grads, states):
        """The updates of ``update_multi_precision`` for a whole list, as
        one pass of _foreach ops (``multi_tensor`` optimizers only)."""
        ws, gs, ss, lowp, masters = [], [], [], [], []
        for w, g, s in zip(weights, grads, states):
            if self._needs_master(w):
                master, inner = s
                ws.append(master._data)
                gs.append(g._data.float())
                ss.append(inner)
                lowp.append(w._data)
                masters.append(master._data)
            else:
                ws.append(w._data)
                gs.append(g._data)
                ss.append(s)
        for i in indices:
            self._update_count(i)
        lrs = [self._get_lr(i) for i in indices]
        wds = [self._get_wd(i) for i in indices]
        with torch.no_grad():
            self._update_list(indices, ws, gs, ss, lrs, wds)
            if lowp:
                torch._foreach_copy_(lowp, masters)

    def _update_list(self, indices, ws, gs, states, lrs, wds):
        raise NotImplementedError


def _data(states):
    return [s._data for s in states]


@register
class SGD(Optimizer):
    """SGD with momentum (reference: optimizer.py SGD): ``g = rescale *
    grad (clipped) + wd * w``; ``m = momentum * m - lr * g``, ``w += m``
    (``w -= lr * g`` without momentum)."""

    multi_tensor = True

    def __init__(self, momentum=0.0, lazy_update=True, **kwargs):
        super().__init__(**kwargs)
        self.momentum = momentum
        self.lazy_update = lazy_update

    def create_state(self, index, weight):
        return None if self.momentum == 0.0 else _zeros(weight)

    def update(self, index, weight, grad, state):
        self._update_count(index)
        lr, wd = self._get_lr(index), self._get_wd(index)
        with torch.no_grad():
            w = weight._data
            g = torch.add(self._preprocess(grad._data), torch.mul(w, wd))
            if state is None:
                w.sub_(torch.mul(g, lr))
            else:
                m = state._data
                m.mul_(self.momentum)
                m.sub_(torch.mul(g, lr))
                w.add_(m)

    def _update_list(self, indices, ws, gs, states, lrs, wds):
        g = self._preprocess_list(gs)
        torch._foreach_add_(g, torch._foreach_mul(ws, wds))
        lg = torch._foreach_mul(g, lrs)
        if states[0] is None:
            torch._foreach_sub_(ws, lg)
            return
        ms = _data(states)
        torch._foreach_mul_(ms, self.momentum)
        torch._foreach_sub_(ms, lg)
        torch._foreach_add_(ws, ms)


@register
class NAG(Optimizer):
    """Nesterov accelerated SGD (reference: optimizer.py NAG): ``m =
    momentum * m + g``, ``w -= lr * (g + momentum * m)``."""

    def __init__(self, momentum=0.0, **kwargs):
        super().__init__(**kwargs)
        self.momentum = momentum

    def create_state(self, index, weight):
        return None if self.momentum == 0.0 else _zeros(weight)

    def update(self, index, weight, grad, state):
        self._update_count(index)
        lr, wd = self._get_lr(index), self._get_wd(index)
        with torch.no_grad():
            w = weight._data
            g = torch.add(self._preprocess(grad._data), torch.mul(w, wd))
            if state is None:
                w.sub_(torch.mul(g, lr))
                return
            m = state._data
            m.mul_(self.momentum)
            m.add_(g)
            w.sub_(torch.mul(torch.add(g, torch.mul(m, self.momentum)), lr))


@register
class Adam(Optimizer):
    """Adam (reference: optimizer.py Adam): the step's lr corrected by
    ``sqrt(1 - beta2^t) / (1 - beta1^t)`` in float64 on the host."""

    def __init__(self, learning_rate=0.001, beta1=0.9, beta2=0.999,
                 epsilon=1e-8, lazy_update=True, **kwargs):
        super().__init__(learning_rate=learning_rate, **kwargs)
        self.beta1, self.beta2, self.epsilon = beta1, beta2, epsilon
        self.lazy_update = lazy_update

    def create_state(self, index, weight):
        return (_zeros(weight), _zeros(weight))

    def _corrected_lr(self, index):
        t = self._index_update_count[index]
        return self._get_lr(index) * math.sqrt(1.0 - self.beta2 ** t) / (
            1.0 - self.beta1 ** t)

    def update(self, index, weight, grad, state):
        self._update_count(index)
        lr, wd = self._corrected_lr(index), self._get_wd(index)
        with torch.no_grad():
            w = weight._data
            g = torch.add(self._preprocess(grad._data), torch.mul(w, wd))
            m, v = state[0]._data, state[1]._data
            m.mul_(self.beta1)
            m.add_(torch.mul(g, 1 - self.beta1))
            v.mul_(self.beta2)
            v.add_(torch.mul(torch.mul(g, 1 - self.beta2), g))
            den = torch.add(torch.sqrt(v), self.epsilon)
            w.sub_(torch.div(torch.mul(m, lr), den))


@register
class AdaGrad(Optimizer):
    """AdaGrad (reference: optimizer.py AdaGrad): the history accumulates
    the bare gradient; weight decay applies outside it."""

    def __init__(self, eps=1e-7, **kwargs):
        super().__init__(**kwargs)
        self.float_stable_eps = eps

    def create_state(self, index, weight):
        return _zeros(weight)

    def update(self, index, weight, grad, state):
        self._update_count(index)
        lr, wd = self._get_lr(index), self._get_wd(index)
        with torch.no_grad():
            w, h = weight._data, state._data
            g = self._preprocess(grad._data)
            h.add_(torch.mul(g, g))
            step = torch.div(g, torch.sqrt(torch.add(
                h, self.float_stable_eps)))
            w.sub_(torch.mul(torch.add(step, torch.mul(w, wd)), lr))


@register
class RMSProp(Optimizer):
    """RMSProp, plain and centered (reference: optimizer.py RMSProp)."""

    def __init__(self, learning_rate=0.001, gamma1=0.9, gamma2=0.9,
                 epsilon=1e-8, centered=False, clip_weights=None, **kwargs):
        super().__init__(learning_rate=learning_rate, **kwargs)
        self.gamma1, self.gamma2, self.epsilon = gamma1, gamma2, epsilon
        self.centered = centered
        self.clip_weights = clip_weights

    def create_state(self, index, weight):
        if self.centered:
            return (_zeros(weight), _zeros(weight), _zeros(weight))
        return _zeros(weight)

    def update(self, index, weight, grad, state):
        self._update_count(index)
        lr, wd = self._get_lr(index), self._get_wd(index)
        g1 = self.gamma1
        with torch.no_grad():
            w = weight._data
            g = self._preprocess(grad._data) + wd * w
            if self.centered:
                n, mg, delta = (s._data for s in state)
                n.copy_((1 - g1) * g * g + g1 * n)
                mg.copy_((1 - g1) * g + g1 * mg)
                delta.copy_(self.gamma2 * delta - lr * g / torch.sqrt(
                    n - mg * mg + self.epsilon))
                w.add_(delta)
            else:
                n = state._data
                n.copy_((1 - g1) * g * g + g1 * n)
                w.sub_(lr * g / torch.sqrt(n + self.epsilon))
            if self.clip_weights:
                w.clamp_(-self.clip_weights, self.clip_weights)


@register
class Signum(Optimizer):
    """signSGD with momentum (reference: optimizer.py Signum)."""

    def __init__(self, learning_rate=0.01, momentum=0.9, wd_lh=0.0,
                 **kwargs):
        super().__init__(learning_rate=learning_rate, **kwargs)
        self.momentum = momentum
        self.wd_lh = wd_lh

    def create_state(self, index, weight):
        return None if self.momentum == 0.0 else _zeros(weight)

    def update(self, index, weight, grad, state):
        self._update_count(index)
        lr, wd = self._get_lr(index), self._get_wd(index)
        with torch.no_grad():
            w = weight._data
            g = self._preprocess(grad._data)
            if state is not None:
                m = state._data
                m.copy_(self.momentum * m - (1 - self.momentum) * (g + wd * w))
                w.copy_((1 - lr * self.wd_lh) * w + lr * torch.sign(m))
            else:
                w.copy_((1 - lr * (wd + self.wd_lh)) * w
                        - lr * torch.sign(g))


@register
class FTML(Optimizer):
    """Follow the moving leader (reference: optimizer.py FTML); states
    ``(d, v, z)``."""

    def __init__(self, beta1=0.6, beta2=0.999, epsilon=1e-8, **kwargs):
        super().__init__(**kwargs)
        self.beta1, self.beta2, self.epsilon = beta1, beta2, epsilon

    def create_state(self, index, weight):
        return (_zeros(weight), _zeros(weight), _zeros(weight))

    def update(self, index, weight, grad, state):
        self._update_count(index)
        t = self._index_update_count[index]
        lr, wd = self._get_lr(index), self._get_wd(index)
        b1, b2 = self.beta1, self.beta2
        with torch.no_grad():
            w = weight._data
            g = self._preprocess(grad._data) + wd * w
            d, v, z = (s._data for s in state)
            v.copy_(b2 * v + (1 - b2) * g * g)
            d_t = (1 - b1 ** t) / lr * (
                torch.sqrt(v / (1 - b2 ** t)) + self.epsilon)
            sigma = d_t - b1 * d
            z.copy_(b1 * z + (1 - b1) * g - sigma * w)
            d.copy_(d_t)
            w.copy_(-z / d_t)


@register
class LBSGD(Optimizer):
    """Large-batch SGD (reference: optimizer.py LBSGD): the rate scaled
    by ``lbmult``, which warms up from 1 to ``batch_scale`` over
    ``warmup_epochs`` (``linear``, ``power2`` or ``sqrt``), or by the
    layer's LARS ratio under ``warmup_strategy="lars"``; momentum SGD."""

    def __init__(self, momentum=0.0, multi_precision=False,
                 warmup_strategy="linear", warmup_epochs=5, batch_scale=1,
                 updates_per_epoch=32, begin_epoch=0, num_epochs=60,
                 **kwargs):
        super().__init__(multi_precision=multi_precision, **kwargs)
        self.momentum = momentum
        self.warmup_strategy = warmup_strategy
        self.warmup_epochs = warmup_epochs
        self.batch_scale = batch_scale
        self.updates_per_epoch = updates_per_epoch
        self.init_updates = begin_epoch * updates_per_epoch
        self.num_epochs = num_epochs
        self.lbmult = 1.0

    def create_state(self, index, weight):
        return _zeros(weight)

    def _get_lbmult(self, nup):
        nwup = self.warmup_epochs * self.updates_per_epoch
        if nup >= nwup or nwup == 0:
            return self.batch_scale
        if self.warmup_strategy == "linear":
            return 1.0 + (self.batch_scale - 1) * nup / nwup
        if self.warmup_strategy == "power2":
            return 1.0 + (self.batch_scale - 1) * (nup * nup) / (nwup * nwup)
        if self.warmup_strategy == "sqrt":
            return 1.0 + (self.batch_scale - 1) * math.sqrt(nup / nwup)
        return 1.0

    def update(self, index, weight, grad, state):
        self._update_count(index)
        lr, wd = self._get_lr(index), self._get_wd(index)
        with torch.no_grad():
            w, m = weight._data, state._data
            g = self._preprocess(grad._data)
            if self.warmup_strategy == "lars":
                w_norm = float(torch.linalg.vector_norm(w.float()))
                g_norm = float(torch.linalg.vector_norm(g.float()))
                if w_norm > 0 and g_norm > 0:
                    lr = lr * (w_norm / (g_norm + wd * w_norm))
            else:
                lr = lr * self._get_lbmult(self.num_update
                                           - self.init_updates)
            m.copy_(self.momentum * m - lr * (g + wd * w))
            w.add_(m)


@register
class DCASGD(Optimizer):
    """Delay-compensated asynchronous SGD (reference: optimizer.py
    DCASGD); states ``(momentum or None, previous weight)``."""

    def __init__(self, momentum=0.0, lamda=0.04, **kwargs):
        super().__init__(**kwargs)
        self.momentum = momentum
        self.lamda = lamda

    def create_state(self, index, weight):
        mom = _zeros(weight) if self.momentum != 0 else None
        return (mom, NDArray(weight._data.detach().clone()))

    def update(self, index, weight, grad, state):
        self._update_count(index)
        lr, wd = self._get_lr(index), self._get_wd(index)
        with torch.no_grad():
            w = weight._data
            g = self._preprocess(grad._data)
            mom, prev = state
            comp = g + self.lamda * g * g * (w - prev._data)
            if mom is not None:
                mom._data.copy_(self.momentum * mom._data
                                - lr * (comp + wd * w))
                delta = mom._data
            else:
                delta = -lr * (comp + wd * w)
            prev._data.copy_(w)
            w.add_(delta)


@register
class SGLD(Optimizer):
    """Stochastic gradient Langevin dynamics (reference: optimizer.py
    SGLD): ``w -= lr / 2 * g`` plus normal noise of variance ``lr``, drawn
    from the port's threefry stream (``random.next_key``), key for key
    the reference's."""

    def update(self, index, weight, grad, state):
        from . import random as _random
        from .ops.random_ops import random_normal

        self._update_count(index)
        lr, wd = self._get_lr(index), self._get_wd(index)
        with torch.no_grad():
            w = weight._data
            g = self._preprocess(grad._data) + wd * w
            key = _random.key_tensor(_random.next_key(), w.device)
            noise = random_normal(rng_key=key, shape=tuple(w.shape)) \
                * math.sqrt(lr)
            w.copy_(w - lr / 2 * g + noise)


@register
class AdaDelta(Optimizer):
    """AdaDelta (reference: optimizer.py AdaDelta): no learning rate;
    states ``(acc_g, acc_delta)``."""

    def __init__(self, rho=0.90, epsilon=1e-5, **kwargs):
        super().__init__(**kwargs)
        self.rho, self.epsilon = rho, epsilon

    def create_state(self, index, weight):
        return (_zeros(weight), _zeros(weight))

    def update(self, index, weight, grad, state):
        self._update_count(index)
        wd = self._get_wd(index)
        rho, eps = self.rho, self.epsilon
        with torch.no_grad():
            w = weight._data
            g = self._preprocess(grad._data) + wd * w
            acc_g, acc_delta = state[0]._data, state[1]._data
            acc_g.copy_(rho * acc_g + (1 - rho) * g * g)
            delta = torch.sqrt(acc_delta + eps) / torch.sqrt(acc_g + eps) * g
            acc_delta.copy_(rho * acc_delta + (1 - rho) * delta * delta)
            w.sub_(delta)


@register
class Ftrl(Optimizer):
    """FTRL-proximal (reference: optimizer.py Ftrl); states ``(z, n)``."""

    def __init__(self, lamda1=0.01, learning_rate=0.1, beta=1, **kwargs):
        super().__init__(learning_rate=learning_rate, **kwargs)
        self.lamda1, self.beta = lamda1, beta

    def create_state(self, index, weight):
        return (_zeros(weight), _zeros(weight))

    def update(self, index, weight, grad, state):
        self._update_count(index)
        lr, wd = self._get_lr(index), self._get_wd(index)
        with torch.no_grad():
            w = weight._data
            g = self._preprocess(grad._data)
            z, n = state[0]._data, state[1]._data
            sigma = (torch.sqrt(n + g * g) - torch.sqrt(n)) / lr
            z.copy_(z + g - sigma * w)
            n.copy_(n + g * g)
            w.copy_((torch.sign(z) * self.lamda1 - z)
                    / ((self.beta + torch.sqrt(n)) / lr + wd)
                    * (torch.abs(z) > self.lamda1))


@register
class Adamax(Optimizer):
    """Adamax (reference: optimizer.py Adamax), the infinity-norm Adam;
    states ``(m, u)``."""

    def __init__(self, learning_rate=0.002, beta1=0.9, beta2=0.999,
                 **kwargs):
        super().__init__(learning_rate=learning_rate, **kwargs)
        self.beta1, self.beta2 = beta1, beta2

    def create_state(self, index, weight):
        return (_zeros(weight), _zeros(weight))

    def update(self, index, weight, grad, state):
        self._update_count(index)
        t = self._index_update_count[index]
        lr, wd = self._get_lr(index), self._get_wd(index)
        lr /= (1.0 - self.beta1 ** t)
        with torch.no_grad():
            w = weight._data
            g = self._preprocess(grad._data) + wd * w
            m, u = state[0]._data, state[1]._data
            m.copy_(self.beta1 * m + (1 - self.beta1) * g)
            u.copy_(torch.maximum(self.beta2 * u, torch.abs(g)))
            w.copy_(w - lr * m / (u + 1e-8))


@register
class Nadam(Optimizer):
    """Nesterov Adam (reference: optimizer.py Nadam); states ``(m, v)``,
    the momentum schedule's product kept on the optimizer (one for all
    parameters, as the reference keeps it)."""

    def __init__(self, learning_rate=0.001, beta1=0.9, beta2=0.999,
                 epsilon=1e-8, schedule_decay=0.004, **kwargs):
        super().__init__(learning_rate=learning_rate, **kwargs)
        self.beta1, self.beta2, self.epsilon = beta1, beta2, epsilon
        self.schedule_decay = schedule_decay
        self.m_schedule = 1.0

    def create_state(self, index, weight):
        return (_zeros(weight), _zeros(weight))

    def update(self, index, weight, grad, state):
        self._update_count(index)
        t = self._index_update_count[index]
        lr, wd = self._get_lr(index), self._get_wd(index)
        b1, b2 = self.beta1, self.beta2
        momentum_t = b1 * (1.0 - 0.5 * 0.96 ** (t * self.schedule_decay))
        momentum_t_1 = b1 * (1.0 - 0.5 * 0.96 ** ((t + 1)
                                                  * self.schedule_decay))
        self.m_schedule = self.m_schedule * momentum_t
        m_schedule_next = self.m_schedule * momentum_t_1
        with torch.no_grad():
            w = weight._data
            g = self._preprocess(grad._data) + wd * w
            m, v = state[0]._data, state[1]._data
            m.copy_(b1 * m + (1 - b1) * g)
            v.copy_(b2 * v + (1 - b2) * g * g)
            g_prime = g / (1 - self.m_schedule)
            m_prime = m / (1 - m_schedule_next)
            v_prime = v / (1 - b2 ** t)
            m_bar = (1 - momentum_t) * g_prime + momentum_t_1 * m_prime
            w.copy_(w - lr * m_bar / (torch.sqrt(v_prime) + self.epsilon))


@register
class Test(Optimizer):
    """The reference's test optimizer: ``w -= rescale_grad * grad`` (no
    update count, one zero state)."""

    def create_state(self, index, weight):
        return _zeros(weight)

    def update(self, index, weight, grad, state):
        with torch.no_grad():
            weight._data.sub_(self.rescale_grad * grad._data)


# ---------------------------------------------------------------------------
# Updater
# ---------------------------------------------------------------------------

class _StateUnpickler(pickle.Unpickler):
    """Unpickles numpy arrays, builtins and this package's optimizers;
    refuses any other class (an optimizer the JAX package pickled)."""

    _ALLOWED = ("numpy", "builtins", "collections", "copyreg", "_codecs",
                "mxnet_tpu_torch")

    def find_class(self, module, name):
        if module.split(".")[0] in self._ALLOWED:
            return super().find_class(module, name)
        raise MXNetError(
            f"optimizer state file holds {module}.{name}: a state file "
            f"written with dump_optimizer=True pickles its package's "
            f"optimizer class and does not cross packages; write it with "
            f"dump_optimizer=False")


def _pack(s):
    if s is None:
        return None
    if isinstance(s, (tuple, list)):
        return tuple(_pack(x) for x in s)
    t = s._data.detach()
    if t.dtype == torch.bfloat16:
        t = t.float()
    return t.to("cpu", copy=True).numpy()


def _unpack(s):
    if s is None:
        return None
    if isinstance(s, tuple):
        return tuple(_unpack(x) for x in s)
    return NDArray(torch.from_numpy(np.array(s)))


def _copy_into(fresh, loaded):
    if fresh is None:
        return
    if isinstance(fresh, tuple):
        for f, v in zip(fresh, loaded):
            _copy_into(f, v)
        return
    with torch.no_grad():
        fresh._data.copy_(loaded._data)


class Updater:
    """Applies an optimizer to ``(index, grad, weight)``, creating each
    index's state at its first update (reference: optimizer.py Updater).
    Called with lists, it applies them at once (see the module doc)."""

    def __init__(self, optimizer: Optimizer):
        self.optimizer = optimizer
        self.states: Dict = {}
        self.states_synced: Dict = {}
        self._loaded = set()   # indices whose state came from a file

    def __call__(self, index, grad, weight):
        if isinstance(index, (list, tuple)):
            if any(a.stype != "default" for a in list(grad) + list(weight)) \
                    or not self._batch_fused(list(index), list(grad),
                                             list(weight)):
                for i, g, w in zip(index, grad, weight):
                    self._update(i, g, w)
        else:
            self._update(index, grad, weight)

    def _state(self, index, weight):
        """``index``'s state, created at the first update; a state loaded
        from a file is copied into a fresh one (the weight's device and the
        optimizer's dtypes) at its first use."""
        if index not in self.states or index in self._loaded:
            fresh = self.optimizer.create_state_multi_precision(index, weight)
            if index in self._loaded:
                _copy_into(fresh, self.states[index])
                self._loaded.discard(index)
            self.states[index] = fresh
        return self.states[index]

    def _batch_fused(self, indices, grads, weights) -> bool:
        opt = self.optimizer
        if not indices or not opt.multi_tensor:
            return False
        states = [self._state(i, w) for i, w in zip(indices, weights)]
        opt.update_multi_precision_list(indices, weights, grads, states)
        return True

    def _update(self, index, grad, weight):
        if grad.stype != "default":
            grad = NDArray(grad._data)
        w = weight if weight.stype == "default" else NDArray(weight._data)
        self.optimizer.update_multi_precision(index, w, grad,
                                              self._state(index, w))
        if w is not weight:
            weight._data = w._data

    def get_states(self, dump_optimizer=False):
        packed = {k: _pack(v) for k, v in self.states.items()}
        if dump_optimizer:
            return pickle.dumps((packed, self.optimizer))
        return pickle.dumps(packed)

    def set_states(self, states):
        data = _StateUnpickler(io.BytesIO(states)).load()
        if isinstance(data, tuple) and len(data) == 2 and \
                isinstance(data[1], Optimizer):
            data, self.optimizer = data
        if not isinstance(data, dict):
            raise MXNetError("not an optimizer state file")
        self.states = {k: _unpack(v) for k, v in data.items()}
        self._loaded = set(self.states)


def get_updater(optimizer: Optimizer) -> Updater:
    return Updater(optimizer)
