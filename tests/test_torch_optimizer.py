"""PyTorch port: the optimizers, their update rules and the ``Updater``
against the JAX package's.

Each optimizer (``SGD`` with and without momentum, ``NAG``,
``Adam``, ``AdaGrad``, ``RMSProp`` plain and centered with
``clip_weights``, ``Signum`` with and without momentum; and, in
``test_remaining_optimizers_match_jax``, four updates of ``FTML``,
``LBSGD``, ``DCASGD``, ``SGLD`` (its noise within the sampling tolerance
rtol 1e-4 / atol 1e-4), ``AdaDelta``, ``Ftrl``, ``Adamax``, ``Nadam`` and
``Test``, their states loaded back in either package) runs three updates
of the same weights from the same gradients (numpy, from a seed) in both
packages, through ``Updater(index, grad, weight)``, with ``rescale_grad``,
``clip_gradient``, ``wd`` and per-name ``lr_mult``/``wd_mult`` (one
parameter's through ``param_dict``), float32 and with ``multi_precision``
on float16 weights (the float32 masters compared; each package's float16
weight is its master rounded).  Tolerance rtol 1e-5 / atol 1e-6 on the
weights and every state.  The port's list call (one ``torch._foreach_*``
pass for SGD, the per-parameter loop for the others) is bit-equal to its
per-parameter loop; ``get_states`` written by
either package loads in the other (``dump_optimizer=True`` files of the
JAX package are refused).  The update rules of ``ops/optimizer_ops.py``
are held against the reference's at the same tolerance.
"""
import copy
import types

import numpy as np
import pytest
import torch

import mxnet_tpu as jmx
import mxnet_tpu_torch as tmx
from mxnet_tpu.ops import optimizer_ops as jops
from mxnet_tpu_torch.base import MXNetError
from mxnet_tpu_torch.ops import optimizer_ops as tops

TOL = dict(rtol=1e-5, atol=1e-6)
SHAPES = [(4, 5), (5,), (2, 3, 2)]
NAMES = {0: "dense0_weight", 1: "dense0_bias", 2: "conv0_weight"}
CASES = {
    "sgd": ("sgd", {}),
    "sgd_momentum": ("sgd", {"momentum": 0.9}),
    "nag": ("nag", {"momentum": 0.9}),
    "adam": ("adam", {"learning_rate": 0.01}),
    "adagrad": ("adagrad", {}),
    "rmsprop": ("rmsprop", {}),
    "rmsprop_centered": ("rmsprop", {"centered": True,
                                     "clip_weights": 0.5}),
    "signum": ("signum", {}),
    "signum_plain": ("signum", {"momentum": 0.0, "wd_lh": 0.01}),
}
LIST_CASES = {"sgd", "sgd_momentum", "nag", "adam", "adagrad"}
# the rest of the reference's optimizers (``test_remaining_optimizers_*``)
MORE_CASES = {
    "ftml": ("ftml", {}),
    "lbsgd": ("lbsgd", {"momentum": 0.9, "batch_scale": 4,
                        "warmup_epochs": 1, "updates_per_epoch": 8}),
    "lbsgd_lars": ("lbsgd", {"momentum": 0.9, "warmup_strategy": "lars"}),
    "dcasgd": ("dcasgd", {}),
    "dcasgd_momentum": ("dcasgd", {"momentum": 0.9}),
    "sgld": ("sgld", {}),
    "adadelta": ("adadelta", {}),
    "ftrl": ("ftrl", {}),
    "adamax": ("adamax", {}),
    "nadam": ("nadam", {}),
    "test": ("test", {}),
}
# SGLD's noise: the reference's normal draws, within the repo's sampling
# tolerance (tests/test_torch_random.py)
SAMPLING_TOL = dict(rtol=1e-4, atol=1e-4)


@pytest.fixture(autouse=True)
def _cpu():
    with tmx.cpu():
        yield


def _arrays(seed, dtype=np.float32):
    rs = np.random.RandomState(seed)
    return [rs.randn(*s).astype(dtype) for s in SHAPES]


def _optimizer(mx, case, mp):
    name, kw = CASES[case] if case in CASES else MORE_CASES[case]
    kw = dict({"learning_rate": 0.1}, **kw)
    param_dict = {2: types.SimpleNamespace(lr_mult=2.0, wd_mult=0.5)}
    opt = mx.optimizer.create(name, rescale_grad=0.5, clip_gradient=0.8,
                              wd=0.01, param_idx2name=NAMES,
                              multi_precision=mp, param_dict=param_dict,
                              **kw)
    opt.set_lr_mult({"dense0_bias": 0.5})
    opt.set_wd_mult({})   # zero for the bias, by name
    return opt


def _flat(state):
    if state is None:
        return []
    if isinstance(state, (tuple, list)):
        return [a for s in state for a in _flat(s)]
    return [state]


def _np32(a):
    return a.asnumpy().astype(np.float32)


def _run(mx, case, mp, steps=3, updater=None, weights=None, seed=0):
    """Three updates through ``Updater(index, grad, weight)``, one index at
    a time; (weights, updater)."""
    dtype = np.float16 if mp else np.float32
    if updater is None:
        updater = mx.optimizer.get_updater(_optimizer(mx, case, mp))
    if weights is None:
        weights = [mx.nd.array(w, dtype=dtype.__name__)
                   for w in _arrays(1, dtype)]
    for step in range(steps):
        grads = _arrays(10 + seed + step, dtype)
        for i, (w, g) in enumerate(zip(weights, grads)):
            updater(i, mx.nd.array(g, dtype=dtype.__name__), w)
    return weights, updater


def _compare(jw, jupd, tw, tupd, tol=TOL):
    for i in range(len(SHAPES)):
        js, ts = _flat(jupd.states.get(i)), _flat(tupd.states.get(i))
        assert len(js) == len(ts)
        for a, b in zip(js, ts):
            np.testing.assert_allclose(_np32(b), _np32(a), **tol)
        if js and js[0].dtype == np.float32 and jw[i].dtype == np.float16:
            # multi-precision: the master is compared; each package's
            # float16 weight is its own master rounded
            for w, m in ((jw[i], js[0]), (tw[i], ts[0])):
                np.testing.assert_array_equal(
                    w.asnumpy(), m.asnumpy().astype(np.float16))
        else:
            np.testing.assert_allclose(_np32(tw[i]), _np32(jw[i]), **tol)


@pytest.mark.parametrize("mp", [False, True], ids=["f32", "mp_f16"])
@pytest.mark.parametrize("case", sorted(CASES))
def test_optimizer_matches_jax(case, mp):
    jw, jupd = _run(jmx, case, mp)
    tw, tupd = _run(tmx, case, mp)
    _compare(jw, jupd, tw, tupd)
    assert tupd.optimizer.num_update == jupd.optimizer.num_update == 3


@pytest.mark.parametrize("mp", [False, True], ids=["f32", "mp_f16"])
@pytest.mark.parametrize("case", sorted(LIST_CASES))
def test_foreach_path_bit_equal_to_loop(case, mp):
    """The list call (one _foreach pass for SGD, the loop for the others)
    against the per-parameter loop, in the port: the same bits."""
    dtype = np.float16 if mp else np.float32
    loop_w, loop_u = _run(tmx, case, mp)
    upd = tmx.optimizer.get_updater(_optimizer(tmx, case, mp))
    assert upd.optimizer.multi_tensor == case.startswith("sgd")
    ws = [tmx.nd.array(w, dtype=dtype.__name__) for w in _arrays(1, dtype)]
    for step in range(3):
        gs = [tmx.nd.array(g, dtype=dtype.__name__)
              for g in _arrays(10 + step, dtype)]
        upd(list(range(len(ws))), gs, ws)
    for i in range(len(ws)):
        assert torch.equal(ws[i]._data, loop_w[i]._data), i
        for a, b in zip(_flat(upd.states[i]), _flat(loop_u.states[i])):
            assert torch.equal(a._data, b._data), i


@pytest.mark.parametrize("direction", ["jax_to_port", "port_to_jax"])
@pytest.mark.parametrize("case", ["sgd_momentum", "adam", "rmsprop_centered"])
def test_updater_states_cross_packages(case, direction):
    """States after two updates, saved by one package and loaded by the
    other, then one more update on both sides."""
    src, dst = (jmx, tmx) if direction == "jax_to_port" else (tmx, jmx)
    sw, supd = _run(src, case, False, steps=2)
    blob = supd.get_states(dump_optimizer=False)
    dupd = dst.optimizer.get_updater(_optimizer(dst, case, False))
    dupd.set_states(blob)
    # the loaded optimizer has not counted the first two updates: Adam's
    # bias correction needs the counts carried over, as a user restores
    # them with the optimizer
    dupd.optimizer._index_update_count = dict(
        supd.optimizer._index_update_count)
    dw = [dst.nd.array(w.asnumpy()) for w in sw]
    _run(src, case, False, steps=1, updater=supd, weights=sw, seed=2)
    _run(dst, case, False, steps=1, updater=dupd, weights=dw, seed=2)
    if src is jmx:
        _compare(sw, supd, dw, dupd)
    else:
        _compare(dw, dupd, sw, supd)


@pytest.mark.parametrize("mp", [False, True], ids=["f32", "mp_f16"])
@pytest.mark.parametrize("case", sorted(MORE_CASES))
def test_remaining_optimizers_match_jax(case, mp):
    """FTML, LBSGD (warm-up and LARS), DCASGD (with and without momentum),
    SGLD, AdaDelta, Ftrl, Adamax, Nadam and Test: four updates in both
    packages from one seed of both streams (SGLD's noise), weights and
    states compared; then the port's states written by ``get_states``
    load in a fresh updater of either package with the same values."""
    jmx.random.seed(11)
    tmx.random.seed(11)
    jw, jupd = _run(jmx, case, mp, steps=4)
    tw, tupd = _run(tmx, case, mp, steps=4)
    _compare(jw, jupd, tw, tupd,
             tol=SAMPLING_TOL if case == "sgld" else TOL)
    assert type(tupd.optimizer).__name__ == type(jupd.optimizer).__name__
    blob = tupd.get_states(dump_optimizer=False)
    for mx in (jmx, tmx):
        other = mx.optimizer.get_updater(_optimizer(mx, case, mp))
        other.set_states(blob)
        assert sorted(other.states) == sorted(tupd.states)
        for i in tupd.states:
            a, b = _flat(other.states[i]), _flat(tupd.states[i])
            assert len(a) == len(b)
            for x, y in zip(a, b):
                np.testing.assert_array_equal(_np32(x), _np32(y))


def test_sgld_noise_key_for_key():
    """SGLD draws its noise with one key of the stream an update, the
    reference's key: the keys' bits equal, and each update's noise (the
    weight moved with a zero gradient, lr 1) is the reference's normal
    draw within the sampling tolerance."""
    jmx.random.seed(5)
    tmx.random.seed(5)
    for _ in range(3):
        np.testing.assert_array_equal(tmx.random.next_key(),
                                      np.asarray(jmx.random.next_key()))
    moved = {}
    for mx in (jmx, tmx):
        opt = mx.optimizer.create("sgld", learning_rate=1.0)
        w = mx.nd.array(np.zeros((64,), np.float32))
        g = mx.nd.array(np.zeros((64,), np.float32))
        moved[mx] = []
        for i in range(3):
            opt.update(0, w, g, None)
            moved[mx].append(w.asnumpy().copy())
    for a, b in zip(moved[jmx], moved[tmx]):
        np.testing.assert_allclose(b, a, **SAMPLING_TOL)
    assert not np.allclose(moved[tmx][0], moved[tmx][1])
    jmx.random.seed(5)
    tmx.random.seed(5)
    for _ in range(6):
        np.testing.assert_array_equal(tmx.random.next_key(),
                                      np.asarray(jmx.random.next_key()))


def test_dump_optimizer_files(tmp_path):
    _, jupd = _run(jmx, "sgd_momentum", False, steps=1)
    with pytest.raises(MXNetError, match="dump_optimizer"):
        tmx.optimizer.get_updater(_optimizer(tmx, "sgd", False)).set_states(
            jupd.get_states(dump_optimizer=True))
    tw, tupd = _run(tmx, "sgd_momentum", False, steps=1)
    blob = tupd.get_states(dump_optimizer=True)
    other = tmx.optimizer.get_updater(_optimizer(tmx, "sgd", False))
    other.set_states(blob)
    assert isinstance(other.optimizer, tmx.optimizer.SGD)
    assert other.optimizer.momentum == 0.9


def test_optimizer_refusals():
    # a scheduler is taken now (its base_lr set from learning_rate, as the
    # reference's); every reference optimizer is made, an unknown name is
    # refused
    sched = tmx.lr_scheduler.FactorScheduler(step=1, factor=0.5)
    opt = tmx.optimizer.SGD(learning_rate=0.5, lr_scheduler=sched)
    assert sched.base_lr == 0.5 and opt.learning_rate == 0.5
    assert isinstance(tmx.optimizer.create("ftml"), tmx.optimizer.FTML)
    with pytest.raises(MXNetError, match="unknown optimizer"):
        tmx.optimizer.create("no_such_optimizer")
    opt = tmx.optimizer.create("SGD", learning_rate=0.5)
    assert opt.learning_rate == 0.5
    opt.set_learning_rate(0.25)
    assert opt.learning_rate == 0.25


# ---------------------------------------------------------------------------
# ops/optimizer_ops.py
# ---------------------------------------------------------------------------

RULES = {
    "sgd_update": (1, 0, dict(lr=0.1, wd=0.01, rescale_grad=0.5,
                              clip_gradient=0.3)),
    "sgd_mom_update": (1, 1, dict(lr=0.1, momentum=0.9, wd=0.01,
                                  rescale_grad=0.5, clip_gradient=-1.0)),
    "mp_sgd_update": (1, 1, dict(lr=0.1, wd=0.01, clip_gradient=0.3)),
    "mp_sgd_mom_update": (1, 2, dict(lr=0.1, momentum=0.9, wd=0.01)),
    "adam_update": (1, 2, dict(lr=0.01, wd=0.01, rescale_grad=0.5,
                               clip_gradient=0.3)),
    "rmsprop_update": (1, 1, dict(lr=0.01, wd=0.01, clip_weights=0.5)),
    "rmspropalex_update": (1, 3, dict(lr=0.01, wd=0.01,
                                      clip_gradient=0.3)),
    "signsgd_update": (1, 0, dict(lr=0.1, wd=0.01, rescale_grad=0.5)),
    "signum_update": (1, 1, dict(lr=0.1, momentum=0.9, wd=0.01,
                                 wd_lh=0.01)),
}


@pytest.mark.parametrize("rule", sorted(RULES))
def test_update_rules_match_jax(rule):
    _, n_states, kw = RULES[rule]
    rs = np.random.RandomState(3)
    w = rs.randn(6, 7).astype(np.float32)
    g = rs.randn(6, 7).astype(np.float32)
    states = [np.abs(rs.randn(6, 7)).astype(np.float32)
              for _ in range(n_states)]
    if rule == "rmspropalex_update":
        states[0] += 1.0    # n above g^2: a real square root
        states[1] *= 0.1
    if rule.startswith("mp_"):
        # the master weight is the last state; the weight its float16 copy
        states[-1] = w.copy()
        w = w.astype(np.float16)
        g = g.astype(np.float16)
    want = getattr(jops, rule)(w, g, *states, **kw)
    want = want if isinstance(want, tuple) else (want,)
    tw = torch.from_numpy(w.copy())
    tstates = [torch.from_numpy(s.copy()) for s in states]
    got = getattr(tops, rule)(tw, torch.from_numpy(g), *tstates, **kw)
    got = got if isinstance(got, tuple) else (got,)
    assert got[0] is tw    # in place
    assert len(got) == len(want)
    for a, b in zip(want, got):
        np.testing.assert_allclose(b.float().numpy(),
                                   np.asarray(a, np.float32), **TOL)


def test_optimizer_deepcopy_keeps_params_out():
    opt = _optimizer(tmx, "sgd", False)
    state = opt.__getstate__()
    assert state["param_dict"] == {} and opt.param_dict
    assert copy.copy(opt).lr == opt.lr
