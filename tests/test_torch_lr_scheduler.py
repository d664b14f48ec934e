"""PyTorch port: the learning-rate schedulers and the optimizer's
``lr_scheduler``/``sym`` arguments against the JAX package's.

- Each scheduler (``FactorScheduler`` with its floor,
  ``MultiFactorScheduler``, ``PolyScheduler``, ``CosineScheduler``,
  ``WarmupScheduler`` around a factor and a poly schedule) gives the same
  rate at every update count 0..N, read forward as the optimizer reads it.
- SGD (momentum, wd) with a scheduler matches the reference over N
  updates of the same weights and gradients, through the ``Updater``'s
  list call (the port's ``_foreach`` pass) and its per-parameter call;
  rtol 1e-5.
- ``Optimizer(sym=...)`` takes ``__lr_mult__``/``__wd_mult__`` from the
  symbol's variables, and ``set_wd_mult`` keeps them, as the reference.
"""
import numpy as np
import pytest

import mxnet_tpu as jmx
import mxnet_tpu_torch as tmx

N = 40
TOL = dict(rtol=1e-5, atol=1e-6)


@pytest.fixture(autouse=True)
def _cpu():
    with tmx.cpu():
        yield


SCHEDULES = {
    "factor": lambda m: m.lr_scheduler.FactorScheduler(
        step=4, factor=0.5, stop_factor_lr=1e-3),
    "multifactor": lambda m: m.lr_scheduler.MultiFactorScheduler(
        step=[3, 10, 25], factor=0.3),
    "poly": lambda m: m.lr_scheduler.PolyScheduler(max_update=30,
                                                   base_lr=0.2, pwr=2),
    "cosine": lambda m: m.lr_scheduler.CosineScheduler(
        max_update=30, base_lr=0.2, final_lr=0.01),
    "warmup_factor": lambda m: m.lr_scheduler.WarmupScheduler(
        m.lr_scheduler.FactorScheduler(step=6, factor=0.5),
        warmup_steps=5, warmup_begin_lr=0.01),
    "warmup_poly": lambda m: m.lr_scheduler.WarmupScheduler(
        m.lr_scheduler.PolyScheduler(max_update=30), warmup_steps=8),
}


@pytest.mark.parametrize("name", sorted(SCHEDULES))
def test_schedule_rates_match(name):
    rates = []
    for pkg in (jmx, tmx):
        sched = SCHEDULES[name](pkg)
        sched.base_lr = 0.1 if "poly" not in name else sched.base_lr
        rates.append([sched(t) for t in range(N + 1)])
    np.testing.assert_allclose(rates[1], rates[0], rtol=1e-12)


def _sgd_run(pkg, name, list_call):
    rs = np.random.RandomState(0)
    shapes = [(4, 3), (3,), (2, 2, 2)]
    ws = [pkg.nd.array(rs.randn(*s).astype(np.float32)) for s in shapes]
    opt = pkg.optimizer.create("sgd", learning_rate=0.1, momentum=0.9,
                               wd=0.01, rescale_grad=0.5,
                               lr_scheduler=SCHEDULES[name](pkg),
                               param_idx2name={0: "a_weight", 1: "a_bias",
                                               2: "b_weight"})
    upd = pkg.optimizer.get_updater(opt)
    for step in range(12):
        grs = np.random.RandomState(step + 1)
        gs = [pkg.nd.array(grs.randn(*s).astype(np.float32))
              for s in shapes]
        if list_call:
            upd([0, 1, 2], gs, ws)
        else:
            for i in range(3):
                upd(i, gs[i], ws[i])
    return [w.asnumpy() for w in ws], opt.learning_rate


@pytest.mark.parametrize("list_call", [True, False], ids=["list", "each"])
@pytest.mark.parametrize("name", ["factor", "multifactor", "cosine",
                                  "warmup_factor"])
def test_sgd_with_scheduler_matches(name, list_call):
    jw, jlr = _sgd_run(jmx, name, list_call)
    tw, tlr = _sgd_run(tmx, name, list_call)
    for a, b in zip(tw, jw):
        np.testing.assert_allclose(a, b, **TOL)
    assert tlr == pytest.approx(jlr, rel=1e-12)


def test_optimizer_reads_symbol_mults():
    mults = []
    for pkg in (jmx, tmx):
        with pkg.name.NameManager():
            w = pkg.sym.Variable("fc_weight", lr_mult=2.0, wd_mult=0.5)
            b = pkg.sym.Variable("fc_bias", wd_mult=0.0)
            net = pkg.sym.FullyConnected(pkg.sym.Variable("data"), weight=w,
                                         bias=b, num_hidden=3, name="fc")
        opt = pkg.optimizer.create(
            "sgd", sym=net, param_idx2name={0: "fc_weight", 1: "fc_bias"})
        before = (dict(opt.lr_mult), dict(opt.wd_mult),
                  opt._get_lr(0), opt._get_wd(0), opt._get_wd(1))
        opt.set_wd_mult({})
        mults.append((before, dict(opt.wd_mult)))
    assert mults[1] == mults[0]
    assert mults[1][0][0] == {"fc_weight": 2.0}
