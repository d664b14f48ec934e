"""PyTorch port: ``Module.fit`` and checkpoint files against the JAX
package's.

- The reference's toy MLP fit (``tests/test_module.py`` ``_mlp_sym`` and
  its separable toy data, ``shuffle=False``), from the same numpy
  ``arg_params``, on the fused route (``Executor.fused_step``) and on the
  legacy route (``TPUMX_FUSED_STEP=0`` in both packages:
  ``forward_backward`` + ``update`` through the ``Updater``): parameters
  after every epoch rtol 1e-4; ``score`` equal and ``predict`` to 1e-4;
  ``lr_mult``/``wd_mult`` from ``Variable`` attributes and an
  ``lr_scheduler``; the kvstore route (``local`` store made for a
  ``KVStore`` object).  The port's fused and legacy routes agree bitwise.
- Checkpoint files: ``save_checkpoint`` writes the same bytes
  (``-symbol.json``, ``-0001.params`` and its manifest) in both packages,
  and each loads the other's; ``Module.save_checkpoint``/``Module.load``
  with optimizer states; ``set_params`` from numpy-built dicts.
- The refusals (several contexts, partition rules, fault-tolerant
  checkpoints, ``ImageRecordIter``'s ``ImageIter`` route).
"""
import os
import types

import numpy as np
import pytest
import torch

import mxnet_tpu as jmx
import mxnet_tpu_torch as tmx
from mxnet_tpu_torch.base import MXNetError

TOL = dict(rtol=1e-4, atol=1e-6)


@pytest.fixture(autouse=True)
def _cpu():
    with tmx.cpu():
        yield


def _mlp_sym(pkg, nh=32, classes=4, mults=False):
    sym = pkg.sym
    with pkg.name.NameManager():
        data = sym.Variable("data")
        label = sym.Variable("softmax_label")
        w1 = sym.Variable("fc1_weight", lr_mult=0.5) if mults else None
        b2 = sym.Variable("fc2_bias", wd_mult=3.0) if mults else None
        kw1 = {"weight": w1} if mults else {}
        kw2 = {"bias": b2} if mults else {}
        h = sym.Activation(sym.FullyConnected(data, num_hidden=nh,
                                              name="fc1", **kw1),
                           act_type="relu")
        out = sym.FullyConnected(h, num_hidden=classes, name="fc2", **kw2)
        return sym.SoftmaxOutput(out, label, name="softmax")


def _toy(n=256, dim=16, classes=4, seed=0):
    r = np.random.RandomState(seed)
    Y = r.randint(0, classes, n).astype(np.float32)
    X = r.rand(n, dim).astype(np.float32) * 0.3
    for c in range(classes):
        X[Y == c, c] += 1.0
    return X, Y


def _params(dim=16, nh=32, classes=4, seed=1):
    r = np.random.RandomState(seed)
    return {"fc1_weight": (r.randn(nh, dim) * 0.1).astype(np.float32),
            "fc1_bias": (r.randn(nh) * 0.1).astype(np.float32),
            "fc2_weight": (r.randn(classes, nh) * 0.1).astype(np.float32),
            "fc2_bias": (r.randn(classes) * 0.1).astype(np.float32)}


def _fit(pkg, epochs=3, mults=False, optimizer_params=None, kvstore="local",
         batch=32):
    X, Y = _toy()
    it = pkg.io.NDArrayIter(X, Y, batch_size=batch, shuffle=False)
    mod = pkg.mod.Module(_mlp_sym(pkg, mults=mults), context=pkg.cpu())
    per_epoch = []

    def keep(epoch, sym, arg, aux):
        per_epoch.append({k: v.asnumpy() for k, v in arg.items()})

    params = {k: pkg.nd.array(v) for k, v in _params().items()}
    if kvstore == "store":
        kvstore = pkg.kv.create("local")
    mod.fit(it, num_epoch=epochs, optimizer="sgd",
            optimizer_params=optimizer_params or {"learning_rate": 0.5},
            arg_params=params, kvstore=kvstore, epoch_end_callback=keep)
    return mod, it, per_epoch


def _same_fit(legacy, monkeypatch, **kw):
    if legacy:
        monkeypatch.setenv("TPUMX_FUSED_STEP", "0")
    jmod, jit, jep = _fit(jmx, **kw)
    tmod, tit, tep = _fit(tmx, **kw)
    assert len(tep) == len(jep)
    for j, t in zip(jep, tep):
        assert sorted(t) == sorted(j)
        for k in j:
            np.testing.assert_allclose(t[k], j[k], **TOL, err_msg=k)
    return jmod, jit, tmod, tit


@pytest.mark.parametrize("legacy", [False, True], ids=["fused", "legacy"])
def test_fit_matches_per_epoch(legacy, monkeypatch):
    jmod, jit, tmod, tit = _same_fit(legacy, monkeypatch)
    assert (tmod._fused_step_count > 0) == (not legacy)
    assert (jmod._fused_step_count > 0) == (not legacy)
    assert dict(tmod.score(tit, "acc")) == dict(jmod.score(jit, "acc"))
    np.testing.assert_allclose(tmod.predict(tit).asnumpy(),
                               jmod.predict(jit).asnumpy(), **TOL)


@pytest.mark.parametrize("legacy", [False, True], ids=["fused", "legacy"])
def test_fit_symbol_mults_and_scheduler(legacy, monkeypatch):
    def params(pkg):
        return {"learning_rate": 0.3, "momentum": 0.9, "wd": 0.01,
                "lr_scheduler": pkg.lr_scheduler.FactorScheduler(
                    step=5, factor=0.5)}

    if legacy:
        monkeypatch.setenv("TPUMX_FUSED_STEP", "0")
    jmod, _, jep = _fit(jmx, mults=True, optimizer_params=params(jmx))
    tmod, _, tep = _fit(tmx, mults=True, optimizer_params=params(tmx))
    for j, t in zip(jep, tep):
        for k in j:
            np.testing.assert_allclose(t[k], j[k], **TOL, err_msg=k)
    assert tmod._optimizer.lr_mult == jmod._optimizer.lr_mult == \
        {"fc1_weight": 0.5}
    assert tmod._optimizer.wd_mult == jmod._optimizer.wd_mult
    assert tmod._optimizer.learning_rate == \
        pytest.approx(jmod._optimizer.learning_rate)


def test_fit_through_a_kvstore(monkeypatch):
    _same_fit(False, monkeypatch, kvstore="store", epochs=2)


def test_port_routes_agree_bitwise(monkeypatch):
    _, _, fused = _fit(tmx, epochs=2)
    monkeypatch.setenv("TPUMX_FUSED_STEP", "0")
    _, _, legacy = _fit(tmx, epochs=2)
    for f, g in zip(fused, legacy):
        for k in f:
            np.testing.assert_array_equal(f[k], g[k])


def test_forward_backward_update_and_outputs():
    X, Y = _toy()
    for pkg in (jmx, tmx):
        it = pkg.io.NDArrayIter(X, Y, batch_size=32)
        mod = pkg.mod.Module(_mlp_sym(pkg), context=pkg.cpu())
        mod.bind(it.provide_data, it.provide_label, inputs_need_grad=True)
        mod.init_params(arg_params={k: pkg.nd.array(v)
                                    for k, v in _params().items()})
        mod.init_optimizer(optimizer_params={"learning_rate": 0.1})
        batch = next(iter(it))
        mod.forward_backward(batch)
        grads = mod.get_input_grads()[0].asnumpy()
        mod.update()
        out = mod.get_outputs()[0].asnumpy()
        shapes = mod.output_shapes
        if pkg is jmx:
            ref = (grads, out, shapes, mod.get_params()[0])
    np.testing.assert_allclose(grads, ref[0], **TOL)
    np.testing.assert_allclose(out, ref[1], **TOL)
    assert shapes == ref[2]
    for k, v in ref[3].items():
        np.testing.assert_allclose(mod.get_params()[0][k].asnumpy(),
                                   v.asnumpy(), **TOL)


def _trained(pkg):
    mod = pkg.mod.Module(_mlp_sym(pkg), context=pkg.cpu())
    mod.bind([("data", (32, 16))], [("softmax_label", (32,))])
    mod.init_params(arg_params={k: pkg.nd.array(v)
                                for k, v in _params().items()})
    return mod


def test_checkpoint_files_are_the_same_bytes(tmp_path):
    jmod, tmod = _trained(jmx), _trained(tmx)
    jp, tp = str(tmp_path / "j"), str(tmp_path / "t")
    jmx.model.save_checkpoint(jp, 1, jmod.symbol, *jmod.get_params())
    tmx.model.save_checkpoint(tp, 1, tmod.symbol, *tmod.get_params())
    for suffix in ("-symbol.json", "-0001.params"):
        with open(jp + suffix, "rb") as a, open(tp + suffix, "rb") as b:
            assert a.read() == b.read(), suffix
    with open(jp + "-0001.params.manifest.json") as a, \
            open(tp + "-0001.params.manifest.json") as b:
        ja, tb = a.read(), b.read()
    assert ja.replace("j-0001", "t-0001") == tb
    # each package loads the other's files
    for src, pkg in ((jp, tmx), (tp, jmx)):
        sym, arg, aux = pkg.model.load_checkpoint(src, 1)
        assert sym.tojson() == tmod.symbol.tojson()
        for k, v in _params().items():
            np.testing.assert_array_equal(arg[k].asnumpy(), v)
        assert aux == {}
    # a corrupt file is refused before it is read
    with open(tp + "-0001.params", "r+b") as f:
        f.seek(40)
        f.write(b"\xff")
    with pytest.raises(MXNetError, match="checksum"):
        tmx.model.load_checkpoint(tp, 1)


def test_module_checkpoint_and_optimizer_states(tmp_path):
    X, Y = _toy()
    it = tmx.io.NDArrayIter(X, Y, batch_size=32)
    mod = tmx.mod.Module(_mlp_sym(tmx), context=tmx.cpu())
    mod.fit(it, num_epoch=1, optimizer_params={"learning_rate": 0.1,
                                               "momentum": 0.9},
            arg_params={k: tmx.nd.array(v) for k, v in _params().items()})
    prefix = str(tmp_path / "m")
    mod.save_checkpoint(prefix, 1, save_optimizer_states=True)
    cb_prefix = str(tmp_path / "cb")
    tmx.callback.module_checkpoint(mod, cb_prefix)(0)
    assert os.path.exists(cb_prefix + "-0001.params")
    mod2 = tmx.mod.Module.load(prefix, 1, load_optimizer_states=True,
                               context=tmx.cpu())
    mod2.bind(it.provide_data, it.provide_label)
    mod2.init_optimizer(optimizer_params={"learning_rate": 0.1,
                                          "momentum": 0.9})
    assert sorted(mod2._updater.states) == sorted(mod._updater.states)
    for k, v in mod._updater.states.items():
        np.testing.assert_array_equal(mod2._updater.states[k].asnumpy(),
                                      v.asnumpy())
    it.reset()
    batch = next(iter(it))
    mod.forward(batch, is_train=False)
    mod2.forward(batch, is_train=False)
    np.testing.assert_array_equal(mod2.get_outputs()[0].asnumpy(),
                                  mod.get_outputs()[0].asnumpy())
    # the reference reads the port's Module checkpoint
    jmod = jmx.mod.Module.load(prefix, 1, context=jmx.cpu())
    jmod.bind(it.provide_data, it.provide_label, for_training=False)
    jmod.forward(jmx.io.DataBatch([jmx.nd.array(batch.data[0].asnumpy())]),
                 is_train=False)
    np.testing.assert_allclose(jmod.get_outputs()[0].asnumpy(),
                               mod.get_outputs()[0].asnumpy(), **TOL)


def test_set_params_from_numpy_and_save_load_params(tmp_path):
    mod = _trained(tmx)
    new = {k: np.full(v.shape, 0.25, np.float32) for k, v in _params().items()}
    mod.set_params(new, {})
    for k, v in mod.get_params()[0].items():
        np.testing.assert_array_equal(v.asnumpy(), new[k])
    path = str(tmp_path / "p.params")
    mod.save_params(path)
    other = _trained(tmx)
    other.load_params(path)
    for k, v in other.get_params()[0].items():
        np.testing.assert_array_equal(v.asnumpy(), new[k])
    with pytest.raises(MXNetError, match="shape"):
        mod.set_params({"fc1_weight": np.zeros((2, 2), np.float32)}, {},
                       allow_missing=True)
    with pytest.raises(MXNetError, match="not present"):
        mod.set_params({"fc1_weight": new["fc1_weight"]}, {})


def test_feedforward_and_score_callbacks():
    X, Y = _toy()
    ff = tmx.model.FeedForward(_mlp_sym(tmx), ctx=tmx.cpu(), num_epoch=2,
                               learning_rate=0.5,
                               arg_params={k: tmx.nd.array(v)
                                           for k, v in _params().items()})
    ff.fit(tmx.io.NDArrayIter(X, Y, batch_size=32))
    assert ff.predict(X).shape == (256, 4)
    assert ff.score(tmx.io.NDArrayIter(X, Y, batch_size=32)) > 0.9


def test_refusals(monkeypatch, caplog, tmp_path):
    """What the port took up from its refusals: several contexts,
    ``group2ctxs``, ``TPUMX_MP_DEVICES`` and ``shard_rules`` are accepted.
    In a world of one process a mesh of two devices cannot be made: the
    module logs it and trains on its first context by the legacy route,
    to the reference's numbers (which trains over two virtual devices).
    ``fit(checkpoint_dir=...)`` writes valid checkpoints (the rest of the
    fault-tolerant fit: ``tests/test_torch_checkpoint.py``).  What stays
    refused keeps its refusal."""
    import logging

    sym = _mlp_sym(tmx)
    X, Y = _toy()
    got = {}
    for pkg in (jmx, tmx):
        it = pkg.io.NDArrayIter(X, Y, batch_size=32)
        mod = pkg.mod.Module(_mlp_sym(pkg), context=[pkg.cpu(0),
                                                     pkg.cpu(1)])
        with caplog.at_level(logging.WARNING):
            mod.fit(it, num_epoch=1, kvstore="tpu_sync",
                    optimizer_params={"learning_rate": 0.5},
                    arg_params={k: pkg.nd.array(v)
                                for k, v in _params().items()})
        got[pkg] = (mod._fused_step_count,
                    {k: v.asnumpy() for k, v in mod.get_params()[0].items()})
    assert got[jmx][0] == 8 and got[tmx][0] == 0
    assert any("mesh {'dp': 2} has 2 devices but the world has 1" in
               r.message for r in caplog.records)
    for k in got[jmx][1]:
        np.testing.assert_allclose(got[tmx][1][k], got[jmx][1][k], **TOL,
                                   err_msg=k)
    tmx.mod.Module(sym, context=tmx.cpu(), group2ctxs={"a": tmx.cpu()})
    monkeypatch.setenv("TPUMX_MP_DEVICES", "2")
    mod = tmx.mod.Module(sym, context=tmx.cpu())
    caplog.clear()
    with caplog.at_level(logging.WARNING):
        mod.bind([("data", (8, 16))], [("softmax_label", (8,))],
                 shard_rules=[(r"fc1_weight", ("mp", None))])
    assert mod._shard_rules == [(r"fc1_weight", ("mp", None))]
    assert mod._exec._spmd_mesh is None
    assert any("'mp': 2" in r.message for r in caplog.records)
    monkeypatch.delenv("TPUMX_MP_DEVICES")
    mod = tmx.mod.Module(sym, context=tmx.cpu())
    it = tmx.io.NDArrayIter(X, Y, batch_size=32)
    ckdir = str(tmp_path / "ck")
    assert mod.fit(it, num_epoch=1, checkpoint_dir=ckdir,
                   checkpoint_every=3) is True
    manager = tmx.checkpoint.CheckpointManager(ckdir)
    steps = [s for s, _ in manager.list()]
    assert steps and all(s % 3 == 0 for s in steps)
    info, arrays, opt_tree = manager.restore()
    assert sorted(arrays["params"]) == sorted(mod._param_names)
    assert info.meta["global_step"] == info.step
    assert manager.validate(info.path) is not None
    # the RecordIO iterators' ImageIter route is ported: a missing file
    # raises the reference's IO error there, nothing falls back
    for make in (lambda: tmx.io.ImageRecordIter(path_imgrec="x",
                                                use_native=False),
                 lambda: tmx.io.ImageRecordIter(path_imgrec="x",
                                                data_shape=(1, 28, 28))):
        with pytest.raises(FileNotFoundError):
            make()
    # shard_data_batch cuts this rank's block (rank 1 of dp=2 here)
    mesh = types.SimpleNamespace(axis_names=("dp",), shape={"dp": 2},
                                 axis_index=lambda a: 1)
    batch = next(iter(tmx.io.NDArrayIter(X[:8], Y[:8], batch_size=8)))
    tmx.io.shard_data_batch(batch, mesh)
    np.testing.assert_array_equal(batch.data[0].asnumpy(), X[4:8])
    np.testing.assert_array_equal(batch.label[0].asnumpy(), Y[4:8])
    with pytest.raises(MXNetError, match="not an axis of the mesh"):
        tmx.io.shard_data_batch(batch, mesh, axis="mp")
    if not torch.cuda.is_available():
        # the default context is gpu(0): without CUDA it names the way out
        monkeypatch.setattr(tmx.context.Context._tls, "stack", [])
        with pytest.raises(MXNetError, match="cpu"):
            tmx.mod.Module(sym)


def test_fixed_params_shared_module_and_monitor():
    """``fixed_param_names`` (not updated; same trajectory as the
    reference), ``shared_module`` (parameters copied at bind), a monitor
    (the legacy route is taken), ``reshape`` and ``iter_predict``."""
    X, Y = _toy()
    got = []
    for pkg in (jmx, tmx):
        it = pkg.io.NDArrayIter(X, Y, batch_size=32)
        mod = pkg.mod.Module(_mlp_sym(pkg), context=pkg.cpu(),
                             fixed_param_names=["fc1_weight"])
        mod.fit(it, num_epoch=2, optimizer_params={"learning_rate": 0.5},
                arg_params={k: pkg.nd.array(v)
                            for k, v in _params().items()})
        got.append({k: v.asnumpy() for k, v in mod.get_params()[0].items()})
    np.testing.assert_array_equal(got[1]["fc1_weight"],
                                  _params()["fc1_weight"])
    for k in got[0]:
        np.testing.assert_allclose(got[1][k], got[0][k], **TOL, err_msg=k)

    shared = tmx.mod.Module(_mlp_sym(tmx), context=tmx.cpu())
    shared.bind([("data", (16, 16))], [("softmax_label", (16,))],
                shared_module=mod)
    for k, v in mod.get_params()[0].items():
        np.testing.assert_array_equal(shared._exec.arg_dict[k].asnumpy(),
                                      v.asnumpy())

    class Monitor:
        def __init__(self):
            self.names = []

        def install(self, exe):
            exe.set_monitor_callback(lambda n, a: self.names.append(n))

        def tic(self):
            pass

        def toc_print(self):
            pass

    mon = Monitor()
    it = tmx.io.NDArrayIter(X, Y, batch_size=32)
    mod = tmx.mod.Module(_mlp_sym(tmx), context=tmx.cpu())
    mod.fit(it, num_epoch=1, monitor=mon,
            optimizer_params={"learning_rate": 0.1})
    assert mod._fused_step_count == 0 and len(mon.names) == 8
    mod.reshape([("data", (8, 16))], [("softmax_label", (8,))])
    assert mod.data_shapes == [("data", (8, 16))]
    it8 = tmx.io.NDArrayIter(X[:20], Y[:20], batch_size=8)
    parts = [out[0].asnumpy() for out, _, _ in mod.iter_predict(it8)]
    whole = mod.predict(it8).asnumpy()
    assert whole.shape == (20, 4)
    np.testing.assert_array_equal(np.concatenate(parts), whole)
