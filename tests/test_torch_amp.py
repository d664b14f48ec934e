"""PyTorch port: automatic mixed precision (``amp/``, ``symbol/rewrite.py``,
loss scaling in ``Executor.fused_step``, ``Module`` under ``TPUMX_AMP``,
Gluon ``amp.init``) against the JAX package's.

- ``convert_symbol`` gives the reference's graph JSON (and the checked-in
  goldens) for the models of ``tests/test_amp_golden.py``, bf16 and fp16;
  ``remove_amp_cast`` gives the original JSON back.
- The ``TPUMX_AMP*`` grammar, refusals included, and
  ``LossScaler.next_state`` over a scripted finite/overflow sequence,
  bit for bit.
- ``Module.fit`` of the reference's toy MLP (10 fused steps from the same
  numpy parameters): bf16 with sgd and adam within rtol 0.05, fp16 at a
  static scale of 1024 within rtol 0.08, fp16 dynamic with the
  reference's final ``(scale, good_steps)``, AMP off bitwise the port's
  f32 fit; the BatchNorm net's f32 running statistics; an overflow
  batch skipped; the legacy route's warning; checkpoints without casts;
  ``TPUMX_AMP=1`` binding the converted graph.
- Gluon ``amp.init``: parameter dtypes, the forward, and three
  ``multi_precision`` Trainer steps against the reference's.
"""
import json
import logging

import numpy as np
import pytest
import torch

import mxnet_tpu as jmx
import mxnet_tpu_torch as tmx
from mxnet_tpu import amp as jamp
from mxnet_tpu_torch import amp as tamp
from mxnet_tpu_torch.base import MXNetError

import test_amp_golden as golden

LOWP = 0.05


@pytest.fixture(autouse=True)
def _cpu():
    with tmx.cpu():
        yield


def _mlp_sym(pkg, nh=16, classes=4, bn=False):
    sym = pkg.sym
    with pkg.name.NameManager():
        data = sym.Variable("data")
        label = sym.Variable("softmax_label")
        h = sym.FullyConnected(data, num_hidden=nh, name="fc1")
        if bn:
            h = sym.BatchNorm(h, name="bn1")
        h = sym.Activation(h, act_type="relu", name="relu1")
        out = sym.FullyConnected(h, num_hidden=classes, name="fc2")
        return sym.SoftmaxOutput(out, label, name="softmax")


def _toy(n=320, dim=8, classes=4):
    """The reference's ``tests/test_amp.py`` toy data."""
    r = np.random.RandomState(0)
    Y = r.randint(0, classes, n).astype(np.float32)
    X = r.rand(n, dim).astype(np.float32) * 0.3
    for c in range(classes):
        X[Y == c, c] += 1.0
    return X, Y


def _params(dim=8, nh=16, classes=4, bn=False):
    r = np.random.RandomState(1)
    arg = {"fc1_weight": (r.randn(nh, dim) * 0.3).astype(np.float32),
           "fc1_bias": (r.randn(nh) * 0.1).astype(np.float32),
           "fc2_weight": (r.randn(classes, nh) * 0.3).astype(np.float32),
           "fc2_bias": (r.randn(classes) * 0.1).astype(np.float32)}
    aux = {}
    if bn:
        arg["bn1_gamma"] = np.ones(nh, np.float32)
        arg["bn1_beta"] = np.zeros(nh, np.float32)
        aux = {"bn1_moving_mean": np.zeros(nh, np.float32),
               "bn1_moving_var": np.ones(nh, np.float32)}
    return arg, aux


def _env(monkeypatch, amp_dtype, loss_scale, fused=True):
    if amp_dtype is None:
        monkeypatch.delenv("TPUMX_AMP", raising=False)
        monkeypatch.delenv("TPUMX_AMP_DTYPE", raising=False)
    else:
        monkeypatch.setenv("TPUMX_AMP", "1")
        monkeypatch.setenv("TPUMX_AMP_DTYPE", amp_dtype)
    if loss_scale is None:
        monkeypatch.delenv("TPUMX_AMP_LOSS_SCALE", raising=False)
    else:
        monkeypatch.setenv("TPUMX_AMP_LOSS_SCALE", loss_scale)
    monkeypatch.setenv("TPUMX_FUSED_STEP", "1" if fused else "0")


def _fit(pkg, monkeypatch, amp_dtype=None, optimizer="sgd",
         opt_params=(("learning_rate", 0.5),), loss_scale=None, bn=False,
         fused=True):
    """One epoch (10 steps at B=32) from the same numpy parameters;
    ``(module, params, aux)`` as numpy f32."""
    _env(monkeypatch, amp_dtype, loss_scale, fused)
    X, Y = _toy()
    arg, aux = _params(bn=bn)
    mod = pkg.mod.Module(_mlp_sym(pkg, bn=bn), context=pkg.cpu())
    mod.fit(pkg.io.NDArrayIter(X, Y, batch_size=32, shuffle=False),
            num_epoch=1, optimizer=optimizer, optimizer_params=opt_params,
            arg_params={k: pkg.nd.array(v) for k, v in arg.items()},
            aux_params={k: pkg.nd.array(v) for k, v in aux.items()},
            kvstore="local")
    a, x = mod.get_params()
    f = lambda d: {k: np.asarray(v.asnumpy(), np.float32)  # noqa: E731
                   for k, v in d.items()}
    return mod, f(a), f(x)


def _close(got, want, rtol):
    assert set(got) == set(want)
    for k in want:
        np.testing.assert_allclose(
            got[k], want[k], rtol=rtol,
            atol=rtol * max(1e-3, float(np.abs(want[k]).max())), err_msg=k)


# -- the casting policy ----------------------------------------------------------
@pytest.mark.parametrize("name,make", golden._CASES)
@pytest.mark.parametrize("dtype", ["bfloat16", "float16"])
def test_convert_symbol_matches_reference(name, make, dtype, monkeypatch):
    """The converted graph's JSON and cast count are the reference's (and
    its checked-in golden file's)."""
    out = {}
    for tag, pkg, amp in (("j", jmx, jamp), ("t", tmx, tamp)):
        monkeypatch.setattr(golden, "sym", pkg.sym)
        base = make()
        conv = amp.convert_symbol(base, dtype)
        out[tag] = (conv.tojson(), amp.count_amp_casts(conv),
                    amp.count_amp_casts(base))
    assert out["t"] == out["j"]
    assert out["t"][1] > 0 and out["t"][2] == 0
    with open(f"{golden.GOLDEN_DIR}/amp_{name}_{dtype}.json") as f:
        assert out["t"][0] == f.read()


def _without_out_grad(js):
    g = json.loads(js)
    for n in g["nodes"]:
        n.get("attrs", {}).pop("out_grad", None)
        if "attrs" in n and not n["attrs"]:
            del n["attrs"]
    return g


@pytest.mark.parametrize("name,make", golden._CASES)
def test_remove_amp_cast_round_trip(name, make, monkeypatch):
    """Stripping a converted graph gives the reference's stripped JSON (its
    golden file): the original graph with the loss head's ``out_grad``
    kept, zero casts and the original arguments; a graph without casts
    comes back as is."""
    monkeypatch.setattr(golden, "sym", jmx.sym)
    want = jamp.remove_amp_cast(jamp.convert_symbol(make(), "bfloat16"))
    monkeypatch.setattr(golden, "sym", tmx.sym)
    base = make()
    stripped = tamp.remove_amp_cast(tamp.convert_symbol(base, "bfloat16"))
    assert stripped.tojson() == want.tojson()
    with open(f"{golden.GOLDEN_DIR}/amp_{name}_stripped.json") as f:
        assert stripped.tojson() == f.read()
    assert _without_out_grad(stripped.tojson()) \
        == _without_out_grad(base.tojson())
    assert tamp.count_amp_casts(stripped) == 0
    assert stripped.list_arguments() == base.list_arguments()
    assert tamp.remove_amp_cast(base) is base
    with pytest.raises(MXNetError):
        tamp.convert_symbol(base, "float64")


def test_converted_forward_runs_low_precision():
    """The converted FC computes in bf16 (output dtype, rounding), as the
    reference's does, and both agree within the low-precision tolerance."""
    r = np.random.RandomState(0)
    x, w = r.rand(4, 8).astype(np.float32), r.rand(4, 8).astype(np.float32)
    outs = {}
    for tag, pkg, amp in (("j", jmx, jamp), ("t", tmx, tamp)):
        with pkg.name.NameManager():
            fc = pkg.sym.FullyConnected(pkg.sym.Variable("data"),
                                        num_hidden=4, name="fc1")
        e = amp.convert_symbol(fc, "bfloat16").bind(
            ctx=pkg.cpu(), args={"data": pkg.nd.array(x),
                                 "fc1_weight": pkg.nd.array(w),
                                 "fc1_bias": pkg.nd.array(np.zeros(4,
                                                                   np.float32))},
            args_grad=None, grad_req="null")
        e.forward(is_train=False)
        outs[tag] = e.outputs[0]
    assert str(outs["t"].dtype) == str(outs["j"].dtype) == "bfloat16"
    got = outs["t"].astype("float32").asnumpy()
    np.testing.assert_allclose(got, outs["j"].asnumpy().astype(np.float32),
                               rtol=LOWP)
    assert np.abs(got - x @ w.T).max() > 0


# -- the environment grammar and the scaler -------------------------------------
@pytest.mark.parametrize("env", [
    (None, None, None), ("0", "float16", None), ("1", None, None),
    ("1", "bfloat16", None), ("1", "float16", None),
    ("1", "float16", "1024"), ("1", "float16", " Dynamic "),
    ("1", "bfloat16", "dynamic"), ("1", "float16", "none"),
    ("1", "float16", "off"), ("1", "float16", "0"), ("1", "float16", "-2"),
    ("1", "float16", "garbage"), ("1", "float64", None)])
def test_active_config_grammar(env, monkeypatch):
    """``TPUMX_AMP``/``TPUMX_AMP_DTYPE``/``TPUMX_AMP_LOSS_SCALE`` resolve
    as the reference's do, refusals included, and make the same
    scaler."""
    for name, v in zip(("TPUMX_AMP", "TPUMX_AMP_DTYPE",
                        "TPUMX_AMP_LOSS_SCALE"), env):
        if v is None:
            monkeypatch.delenv(name, raising=False)
        else:
            monkeypatch.setenv(name, v)

    def resolve(amp):
        try:
            cfg = amp.active_config()
        except Exception as e:  # noqa: BLE001 — compared by type name
            return ("raised", type(e).__name__)
        sc = amp.make_loss_scaler(cfg)
        return (None if cfg is None else (cfg.dtype, cfg.loss_scale),
                None if sc is None else sc.static_key())

    assert resolve(tamp) == resolve(jamp)


@pytest.mark.parametrize("knobs", [
    dict(init_scale=8.0, growth_interval=3, max_scale=32.0, min_scale=2.0),
    dict(init_scale=1024.0, dynamic=False),
    dict(init_scale=3.0, growth_factor=1.5, backoff_factor=0.25,
         growth_interval=2)])
def test_loss_scaler_next_state(knobs):
    """``next_state`` over a scripted finite/overflow sequence: the
    port's ``(scale, good_steps)`` equal the reference's bit for bit at
    every step (growth, the cap, backoff, the floor)."""
    import jax.numpy as jnp

    script = [1, 1, 1, 1, 1, 1, 1, 0, 1, 0, 0, 0, 0, 1, 1, 1, 1, 1, 1, 0]
    ts, js = tamp.LossScaler(**knobs), jamp.LossScaler(**knobs)
    assert ts.static_key() == js.static_key()
    t, j = ts.state(), js.state()
    for ok in script:
        t = ts.next_state(t, torch.tensor(bool(ok)))
        j = js.next_state(j, jnp.asarray(bool(ok)))
        assert [float(v) for v in t] == [float(v) for v in j]
        assert t[0].dtype == t[1].dtype == torch.float32


# -- Module.fit -----------------------------------------------------------------
@pytest.mark.parametrize("optimizer,opt_params", [
    ("sgd", (("learning_rate", 0.5),)),
    ("adam", (("learning_rate", 0.05),))], ids=["sgd", "adam"])
def test_fit_bf16(monkeypatch, optimizer, opt_params):
    """bf16 AMP through the fused step: the reference's parameters within
    rtol 0.05, no loss scaler, ten fused steps."""
    mj, pj, _ = _fit(jmx, monkeypatch, "bfloat16", optimizer, opt_params)
    mt, pt, _ = _fit(tmx, monkeypatch, "bfloat16", optimizer, opt_params)
    assert mt._fused_step_count == mj._fused_step_count == 10
    assert mt._loss_scaler is None and mj._loss_scaler is None
    assert tamp.count_amp_casts(mt._exec._symbol) \
        == jamp.count_amp_casts(mj._exec._symbol) == 6
    _close(pt, pj, LOWP)


def test_fit_fp16_static_scale(monkeypatch):
    """fp16 at a static scale of 1024: every step applies, the scale
    never moves, parameters within rtol 0.08 of the reference's."""
    mj, pj, _ = _fit(jmx, monkeypatch, "float16", loss_scale="1024")
    mt, pt, _ = _fit(tmx, monkeypatch, "float16", loss_scale="1024")
    assert mt._fused_step_count == 10
    for m in (mt, mj):
        assert (m._loss_scaler.scale_value, m._loss_scaler.good_steps) \
            == (1024.0, 10)
    _close(pt, pj, 0.08)


def test_fit_fp16_dynamic_scale(monkeypatch):
    """fp16 with dynamic scaling from 2^15: the port's final ``(scale,
    good_steps)`` equal the reference's exactly (overflows backed off,
    then clean steps), parameters finite."""
    mj, pj, _ = _fit(jmx, monkeypatch, "float16", loss_scale="dynamic")
    mt, pt, _ = _fit(tmx, monkeypatch, "float16", loss_scale="dynamic")
    assert mt._fused_step_count == 10
    got = (mt._loss_scaler.scale_value, mt._loss_scaler.good_steps)
    assert got == (mj._loss_scaler.scale_value, mj._loss_scaler.good_steps)
    assert got[0] < 2.0 ** 15 and got[1] > 0
    assert mt._loss_scaler.state()[0].dtype == torch.float32
    for v in pt.values():
        assert np.isfinite(v).all()


def test_fit_amp_off_is_bitwise_f32(monkeypatch):
    """``TPUMX_AMP=0`` and unset train bitwise the port's f32 fit, bind
    the original graph and make no scaler."""
    _, p_unset, _ = _fit(tmx, monkeypatch, None)
    monkeypatch.setenv("TPUMX_AMP", "0")
    monkeypatch.setenv("TPUMX_AMP_DTYPE", "float16")
    X, Y = _toy()
    arg, _ = _params()
    mod = tmx.mod.Module(_mlp_sym(tmx), context=tmx.cpu())
    mod.fit(tmx.io.NDArrayIter(X, Y, batch_size=32, shuffle=False),
            num_epoch=1, optimizer="sgd",
            optimizer_params=(("learning_rate", 0.5),),
            arg_params={k: tmx.nd.array(v) for k, v in arg.items()})
    assert mod._fused_step_count == 10 and mod._loss_scaler is None
    assert tamp.count_amp_casts(mod._exec._symbol) == 0
    for k, v in mod.get_params()[0].items():
        np.testing.assert_array_equal(v.asnumpy(), p_unset[k])


def test_amp_env_binds_converted_graph(monkeypatch):
    """``TPUMX_AMP=1``: the bound executor's graph has the casts, the
    module's own symbol and argument names stay the original, and the
    parameters differ from the f32 fit's (the bf16 rounding trained)."""
    _, p32, _ = _fit(tmx, monkeypatch, None)
    mod, pbf, _ = _fit(tmx, monkeypatch, "bfloat16")
    assert tamp.count_amp_casts(mod._exec._symbol) > 0
    assert tamp.count_amp_casts(mod.symbol) == 0
    assert mod._exec._symbol.list_arguments() == mod.symbol.list_arguments()
    assert any(not np.array_equal(pbf[k], p32[k]) for k in p32)


def test_fit_bn_bf16_aux(monkeypatch):
    """Through BatchNorm (an f32 op): the running statistics stay f32 and
    track the reference's bf16 run (sgd with momentum)."""
    opt = (("learning_rate", 0.1), ("momentum", 0.9))
    _, pj, aj = _fit(jmx, monkeypatch, "bfloat16", opt_params=opt, bn=True)
    mt, pt, at = _fit(tmx, monkeypatch, "bfloat16", opt_params=opt, bn=True)
    assert at and set(at) == set(aj)
    for v in mt.get_params()[1].values():
        assert v.dtype == np.float32
    for k in aj:
        np.testing.assert_allclose(at[k], aj[k], rtol=LOWP, atol=1e-3,
                                   err_msg=k)
    _close(pt, pj, LOWP)


def _og_module(pkg, scaler):
    """The MLP with an ``out_grad`` head, bound, with ``scaler`` put in
    by hand (the reference's ``_scaled_module``)."""
    with pkg.name.NameManager():
        data, label = pkg.sym.Variable("data"), pkg.sym.Variable(
            "softmax_label")
        h = pkg.sym.Activation(pkg.sym.FullyConnected(
            data, num_hidden=16, name="fc1"), act_type="relu", name="r")
        out = pkg.sym.SoftmaxOutput(pkg.sym.FullyConnected(
            h, num_hidden=4, name="fc2"), label, name="softmax",
            out_grad=True)
    mod = pkg.mod.Module(out, context=pkg.cpu())
    mod.bind(data_shapes=[("data", (32, 8))],
             label_shapes=[("softmax_label", (32,))])
    arg, _ = _params()
    mod.init_params(arg_params={k: pkg.nd.array(v) for k, v in arg.items()})
    mod.init_optimizer(optimizer="sgd",
                       optimizer_params={"learning_rate": 0.5})
    mod._loss_scaler = scaler
    return mod


def _batch(pkg, bad=False):
    r = np.random.RandomState(0)
    X = r.rand(32, 8).astype(np.float32)
    if bad:
        X[0, 0] = np.inf
    Y = r.randint(0, 4, 32).astype(np.float32)
    return pkg.io.DataBatch(data=[pkg.nd.array(X)], label=[pkg.nd.array(Y)])


def test_overflow_skips_update_and_backs_off(monkeypatch):
    """A non-finite batch: parameters and momentum-free SGD state bitwise
    unchanged, the update count advanced, the scale halved and the clean
    count reset; clean steps after it apply again.  Both packages take
    the same branches and end at the same parameters (rtol 1e-5)."""
    monkeypatch.setenv("TPUMX_FUSED_STEP", "1")
    got = {}
    for pkg, amp in ((jmx, jamp), (tmx, tamp)):
        mod = _og_module(pkg, amp.LossScaler(init_scale=8.0,
                                             growth_interval=2))
        trail = []
        for bad in (False, True, False, False):
            before = {k: v.asnumpy().copy()
                      for k, v in mod.get_params()[0].items()}
            assert mod._try_fused_step(_batch(pkg, bad))
            after = {k: v.asnumpy() for k, v in mod.get_params()[0].items()}
            same = all(np.array_equal(after[k], before[k]) for k in before)
            trail.append((bad, same, mod._loss_scaler.scale_value,
                          mod._loss_scaler.good_steps))
        got[pkg.__name__] = (trail, after,
                             mod._optimizer._index_update_count[0])
    (tt, pt, ct), (jt, pj, cj) = got["mxnet_tpu_torch"], got["mxnet_tpu"]
    assert tt == jt == [(False, False, 8.0, 1), (True, True, 4.0, 0),
                        (False, False, 4.0, 1), (False, False, 8.0, 0)]
    assert ct == cj == 4
    for k in pj:
        np.testing.assert_allclose(pt[k], pj[k], rtol=1e-5, atol=1e-7)


def test_legacy_path_warns_and_trains_unscaled(monkeypatch, caplog):
    """``TPUMX_FUSED_STEP=0`` with fp16 dynamic AMP: the scaler is dropped
    with the reference's warning and the converted graph trains on the
    legacy route, finite, as the reference's does (rtol 0.08)."""
    with caplog.at_level(logging.WARNING):
        mt, pt, _ = _fit(tmx, monkeypatch, "float16", loss_scale="dynamic",
                         fused=False)
    assert "trains UNSCALED" in caplog.text
    mj, pj, _ = _fit(jmx, monkeypatch, "float16", loss_scale="dynamic",
                     fused=False)
    assert mt._fused_step_count == mj._fused_step_count == 0
    assert mt._loss_scaler is None and mj._loss_scaler is None
    assert tamp.count_amp_casts(mt._exec._symbol) > 0
    _close(pt, pj, 0.08)


def test_checkpoints_strip_casts(tmp_path):
    """``save_checkpoint`` (default ``remove_amp_cast=True``) and Gluon
    ``export`` write graphs without casts: the reference's bytes;
    ``remove_amp_cast=False`` keeps them."""
    conv = tamp.convert_symbol(_mlp_sym(tmx), "bfloat16")
    tmx.model.save_checkpoint(str(tmp_path / "t"), 1, conv, {}, {})
    jmx.model.save_checkpoint(str(tmp_path / "j"), 1,
                              jamp.convert_symbol(_mlp_sym(jmx), "bfloat16"),
                              {}, {})
    assert (tmp_path / "t-symbol.json").read_bytes() \
        == (tmp_path / "j-symbol.json").read_bytes()
    loaded, _, _ = tmx.model.load_checkpoint(str(tmp_path / "t"), 1)
    assert tamp.count_amp_casts(loaded) == 0
    tmx.model.save_checkpoint(str(tmp_path / "k"), 1, conv, {}, {},
                              remove_amp_cast=False)
    kept, _, _ = tmx.model.load_checkpoint(str(tmp_path / "k"), 1)
    assert tamp.count_amp_casts(kept) == tamp.count_amp_casts(conv)

    from mxnet_tpu_torch.gluon import HybridBlock

    class CastNet(HybridBlock):
        def hybrid_forward(self, F, x):
            return F.relu(F.amp_cast(x, dtype="bfloat16"))

    net = CastNet(prefix="castnet_")
    for strip, want in ((True, 0), (False, 1)):
        net.export(str(tmp_path / f"net{strip}"), remove_amp_cast=strip)
        s = tmx.sym.load(str(tmp_path / f"net{strip}-symbol.json"))
        assert tamp.count_amp_casts(s) == want


# -- Gluon ----------------------------------------------------------------------
def _gluon_pair(dims=(16, 4), bn=True):
    """The same Dense/BatchNorm/Dense net in both packages, the port's
    parameters copied from the reference's (creation order)."""
    nets = []
    for pkg in (jmx, tmx):
        nn = pkg.gluon.nn
        net = nn.HybridSequential()
        blocks = [nn.Dense(dims[0], activation="relu")]
        if bn:
            blocks.append(nn.BatchNorm())
        blocks.append(nn.Dense(dims[1]))
        net.add(*blocks)
        net.initialize(ctx=pkg.cpu())
        net(pkg.nd.array(np.zeros((2, 32), np.float32)))
        nets.append(net)
    jnet, tnet = nets
    for jp, tp in zip(jnet.collect_params().values(),
                      tnet.collect_params().values()):
        tp.set_data(tmx.nd.array(jp.data().asnumpy()))
        assert tp.shape == jp.shape
    return jnet, tnet


def test_gluon_amp_init():
    """``amp.init``: Dense parameters bf16, BatchNorm's f32, the output
    bf16, as the reference's; the forward within rtol 0.05 of the
    reference's converted forward; a bad dtype refused."""
    jnet, tnet = _gluon_pair()
    x = np.random.RandomState(0).rand(8, 32).astype(np.float32)
    for net, amp in ((jnet, jamp), (tnet, tamp)):
        assert amp.init(net, "bfloat16") is net
    dt = lambda net: [str(p.data().dtype)  # noqa: E731
                      for p in net.collect_params().values()]
    assert dt(tnet) == dt(jnet)
    assert dt(tnet)[0] == "bfloat16" and "float32" in dt(tnet)
    want = jnet(jmx.nd.array(x))
    got = tnet(tmx.nd.array(x))
    assert str(got.dtype) == str(want.dtype) == "bfloat16"
    w = want.asnumpy().astype(np.float32)
    np.testing.assert_allclose(got.astype("float32").asnumpy(), w,
                               rtol=LOWP, atol=LOWP * np.abs(w).max())
    with pytest.raises(MXNetError):
        tamp.init(tnet, "float64")


def test_gluon_amp_trainer_steps():
    """Three ``Trainer(sgd, multi_precision=True)`` steps of a converted
    net: parameters keep bf16 storage, f32 masters in the updater's
    states, and the result is within rtol 0.05 of the reference's."""
    jnet, tnet = _gluon_pair(bn=False)
    x = np.random.RandomState(0).rand(8, 32).astype(np.float32)
    out = []
    for pkg, net, amp in ((jmx, jnet, jamp), (tmx, tnet, tamp)):
        amp.init(net, "bfloat16")
        trainer = pkg.gluon.Trainer(net.collect_params(), "sgd",
                                    {"learning_rate": 0.1,
                                     "multi_precision": True})
        xa = pkg.nd.array(x)
        for _ in range(3):
            with pkg.autograd.record():
                loss = (net(xa).astype("float32") ** 2).sum()
            loss.backward()
            trainer.step(8)
        out.append([p.data() for p in net.collect_params().values()])
    for pj, pt in zip(*out):
        assert str(pt.dtype) == str(pj.dtype) == "bfloat16"
        a = pj.asnumpy().astype(np.float32)
        np.testing.assert_allclose(pt.astype("float32").asnumpy(), a,
                                   rtol=LOWP, atol=LOWP * np.abs(a).max())
    masters = [st[0] for st in trainer._updaters[0].states.values()]
    assert len(masters) == len(out[1])
    assert all(m.dtype == np.float32 for m in masters)
