"""PyTorch port: control flow (``sym.contrib``/``nd.contrib`` ``foreach``,
``while_loop``, ``cond``) against the JAX package.

Each of ``tests/test_control_flow.py``'s fourteen cases runs on both
packages with the same numpy inputs (the reference's jitted ``nd.contrib``
routes stand against the port's hybridized ones, where
``gluon.cached_op.in_program()`` plays the part of a trace): forward and
gradient, closures over outer values, ``while_loop``, ``cond``,
``hybridize``, JSON round trips (the port's JSON the reference's bytes;
every node named, as auto-names are process-wide counters) and nested
``foreach``.  Added: no NaN gradient through an untaken branch, a random
op in a hybridized loop body (the reference draws one key for every
step), and shape inference's message at a body weight of unknown shape.
Values within f32 rtol 1e-5 (1e-4 for gradients through a whole loop).
"""
import numpy as np
import pytest
import torch

import mxnet_tpu as jmx
import mxnet_tpu_torch as tmx
from mxnet_tpu_torch.base import MXNetError

PKGS = [tmx, jmx]


@pytest.fixture(autouse=True)
def _cpu():
    with tmx.cpu():
        yield


def _np(a):
    return np.asarray(a.asnumpy())


def _close(a, b, rtol=1e-5, atol=1e-6):
    np.testing.assert_allclose(_np(a), _np(b), rtol=rtol, atol=atol)


def _rnn_oracle(x, h0, w, u, b):
    hs, h = [], h0
    for t in range(x.shape[0]):
        h = np.tanh(x[t] @ w + h @ u + b)
        hs.append(h)
    return np.stack(hs), h


def test_foreach_rnn_matches_unrolled_oracle():
    T, B, D, H = 5, 3, 4, 6
    rs = np.random.RandomState(0)
    vals = {"data": rs.rand(T, B, D), "h0": rs.rand(B, H),
            "w": rs.randn(D, H) * 0.4, "u": rs.randn(H, H) * 0.4,
            "b": rs.rand(H)}
    vals = {k: v.astype(np.float32) for k, v in vals.items()}
    res = []
    for mx in PKGS:
        sym, nd = mx.sym, mx.nd
        with mx.name.NameManager():
            data, h0, w, u, b = (sym.var(n) for n in ("data", "h0", "w",
                                                      "u", "b"))

            def body(x_t, states):
                h = states[0]
                nh = sym.tanh(sym.broadcast_add(
                    sym.dot(x_t, w) + sym.dot(h, u), b))
                return nh, [nh]

            outs, final = sym.contrib.foreach(body, data, [h0], name="fe")
        ex = outs.bind(ctx=mx.cpu(), args={k: nd.array(v)
                                           for k, v in vals.items()},
                       args_grad={"w": nd.zeros((D, H)),
                                  "u": nd.zeros((H, H)),
                                  "data": nd.zeros((T, B, D))},
                       grad_req={"w": "write", "u": "write",
                                 "data": "write"})
        y = ex.forward(is_train=True)[0]
        ex.backward(nd.ones((T, B, H)))
        res.append((y, ex.grad_dict))
    ys_ref, _ = _rnn_oracle(*(vals[k] for k in ("data", "h0", "w", "u",
                                                "b")))
    np.testing.assert_allclose(_np(res[0][0]), ys_ref, rtol=1e-5, atol=1e-6)
    _close(res[0][0], res[1][0])
    for k in ("w", "u", "data"):
        _close(res[0][1][k], res[1][1][k], rtol=1e-4, atol=1e-5)


def test_foreach_closure_over_outer_computation():
    T, B = 4, 3
    rs = np.random.RandomState(1)
    x_np = rs.rand(T, B).astype(np.float32)
    got = []
    for mx in PKGS:
        sym, nd = mx.sym, mx.nd
        with mx.name.NameManager():
            data, h0, scale = sym.var("data"), sym.var("h0"), sym.var("scale")
            doubled = scale * 2.0

            def body(x_t, states):
                s = states[0] + sym.broadcast_mul(x_t, doubled)
                return s, [s]

            _, final = sym.contrib.foreach(body, data, [h0], name="fc")
        ex = final[0].bind(ctx=mx.cpu(), args={
            "data": nd.array(x_np), "h0": nd.array(np.zeros(B, np.float32)),
            "scale": nd.array(np.array([3.0], np.float32))}, grad_req="null")
        got.append(ex.forward(is_train=False)[0])
    np.testing.assert_allclose(_np(got[0]), (x_np * 6.0).sum(axis=0),
                               rtol=1e-5)
    _close(*got)


def _while_sym(mx):
    sym = mx.sym
    with mx.name.NameManager():
        s0, i0 = sym.var("s0"), sym.var("i0")
        outs, finals = sym.contrib.while_loop(
            lambda s, i: s < 10.0,
            lambda s, i: ([s + i], [s + i, i + 1.0]),
            [s0, i0], max_iterations=8, name="wl")
        return sym.Group([outs[0], finals[0], finals[1]])


def test_while_loop_symbolic_matches_eager():
    got = []
    for mx in PKGS:
        ex = _while_sym(mx).bind(
            ctx=mx.cpu(), args={"s0": mx.nd.array(np.array([0.], np.float32)),
                                "i0": mx.nd.array(np.array([1.], np.float32))},
            grad_req="null")
        got.append(ex.forward(is_train=False))
    s, i, rows = 0.0, 1.0, []
    while s < 10.0 and len(rows) < 8:
        s += i
        rows.append(s)
        i += 1.0
    padded = np.zeros((8, 1), np.float32)
    padded[:len(rows), 0] = rows
    np.testing.assert_array_equal(_np(got[0][0]), padded)
    assert float(_np(got[0][1])[0]) == s and float(_np(got[0][2])[0]) == i
    for a, b in zip(*got):
        _close(a, b)


def test_cond_symbolic():
    for av, bv, expect in [(3.0, 1.0, 6.0), (1.0, 3.0, 9.0)]:
        got = []
        for mx in PKGS:
            sym = mx.sym
            with mx.name.NameManager():
                a, b = sym.var("a"), sym.var("b")
                out = sym.contrib.cond(sym.sum(a) > sym.sum(b),
                                       lambda: a * 2.0, lambda: b * 3.0,
                                       name="cd")
            ex = out.bind(ctx=mx.cpu(), args={
                "a": mx.nd.array(np.array([av], np.float32)),
                "b": mx.nd.array(np.array([bv], np.float32))},
                grad_req="null")
            got.append(ex.forward(is_train=False)[0])
        assert np.allclose(_np(got[0]), expect)
        _close(*got)


def test_cond_gradient_flows_through_taken_branch():
    got = []
    for mx in PKGS:
        sym, nd = mx.sym, mx.nd
        with mx.name.NameManager():
            a = sym.var("a")
            out = sym.contrib.cond(sym.sum(a) > 0.0, lambda: a * 2.0,
                                   lambda: a * 5.0, name="cg")
        ex = out.bind(ctx=mx.cpu(),
                      args={"a": nd.array(np.array([2.0], np.float32))},
                      args_grad={"a": nd.zeros((1,))}, grad_req="write")
        ex.forward(is_train=True)
        ex.backward(nd.ones((1,)))
        got.append(ex.grad_dict["a"])
    assert np.allclose(_np(got[0]), 2.0)
    _close(*got)


def _eager_body(x_t, states):
    s = states[0] + x_t * x_t
    return s * 0.5, [s]


class _Scan:
    """A hybridized block running ``nd.contrib`` control flow (the port's
    program route; the reference's jitted route below)."""

    @staticmethod
    def make(mx, fn):
        class Blk(mx.gluon.HybridBlock):
            def hybrid_forward(self, F, *xs):
                return fn(F, *xs)

        b = Blk()
        b.initialize(ctx=mx.cpu())
        b.hybridize()
        return b


def test_nd_foreach_eager_and_traced_agree():
    import jax

    T, B = 6, 2
    rs = np.random.RandomState(2)
    x_np = rs.rand(T, B).astype(np.float32)
    s0_np = np.zeros((B,), np.float32)
    outs, fin = tmx.nd.contrib.foreach(
        _eager_body, tmx.nd.array(x_np), [tmx.nd.array(s0_np)])
    blk = _Scan.make(tmx, lambda F, x, s: tuple(
        (lambda o, f: (o, f[0]))(*F.contrib.foreach(_eager_body, x, [s]))))
    o2, f2 = blk(tmx.nd.array(x_np), tmx.nd.array(s0_np))
    _close(outs, o2)
    _close(fin[0], f2)

    def traced(xv, sv):
        o, f = jmx.nd.contrib.foreach(_eager_body, jmx.nd.NDArray(xv),
                                      [jmx.nd.NDArray(sv)])
        return o._data, f[0]._data

    jo, jf = jax.jit(traced)(x_np, s0_np)
    np.testing.assert_allclose(_np(o2), np.asarray(jo), rtol=1e-5)
    np.testing.assert_allclose(_np(f2), np.asarray(jf), rtol=1e-5)


def test_nd_while_and_cond_traced():
    import jax

    def while_fn(F, s):
        _, lv = F.contrib.while_loop(lambda a: F.sum(a) < 10.0,
                                     lambda a: ([a], [a * 2.0]), [s],
                                     max_iterations=6)
        return lv[0]

    blk = _Scan.make(tmx, while_fn)
    got = blk(tmx.nd.array(np.array([1.0], np.float32)))
    assert np.allclose(_np(got), 16.0)
    eager = tmx.nd.contrib.while_loop(
        lambda a: tmx.nd.sum(a) < 10.0, lambda a: ([a], [a * 2.0]),
        [tmx.nd.array(np.array([1.0], np.float32))], max_iterations=6)
    assert np.allclose(_np(eager[1][0]), 16.0) and eager[0][0].shape == (4, 1)

    def jwhile(s):
        _, lv = jmx.nd.contrib.while_loop(
            lambda a: jmx.nd.sum(a) < 10.0, lambda a: ([a], [a * 2.0]),
            [jmx.nd.NDArray(s)], max_iterations=6)
        return lv[0]._data

    np.testing.assert_allclose(
        _np(got), np.asarray(jax.jit(jwhile)(np.array([1.0], np.float32))))

    cblk = _Scan.make(tmx, lambda F, p, a: F.contrib.cond(
        p, lambda: a * 2.0, lambda: a * 3.0))
    for p, want in ((1.0, 4.0), (0.0, 6.0)):
        out = cblk(tmx.nd.array(np.array(p, np.float32)),
                   tmx.nd.array(np.array([2.0], np.float32)))
        assert np.allclose(_np(out), want)
        eager = tmx.nd.contrib.cond(
            tmx.nd.array(np.array(p, np.float32)),
            lambda: tmx.nd.array(np.array([2.0], np.float32)) * 2.0,
            lambda: tmx.nd.array(np.array([2.0], np.float32)) * 3.0)
        assert np.allclose(_np(eager), want)


def test_foreach_dropout_masks_differ_per_step():
    got = []
    for mx in PKGS:
        sym, nd = mx.sym, mx.nd
        with mx.name.NameManager():
            data, s0 = sym.var("data"), sym.var("s0")
            outs, _ = sym.contrib.foreach(
                lambda x_t, st: (sym.Dropout(x_t, p=0.5), st), data, [s0],
                name="dr")
        ex = outs.bind(ctx=mx.cpu(), args={
            "data": nd.array(np.ones((8, 64), np.float32)),
            "s0": nd.array(np.zeros((1,), np.float32))}, grad_req="null")
        y = _np(ex.forward(is_train=True)[0])
        assert len({(y[t] != 0).tobytes() for t in range(8)}) > 1
        assert set(np.unique(y)) <= {0.0, 2.0}
        got.append(y)


def test_nd_foreach_single_element_list_output_consistent():
    import jax

    x_np = np.random.RandomState(7).rand(3, 2).astype(np.float32)

    def body(x_t, states):
        return [x_t * 2.0], [states[0] + x_t]

    eager_out, _ = tmx.nd.contrib.foreach(
        body, tmx.nd.array(x_np), [tmx.nd.zeros((2,))])
    assert isinstance(eager_out, list) and len(eager_out) == 1

    def prog(F, x):
        out, _ = F.contrib.foreach(body, x, [F.zeros_like(x[0])])
        assert isinstance(out, list) and len(out) == 1
        return out[0]

    hyb = _Scan.make(tmx, prog)(tmx.nd.array(x_np))
    _close(eager_out[0], hyb)

    def traced(xv):
        out, _ = jmx.nd.contrib.foreach(
            body, jmx.nd.NDArray(xv), [jmx.nd.NDArray(np.zeros(2,
                                                               np.float32))])
        return out[0]._data

    np.testing.assert_allclose(_np(hyb), np.asarray(jax.jit(traced)(x_np)))


def _scan_block(mx, H):
    class ScanBlock(mx.gluon.HybridBlock):
        def __init__(self, **kw):
            super().__init__(**kw)
            with self.name_scope():
                self.proj = mx.gluon.nn.Dense(H, in_units=H, flatten=False)

        def hybrid_forward(self, F, x):
            def body(x_t, states):
                h = F.tanh(self.proj(x_t) + states[0])
                return h, [h]

            init = F.sum(x, axis=0) * 0.0
            outs, _ = F.contrib.foreach(body, x, [init])
            return outs

    return ScanBlock()


def test_foreach_under_hybridize():
    T, B, H = 4, 2, 8
    rs = np.random.RandomState(3)
    x = rs.rand(T, B, H).astype(np.float32)
    w = (rs.randn(H, H) * 0.3).astype(np.float32)
    bias = rs.randn(H).astype(np.float32)
    res = []
    for mx in PKGS:
        net = _scan_block(mx, H)
        net.initialize(ctx=mx.cpu())
        net.proj.weight.set_data(mx.nd.array(w))
        net.proj.bias.set_data(mx.nd.array(bias))
        eager = net(mx.nd.array(x))
        net.hybridize()
        xa = mx.nd.array(x)
        xa.attach_grad()
        with mx.autograd.record():
            hyb = net(xa)
        hyb.backward(mx.nd.ones_like(hyb))
        _close(eager, hyb)
        res.append((hyb, xa.grad, net.proj.weight.grad()))
    for a, b in zip(*res):
        _close(a, b, rtol=1e-4, atol=1e-5)


def _json_pair(build):
    out = []
    for mx in PKGS:
        with mx.name.NameManager():
            out.append(build(mx))
    return out


def _fe_sym(mx):
    sym = mx.sym
    H = 4
    data, init, w = (sym.Variable(n) for n in ("data", "init", "w"))

    def body(x, states):
        nh = sym.tanh(sym.FullyConnected(x + states[0], weight=w,
                                         num_hidden=H, no_bias=True,
                                         name="fcb"))
        return nh, [nh]

    outs, _ = sym.contrib.foreach(body, data, [init], name="fej")
    return outs


def test_foreach_tojson_roundtrip():
    T, B, H = 5, 2, 4
    r = np.random.RandomState(0)
    vals = {"data": r.rand(T, B, H), "init": np.zeros((B, H)),
            "w": r.rand(H, H) * 0.3}
    syms = _json_pair(_fe_sym)
    assert syms[0].tojson() == syms[1].tojson()
    got = []
    for mx, s in zip(PKGS, syms):
        args = {k: mx.nd.array(v.astype(np.float32)) for k, v in vals.items()}
        ref = s.bind(ctx=mx.cpu(), args=args).forward()[0]
        loaded = mx.sym.load_json(s.tojson())
        out2 = loaded.bind(ctx=mx.cpu(), args=args).forward()[0]
        assert out2.shape == (T, B, H)
        _close(ref, out2)
        got.append(out2)
    _close(*got)
    # the reference's JSON loads in the port
    back = tmx.sym.load_json(syms[1].tojson())
    assert back.tojson() == syms[1].tojson()


def test_while_loop_tojson_roundtrip():
    def build(mx):
        i, s = mx.sym.Variable("i"), mx.sym.Variable("s")
        _, finals = mx.sym.contrib.while_loop(
            lambda i, s: i < 5, lambda i, s: ([i], [i + 1, s + i]),
            [i, s], max_iterations=8, name="wj")
        return mx.sym.Group(finals)

    syms = _json_pair(build)
    assert syms[0].tojson() == syms[1].tojson()
    for mx, g in zip(PKGS, syms):
        args = {"i": mx.nd.zeros((1,)), "s": mx.nd.zeros((1,))}
        ref = [_np(a) for a in g.bind(ctx=mx.cpu(), args=args).forward()]
        loaded = mx.sym.load_json(g.tojson())
        got = [_np(a) for a in loaded.bind(ctx=mx.cpu(),
                                           args=args).forward()]
        for a, b in zip(ref, got):
            np.testing.assert_array_equal(a, b)
        assert float(got[0][0]) == 5.0 and float(got[1][0]) == 10.0
    tmx.sym.load_json(syms[1].tojson())


def test_cond_tojson_roundtrip():
    def build(mx):
        p, x = mx.sym.Variable("p"), mx.sym.Variable("x")
        return mx.sym.contrib.cond(p, lambda: x * 2.0, lambda: x - 1.0,
                                   name="cj")

    syms = _json_pair(build)
    assert syms[0].tojson() == syms[1].tojson()
    loaded = tmx.sym.load_json(syms[1].tojson())
    args = {"p": tmx.nd.ones((1,)), "x": tmx.nd.full((3,), 5.0)}
    assert np.allclose(_np(loaded.bind(ctx=tmx.cpu(),
                                       args=args).forward()[0]), 10.0)
    args["p"] = tmx.nd.zeros((1,))
    assert np.allclose(_np(loaded.bind(ctx=tmx.cpu(),
                                       args=args).forward()[0]), 4.0)


def test_nested_foreach_forward_grad_and_json():
    x_np = np.arange(24, dtype=np.float32).reshape(3, 4, 2)
    grads = []
    for mx in PKGS:
        nd = mx.nd
        x = nd.array(x_np)
        x.attach_grad()
        with mx.autograd.record():
            def inner(col, st):
                s = st + col * col
                return s, s

            def outer(row, st):
                _, f = nd.contrib.foreach(inner, row, st)
                return f, f

            _, fin = nd.contrib.foreach(outer, x, nd.zeros((2,)))
            fin.sum().backward()
        grads.append(x.grad)
    np.testing.assert_allclose(_np(grads[0]), 2 * x_np, rtol=1e-5)
    _close(*grads)

    def build(mx):
        sym = mx.sym
        data, sv = sym.Variable("data"), sym.Variable("s0")

        def sym_inner(col, st):
            s = st + col
            return s, s

        def sym_outer(row, st):
            _, f = sym.contrib.foreach(sym_inner, row, st, name="inner")
            return f, f

        o, f = sym.contrib.foreach(sym_outer, data, sv, name="outer")
        return sym.Group([o, f])

    syms = _json_pair(build)
    assert syms[0].tojson() == syms[1].tojson()
    want_fin = x_np.sum(axis=(0, 1))
    want_outs = np.cumsum(x_np.sum(axis=1), axis=0)
    for mx, g in zip(PKGS, syms):
        for s in (g, mx.sym.load_json(g.tojson())):
            exe = s.simple_bind(ctx=mx.cpu(), data=(3, 4, 2), s0=(2,))
            exe.arg_dict["data"][:] = mx.nd.array(x_np)
            res = exe.forward()
            np.testing.assert_allclose(_np(res[0]), want_outs, rtol=1e-6)
            np.testing.assert_allclose(_np(res[1]), want_fin, rtol=1e-6)


# ---------------------------------------------------------------------------
# beyond the reference's file
# ---------------------------------------------------------------------------

def test_cond_untaken_branch_gives_no_nan_gradient():
    """``sqrt`` and ``log`` at 0 in the untaken branch: the executor runs
    only the taken branch; the select route (a program, or ``meta``
    shapes) gates each branch's closures, so their gradient is finite
    and the taken branch's."""
    from mxnet_tpu_torch.gluon import cached_op

    with tmx.name.NameManager():
        a, p = tmx.sym.var("a"), tmx.sym.var("p")
        out = tmx.sym.contrib.cond(p, lambda: a * 3.0,
                                   lambda: tmx.sym.sqrt(a) + tmx.sym.log(a),
                                   name="cn")
    args = {"a": tmx.nd.array(np.array([0.0, 4.0], np.float32)),
            "p": tmx.nd.ones((1,))}
    for in_prog in (False, True):
        ex = out.bind(ctx=tmx.cpu(), args=dict(args),
                      args_grad={"a": tmx.nd.zeros((2,))},
                      grad_req={"a": "write", "p": "null"})
        if in_prog:
            with cached_op.program_scope():
                y = ex.forward(is_train=True)[0]
                ex.backward(tmx.nd.ones((2,)))
        else:
            y = ex.forward(is_train=True)[0]
            ex.backward(tmx.nd.ones((2,)))
        np.testing.assert_array_equal(_np(y), [0.0, 12.0])
        np.testing.assert_array_equal(_np(ex.grad_dict["a"]), [3.0, 3.0])
    with jmx.name.NameManager():
        ja, jp = jmx.sym.var("a"), jmx.sym.var("p")
        jout = jmx.sym.contrib.cond(
            jp, lambda: ja * 3.0, lambda: jmx.sym.sqrt(ja) + jmx.sym.log(ja),
            name="cn")
    jex = jout.bind(ctx=jmx.cpu(), args={
        "a": jmx.nd.array(np.array([0.0, 4.0], np.float32)),
        "p": jmx.nd.ones((1,))}, args_grad={"a": jmx.nd.zeros((2,))},
        grad_req={"a": "write", "p": "null"})
    jex.forward(is_train=True)
    jex.backward(jmx.nd.ones((2,)))
    _close(ex.grad_dict["a"], jex.grad_dict["a"])


def test_hybridized_foreach_dropout_key_per_call():
    """The reference traces a loop body once, so a ``Dropout`` in a
    hybridized ``foreach`` body draws one mask for every step; the port's
    program replays the same key at each step: the masks bit for bit the
    reference's, and a second call draws new ones."""
    masks = []
    for mx in PKGS:
        class B(mx.gluon.HybridBlock):
            def hybrid_forward(self, F, x):
                def body(x_t, st):
                    return F.Dropout(x_t, p=0.5), [st[0] + 1]

                outs, _ = F.contrib.foreach(body, x, [F.sum(x, axis=0) * 0])
                return outs

        b = B()
        b.initialize(ctx=mx.cpu())
        b.hybridize()
        mx.random.seed(3)
        x = mx.nd.ones((4, 16))
        with mx.autograd.train_mode():
            y1, y2 = _np(b(x)), _np(b(x))
        assert all((y1[t] != 0).tobytes() == (y1[0] != 0).tobytes()
                   for t in range(4))
        assert (y1 != 0).tobytes() != (y2 != 0).tobytes()
        masks.append((y1, y2))
    for a, b in zip(*masks):
        np.testing.assert_array_equal(a, b)


def test_shape_inference_stops_at_a_body_weight():
    """A body weight of unknown shape: the reference's message; declared,
    the shapes solve through the loop (its ops on ``meta`` tensors)."""
    msgs = []
    for mx in PKGS:
        sym = mx.sym
        with mx.name.NameManager():
            data, h0 = sym.var("data"), sym.var("h0")

            def body(x_t, st):
                h = sym.FullyConnected(x_t, num_hidden=6, name="fc") + st[0]
                return h, [h]

            outs, _ = sym.contrib.foreach(body, data, [h0], name="_foreach0")
        with pytest.raises(Exception) as e:
            outs.infer_shape(data=(5, 3, 4), h0=(3, 6))
        msgs.append(str(e.value))
    assert msgs[0] == msgs[1] == ("infer_shape: input 'fc_weight' of op "
                                  "'_foreach0' has unknown shape")
    with pytest.raises(MXNetError):
        raise MXNetError(msgs[0])
    arg, out, _ = outs.infer_shape(data=(5, 3, 4), h0=(3, 6),
                                   fc_weight=(6, 4), fc_bias=(6,))
    with tmx.name.NameManager():
        data, h0 = tmx.sym.var("data"), tmx.sym.var("h0")
        w = tmx.sym.var("fc_weight", shape=(6, 4))
        b = tmx.sym.var("fc_bias", shape=(6,))
        t_outs, _ = tmx.sym.contrib.foreach(
            lambda x_t, st: (lambda h: (h, [h]))(
                tmx.sym.FullyConnected(x_t, weight=w, bias=b, num_hidden=6,
                                       name="fc") + st[0]),
            data, [h0], name="fe_shapes")
    t_arg, t_out, _ = t_outs.infer_shape(data=(5, 3, 4), h0=(3, 6))
    assert t_out == out == [(5, 3, 6)]
    assert sorted(t_arg) == sorted(arg)
