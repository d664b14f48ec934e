"""PyTorch port: the fused ``RNN`` op, the ``Sequence*`` ops and the legacy
symbolic RNN API (``mx.rnn``) against the JAX package's.

The ``RNN`` op (all four modes, two layers, bidirectional or not, with the
final states) takes the same numpy inputs in both packages; outputs and
gradients (``jax.vjp`` against torch autograd) agree at rtol 1e-5 / atol
1e-6.  Its inter-layer dropout mask is ``bernoulli(fold_in(key, layer))``
bit for bit.  Every ``mx.rnn`` cell's ``unroll`` writes the reference's
graph JSON bytes, and the bound graph's outputs and gradients agree;
``pack_weights``/``unpack_weights`` give the reference's arrays and round
trip; a ``FusedRNNCell`` equals its ``unfuse()``d stack; RNN checkpoint
files are byte for byte the reference's; ``BucketSentenceIter`` gives the
reference's batches under the same ``random.seed``.
"""
import random

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import chip_smoke
import mxnet_tpu as jmx
import mxnet_tpu_torch as tmx
from mxnet_tpu.ops import rnn as jrnn
from mxnet_tpu_torch.ops import rnn as trnn
from mxnet_tpu_torch.ops.random_ops import bernoulli_mask

TOL = dict(rtol=1e-5, atol=1e-6)
T, N, I, H, L = 5, 3, 4, 6, 2


@pytest.fixture(autouse=True)
def _cpu():
    with tmx.cpu():
        yield


def _op_inputs(mode, bi, seed=0):
    rs = np.random.RandomState(seed)
    d = 2 if bi else 1
    P = jrnn.rnn_param_size(mode, L, I, H, bi)
    args = [rs.randn(T, N, I).astype(np.float32),
            (0.3 * rs.randn(P)).astype(np.float32),
            rs.randn(L * d, N, H).astype(np.float32)]
    if mode == "lstm":
        args.append(rs.randn(L * d, N, H).astype(np.float32))
    return args


@pytest.mark.parametrize("mode,bi", [
    ("lstm", True), ("gru", True), ("rnn_tanh", True), ("rnn_relu", True),
    ("lstm", False), ("rnn_relu", False)])
def test_rnn_op_matches_reference(mode, bi):
    assert trnn.rnn_param_size(mode, L, I, H, bi) == \
        jrnn.rnn_param_size(mode, L, I, H, bi)
    args = _op_inputs(mode, bi)
    kw = dict(state_size=H, num_layers=L, mode=mode, bidirectional=bi,
              state_outputs=True)
    rs = np.random.RandomState(1)
    cts = [rs.randn(*o.shape).astype(np.float32) for o in
           jax.eval_shape(lambda *a: jrnn.rnn(*a, **kw), *args)]

    @jax.jit    # one program: the eager vjp compiles each scan alone
    def outputs_and_grads(args, cts):
        out, vjp = jax.vjp(lambda *a: jrnn.rnn(*a, **kw), *args)
        return out, vjp(cts)

    jout, jgrads = outputs_and_grads([jnp.asarray(a) for a in args],
                                     tuple(jnp.asarray(c) for c in cts))
    targs = [torch.tensor(a, requires_grad=True) for a in args]
    tout = trnn.rnn(*targs, **kw)
    assert len(tout) == len(jout) == (3 if mode == "lstm" else 2)
    tgrads = torch.autograd.grad(tout, targs,
                                 [torch.from_numpy(c) for c in cts])
    for a, b in zip(tout, jout):
        np.testing.assert_allclose(a.detach().numpy(), np.asarray(b), **TOL)
    for a, b in zip(tgrads, jgrads):
        np.testing.assert_allclose(a.numpy(), np.asarray(b), **TOL)
    # without state_outputs: the output alone
    one = trnn.rnn(*[torch.from_numpy(a) for a in args],
                   **{**kw, "state_outputs": False})
    np.testing.assert_allclose(one.numpy(), np.asarray(jout[0]), **TOL)


def test_rnn_dropout_mask_and_training():
    key = jax.random.PRNGKey(7)
    tkey = tmx.random.key_tensor(np.asarray(key), "cpu")
    for layer in (0, 1):
        want = jax.random.bernoulli(jax.random.fold_in(key, layer), 0.6,
                                    (T, N, 2 * H))
        got = bernoulli_mask(trnn._fold_in(tkey, layer), 0.6, (T, N, 2 * H))
        np.testing.assert_array_equal(got.numpy(), np.asarray(want))
    args = _op_inputs("gru", False, seed=3)
    kw = dict(state_size=H, num_layers=L, mode="gru", bidirectional=False,
              p=0.4, state_outputs=True)
    jout = jax.jit(lambda a: jrnn.rnn(*a, rng_key=key, **kw))(
        [jnp.asarray(a) for a in args])
    tout = trnn.rnn(*[torch.from_numpy(a) for a in args], rng_key=tkey, **kw)
    for a, b in zip(tout, jout):
        np.testing.assert_allclose(a.numpy(), np.asarray(b), **TOL)
    # dropout is a training-only op: in inference the same call is the
    # unmasked recurrence
    tinf = trnn.rnn(*[torch.from_numpy(a) for a in args], rng_key=tkey,
                    _training=False, **kw)
    plain = trnn.rnn(*[torch.from_numpy(a) for a in args],
                     **{**kw, "p": 0.0})
    np.testing.assert_array_equal(tinf[0].numpy(), plain[0].numpy())
    assert not np.allclose(tinf[0].numpy(), tout[0].numpy())


@pytest.mark.parametrize("op,axis,use_len", [
    ("SequenceMask", 0, True), ("SequenceMask", 1, True),
    ("SequenceMask", 0, False), ("SequenceLast", 0, True),
    ("SequenceLast", 1, True), ("SequenceLast", 0, False),
    ("SequenceReverse", 0, True), ("SequenceReverse", 0, False)])
def test_sequence_ops(op, axis, use_len):
    rs = np.random.RandomState(2)
    # time on `axis`, the batch of 4 on the other
    x = rs.randn(*((5, 4, 3) if axis == 0 else (4, 5, 3))).astype(np.float32)
    lens = np.array([5, 1, 3, 4], np.float32)
    kw = dict(use_sequence_length=use_len, axis=axis)
    if op == "SequenceMask":
        kw["value"] = -2.0
    if op == "SequenceReverse":
        kw.pop("axis")
    want = getattr(jmx.nd, op)(jmx.nd.array(x), jmx.nd.array(lens), **kw)
    got = getattr(tmx.nd, op)(tmx.nd.array(x), tmx.nd.array(lens), **kw)
    np.testing.assert_array_equal(got.asnumpy(), want.asnumpy())
    # gradients flow through the op as through the reference's
    xt = torch.tensor(x, requires_grad=True)
    out = tmx.ops.registry.get_op(op).fn(xt, torch.from_numpy(lens), **kw)
    g = torch.autograd.grad(out.sum(), xt)[0]
    jg = jax.grad(lambda a: jmx.ops.registry.get_op(op).fn(
        a, jnp.asarray(lens), **kw).sum())(jnp.asarray(x))
    np.testing.assert_array_equal(g.numpy(), np.asarray(jg))


# -- mx.rnn cells --------------------------------------------------------

def _cell(pkg, kind):
    r = pkg.rnn
    if kind == "rnn":
        return r.RNNCell(5, activation="relu", prefix="rnn_")
    if kind == "lstm":
        return r.LSTMCell(5, prefix="lstm_", forget_bias=0.5)
    if kind == "gru":
        return r.GRUCell(5, prefix="gru_")
    if kind == "fused_lstm":
        return r.FusedRNNCell(5, num_layers=2, mode="lstm",
                              bidirectional=True, get_next_state=True,
                              prefix="f_")
    if kind == "fused_gru":
        return r.FusedRNNCell(5, num_layers=2, mode="gru", prefix="g_")
    if kind == "stack":
        s = r.SequentialRNNCell()
        s.add(r.LSTMCell(5, prefix="l0_"))
        s.add(r.DropoutCell(0.3, prefix="d0_"))
        s.add(r.ResidualCell(r.LSTMCell(5, prefix="l1_")))
        return s
    if kind == "bidir":
        return r.BidirectionalCell(r.GRUCell(4, prefix="bl_"),
                                   r.LSTMCell(4, prefix="br_"))
    if kind == "zoneout":
        return r.ZoneoutCell(r.RNNCell(5, prefix="z_"), zoneout_outputs=0.3,
                             zoneout_states=0.2)
    raise ValueError(kind)


CELLS = ["rnn", "lstm", "gru", "fused_lstm", "fused_gru", "stack", "bidir",
         "zoneout"]


def _unrolled(pkg, kind, layout="NTC"):
    with pkg.name.NameManager():
        cell = _cell(pkg, kind)
        data = pkg.sym.Variable("data")
        if kind == "stack":   # the residual needs the input width
            data = pkg.sym.FullyConnected(data, num_hidden=5, flatten=False,
                                          name="proj")
        outs, states = cell.unroll(3, inputs=data, layout=layout,
                                   merge_outputs=True)
        return cell, pkg.sym.Group([outs] + list(states))


def _arg_values(sym, data_shape, seed=0):
    arg_shapes, _, _ = sym.infer_shape(data=data_shape)
    rs = np.random.RandomState(seed)
    return {n: (rs.randn(*s) * (0.4 if n != "data" else 1.0)).astype(
        np.float32) for n, s in zip(sym.list_arguments(), arg_shapes)}


# the cells whose training forward and gradients are held to the
# reference's (the rest: an inference forward; JSON bytes for all)
GRAD_CELLS = ("lstm", "fused_lstm")


def _forward_backward(pkg, sym, vals):
    ex = sym.simple_bind(ctx=pkg.cpu(), grad_req="write",
                         data=vals["data"].shape)
    for n, v in vals.items():
        ex.arg_dict[n][:] = v
    outs = ex.forward(is_train=True)
    rs = np.random.RandomState(9)
    cts = [rs.randn(*o.shape).astype(np.float32) for o in outs]
    ex.backward([pkg.nd.array(c) for c in cts])
    return ([o.asnumpy() for o in outs],
            {n: ex.grad_dict[n].asnumpy() for n in vals})


@pytest.mark.parametrize("kind", CELLS)
def test_cell_unroll_matches_reference(kind):
    _, jsym = _unrolled(jmx, kind)
    _, tsym = _unrolled(tmx, kind)
    assert tsym.tojson() == jsym.tojson()
    assert tsym.list_arguments() == jsym.list_arguments()
    shape = (3, 3, 5) if kind != "bidir" else (3, 3, 4)
    jshapes = jsym.infer_shape(data=shape)
    assert tsym.infer_shape(data=shape) == jshapes
    vals = _arg_values(jsym, shape)
    if kind not in GRAD_CELLS:
        # an inference forward (zoneout and dropout are random in training,
        # their keys folding in per-process node ids)
        for a, b in zip(chip_smoke._bound_outputs(tsym, vals, "cpu"),
                        chip_smoke._bound_outputs(jsym, vals, "cpu", jmx)):
            np.testing.assert_allclose(a, b, rtol=1e-5, atol=1e-5)
        return
    jo, jg = _forward_backward(jmx, jsym, vals)
    to, tg = _forward_backward(tmx, tsym, vals)
    for a, b in zip(to, jo):
        np.testing.assert_allclose(a, b, rtol=1e-5, atol=1e-5)
    for n in vals:
        np.testing.assert_allclose(tg[n], jg[n], rtol=1e-4, atol=1e-5,
                                   err_msg=n)


def test_cell_tnc_and_step_inputs():
    """TNC layout and a list of step inputs build the reference's graph."""
    for kind in ("lstm", "fused_lstm"):
        for layout in ("TNC", "NTC"):
            js = _unrolled(jmx, kind, layout)[1].tojson()
            assert _unrolled(tmx, kind, layout)[1].tojson() == js
    outs = []
    for pkg in (jmx, tmx):
        with pkg.name.NameManager():
            cell = pkg.rnn.GRUCell(3, prefix="s_")
            o, s = cell.unroll(3, inputs=None, merge_outputs=False)
            outs.append(pkg.sym.Group(o + s).tojson())
    assert outs[1] == outs[0]


def _blobs(pkg, kind, vals):
    arrs = {n: pkg.nd.array(v) for n, v in vals.items() if n != "data"}
    return _cell(pkg, kind), arrs


@pytest.mark.parametrize("kind", ["lstm", "gru", "fused_lstm", "bidir",
                                  "stack"])
def test_pack_unpack_weights(kind):
    _, jsym = _unrolled(jmx, kind)
    shape = (3, 3, 5) if kind != "bidir" else (3, 3, 4)
    vals = _arg_values(jsym, shape)
    jcell, jargs = _blobs(jmx, kind, vals)
    tcell, targs = _blobs(tmx, kind, vals)
    junp = jcell.unpack_weights(jargs)
    tunp = tcell.unpack_weights(targs)
    assert sorted(tunp) == sorted(junp)
    for n in junp:
        np.testing.assert_array_equal(tunp[n].asnumpy(), junp[n].asnumpy())
    back = tcell.pack_weights(tunp)
    assert sorted(back) == sorted(targs)
    for n in targs:
        np.testing.assert_array_equal(back[n].asnumpy(), targs[n].asnumpy())


# (a bidirectional stack cannot unroll: the reference's SequentialRNNCell
# steps its cells, and a BidirectionalCell refuses a step)
@pytest.mark.parametrize("mode,bi", [("lstm", False), ("gru", False),
                                     ("rnn_tanh", False)])
def test_fused_matches_unfused(mode, bi):
    with tmx.name.NameManager():
        fused = tmx.rnn.FusedRNNCell(4, num_layers=2, mode=mode,
                                     bidirectional=bi, prefix="fz_")
        fo, _ = fused.unroll(3, inputs=tmx.sym.Variable("data"),
                             layout="TNC", merge_outputs=True)
        uo, _ = fused.unfuse().unroll(3, inputs=tmx.sym.Variable("data"),
                                      layout="TNC", merge_outputs=True)
    vals = _arg_values(fo, (3, 2, 5))
    # the fused graph's begin states are auto-created arguments: zeros,
    # as the unfused cells' _state_zeros
    for n in vals:
        if "state" in n:
            vals[n][:] = 0
    want = chip_smoke._bound_outputs(fo, vals, "cpu")[0]
    unfused = chip_smoke._fused_to_unfused(vals["fz_parameters"], mode, 2, 5,
                                           4, bi, "fz_")
    assert sorted(unfused) == sorted(n for n in uo.list_arguments()
                                     if n != "data")
    got = chip_smoke._bound_outputs(uo, {**unfused, "data": vals["data"]},
                                    "cpu")[0]
    np.testing.assert_allclose(got, want, rtol=1e-5, atol=1e-6)


def test_rnn_checkpoint_bytes(tmp_path):
    _, jsym = _unrolled(jmx, "fused_lstm")
    vals = _arg_values(jsym, (3, 3, 5))
    files = []
    for pkg in (jmx, tmx):
        cell, sym = _unrolled(pkg, "fused_lstm")
        prefix = str(tmp_path / pkg.__name__)
        args = {n: pkg.nd.array(v) for n, v in vals.items() if n != "data"}
        pkg.rnn.save_rnn_checkpoint(cell, prefix, 3, sym, args, {})
        cb = pkg.rnn.do_rnn_checkpoint([cell], prefix + "-cb", period=2)
        cb(0, sym, args, {})
        cb(1, sym, args, {})
        files.append([open(f"{prefix}-symbol.json", "rb").read(),
                      open(f"{prefix}-0003.params", "rb").read(),
                      open(f"{prefix}-cb-0002.params", "rb").read()])
    assert files[1] == files[0]
    cell = _unrolled(tmx, "fused_lstm")[0]
    sym, arg, aux = tmx.rnn.load_rnn_checkpoint(
        cell, str(tmp_path / "mxnet_tpu"), 3)
    assert sym.tojson() == jsym.tojson()
    for n, v in vals.items():
        if n != "data":
            np.testing.assert_array_equal(arg[n].asnumpy(), v)


def test_bucket_sentence_iter_matches_reference():
    rs = np.random.RandomState(0)
    sents = [list(rs.randint(1, 30, size=rs.randint(2, 13)))
             for _ in range(90)]
    state = random.getstate()
    try:
        batches = []
        for pkg in (jmx, tmx):
            random.seed(5)
            it = pkg.rnn.BucketSentenceIter(sents, 4, buckets=[4, 8, 12],
                                            invalid_label=0)
            got = []
            for _ in range(2):    # two epochs: reset draws again
                for b in it:
                    got.append((b.bucket_key, b.data[0].asnumpy(),
                                b.label[0].asnumpy(), b.provide_data[0].shape))
                it.reset()
            batches.append((got, it.provide_data[0].shape,
                            it.default_bucket_key))
    finally:
        random.setstate(state)
    (jb, jpd, jkey), (tb, tpd, tkey) = batches
    assert (tpd, tkey) == (jpd, jkey)
    assert len(tb) == len(jb) > 10
    for (k1, d1, l1, s1), (k2, d2, l2, s2) in zip(tb, jb):
        assert (k1, s1) == (k2, s2)
        np.testing.assert_array_equal(d1, d2)
        np.testing.assert_array_equal(l1, l2)
