"""PyTorch port: ``NDArray`` and ``nd.save``/``nd.load`` against the JAX
package's.

The same numpy inputs (from a seed) go into both packages' NDArrays (the
port's on the CPU), through the same expression; float32 results agree to
rtol 1e-6 (atol 1e-6 where a result can be 0), integer results exactly.
Files: ``nd.save`` writes the same bytes in both packages, in both formats
(``"tpmx"`` and ``"mxnet"``), for float32, float16, int32, uint8 and
bfloat16 arrays, single, as a list and as a dict (the MXNet format has no
type flag for bfloat16: both packages refuse it there), and each package
loads the other's files.
"""
import numpy as np
import pytest
import torch

import mxnet_tpu as jmx
import mxnet_tpu_torch as tmx
from mxnet_tpu_torch import nd as tnd
from mxnet_tpu_torch.base import MXNetError

jnd = jmx.nd
TOL = dict(rtol=1e-6, atol=1e-6)


@pytest.fixture(autouse=True)
def _cpu():
    with tmx.cpu():
        yield


def _pair(a):
    return jnd.array(a), tnd.array(a, ctx=tmx.cpu())


def _check(want, got, exact=False):
    if isinstance(want, (tuple, list)):
        assert len(want) == len(got)
        for w, g in zip(want, got):
            _check(w, g, exact)
        return
    assert isinstance(got, tnd.NDArray)
    w, g = want.asnumpy(), got.asnumpy()
    assert w.shape == g.shape, (w.shape, g.shape)
    assert w.dtype == g.dtype, (w.dtype, g.dtype)
    if exact:
        np.testing.assert_array_equal(g, w)
    else:
        np.testing.assert_allclose(g, w, **TOL)


def _data(dtype, shape=(3, 4), seed=0, positive=False):
    rs = np.random.RandomState(seed)
    if np.dtype(dtype).kind == "f":
        a = rs.randn(*shape)
        if positive:
            a = np.abs(a) + 0.5
        return a.astype(dtype)
    return rs.randint(1 if positive else -5, 9, size=shape).astype(dtype)


BINARY = {
    "add": lambda a, b: a + b, "sub": lambda a, b: a - b,
    "mul": lambda a, b: a * b, "div": lambda a, b: a / b,
    "mod": lambda a, b: a % b, "pow": lambda a, b: a ** b,
    "eq": lambda a, b: a == b, "ne": lambda a, b: a != b,
    "gt": lambda a, b: a > b, "ge": lambda a, b: a >= b,
    "lt": lambda a, b: a < b, "le": lambda a, b: a <= b,
}


@pytest.mark.parametrize("dtype", ["float32", "int32"])
@pytest.mark.parametrize("op", sorted(BINARY))
def test_binary_operators(op, dtype):
    f = BINARY[op]
    positive = op in ("div", "mod", "pow")   # no zero divisors
    a = _data(dtype, seed=1, positive=positive)
    b = _data(dtype, seed=2, positive=positive)
    if op == "pow" and dtype == "int32":
        b = b % 3
    ja, ta = _pair(a)
    jb, tb = _pair(b)
    exact = dtype == "int32" and op != "div"
    _check(f(ja, jb), f(ta, tb), exact)
    # scalars on either side, broadcasting a row
    _check(f(ja, 2), f(ta, 2), exact)
    if op not in ("eq", "ne", "gt", "ge", "lt", "le"):
        _check(f(3, ja), f(3, ta), exact)
    jr, tr = _pair(b[:1])
    _check(f(ja, jr), f(ta, tr), exact)


METHODS = {
    "sum": lambda x: x.sum(), "sum_axis": lambda x: x.sum(axis=1),
    "sum_keep": lambda x: x.sum(axis=0, keepdims=True),
    "mean": lambda x: x.mean(axis=(0, 2)), "max": lambda x: x.max(axis=1),
    "min": lambda x: x.min(), "prod": lambda x: x.prod(axis=2),
    "norm": lambda x: x.norm(), "norm1": lambda x: x.norm(ord=1, axis=1),
    "argmax": lambda x: x.argmax(axis=1), "argmin": lambda x: x.argmin(),
    "abs": lambda x: x.abs(), "square": lambda x: x.square(),
    "exp": lambda x: x.exp(), "sigmoid": lambda x: x.sigmoid(),
    "tanh": lambda x: x.tanh(), "relu": lambda x: x.relu(),
    "sign": lambda x: x.sign(), "neg": lambda x: -x,
    "softmax": lambda x: x.softmax(), "log_softmax":
    lambda x: x.log_softmax(axis=1), "clip": lambda x: x.clip(-0.5, 0.5),
    "reshape": lambda x: x.reshape((4, 6)),
    "reshape_codes": lambda x: x.reshape((0, -3)),
    "reshape_split": lambda x: x.reshape((-4, 1, 2, -2)),
    "reshape_infer": lambda x: x.reshape(-1, 4),
    "transpose": lambda x: x.transpose(), "T": lambda x: x.T,
    "transpose_axes": lambda x: x.transpose((1, 0, 2)),
    "swapaxes": lambda x: x.swapaxes(0, 2),
    "flatten": lambda x: x.flatten(),
    "expand_dims": lambda x: x.expand_dims(1),
    "squeeze": lambda x: x.reshape((2, 1, 12)).squeeze(),
    "broadcast_to": lambda x: x[:, :1].broadcast_to((2, 3, 4)),
    "flip": lambda x: x.flip(1), "tile": lambda x: x.tile((1, 2, 1)),
    "repeat": lambda x: x.repeat(2, axis=2),
    "split": lambda x: x.split(2, axis=2),
    "slice": lambda x: x.slice((0, 1), (2, 3)),
    "slice_axis": lambda x: x.slice_axis(2, 1, 3),
    "one_hot": lambda x: (x.abs() * 2).one_hot(5),
    "zeros_like": lambda x: x.zeros_like(),
    "ones_like": lambda x: x.ones_like(),
    "astype": lambda x: (x * 3).astype("int32"),
    "copy": lambda x: x.copy(),
}


@pytest.mark.parametrize("name", sorted(METHODS))
def test_methods(name):
    x = _data("float32", (2, 3, 4), seed=3)
    jx, tx = _pair(x)
    f = METHODS[name]
    _check(f(jx), f(tx), exact=name in ("argmax", "argmin", "astype"))


def test_dot_take_and_sqrt_log():
    a, b = _data("float32", (3, 4), 4), _data("float32", (4, 5), 5)
    ja, ta = _pair(a)
    jb, tb = _pair(b)
    _check(ja.dot(jb), ta.dot(tb))
    _check(jnd.dot(ja, jb, transpose_b=False), tnd.dot(ta, tb))
    idx = np.array([2, 0, 2], np.int32)
    _check(ja.take(jnd.array(idx)), ta.take(tnd.array(idx)))
    p = _data("float32", (3, 4), 6, positive=True)
    jp, tp = _pair(p)
    _check(jp.sqrt(), tp.sqrt())
    _check(jp.log(), tp.log())


def test_creation_and_namespace():
    _check(jnd.zeros((2, 3)), tnd.zeros((2, 3)), exact=True)
    _check(jnd.ones(4, dtype="int32"), tnd.ones(4, dtype="int32"),
           exact=True)
    _check(jnd.full((2, 2), 7.5), tnd.full((2, 2), 7.5), exact=True)
    _check(jnd.arange(1, 10, 2.5), tnd.arange(1, 10, 2.5), exact=True)
    _check(jnd.arange(3, repeat=2), tnd.arange(3, repeat=2), exact=True)
    _check(jnd.eye(3, 4, 1), tnd.eye(3, 4, 1), exact=True)
    x = _data("float32", (2, 3), 7)
    jx, tx = _pair(x)
    _check(jnd.zeros_like(jx), tnd.zeros_like(tx), exact=True)
    _check(jnd.broadcast_add(jx, jx), tnd.broadcast_add(tx, tx))
    _check(jnd.concat(jx, jx, dim=0), tnd.concat(tx, tx, dim=0))
    _check(jnd.stack(jx, jx, axis=1), tnd.stack(tx, tx, axis=1))
    _check(jnd.clip(jx, 0, 0.5), tnd.clip(tx, 0, 0.5))
    _check(jnd.sum(jx, axis=1), tnd.sum(tx, axis=1))
    # the same wrapper on tensors (a block's F) returns a tensor
    got = tnd.broadcast_add(torch.from_numpy(x), torch.from_numpy(x))
    assert isinstance(got, torch.Tensor)
    np.testing.assert_allclose(got.numpy(), (jx + jx).asnumpy(), **TOL)


def test_properties_and_conversions():
    x = _data("float32", (2, 3), 8)
    jx, tx = _pair(x)
    assert tx.shape == jx.shape and tx.size == jx.size
    assert tx.ndim == jx.ndim and tx.dtype == jx.dtype == np.float32
    assert tx.context == tmx.cpu(0) and len(tx) == 2
    assert tx[1, 2].asscalar() == jx[1, 2].asscalar()
    assert float(tx[0, 0]) == float(jx[0, 0])
    assert tx.astype("bfloat16").dtype == "bfloat16"
    with pytest.raises(MXNetError, match="bfloat16"):
        tx.astype("bfloat16").asnumpy()
    np.testing.assert_array_equal(np.asarray(tx), x)
    tx.wait_to_read()
    tnd.waitall()
    d = tx.detach()
    c = tx.copyto(tmx.cpu())
    tx += 1.0
    np.testing.assert_array_equal(d.asnumpy(), x)   # values, not aliases
    np.testing.assert_array_equal(c.asnumpy(), x)
    dst = tnd.zeros((2, 3))
    assert tx.copyto(dst) is dst
    np.testing.assert_array_equal(dst.asnumpy(), x + 1)


def test_indexing():
    x = _data("float32", (4, 5), 9)
    jx, tx = _pair(x)
    keys = [1, -1, slice(1, 3), (slice(None), 2), (1, slice(None, None, -1)),
            (slice(None, None, 2), slice(1, 4)), [0, 2, 3],
            np.array([3, 1])]
    for k in keys:
        _check(jx[k], tx[k], exact=True)
    _check(jx[jnd.array([2.0, 0.0])], tx[tnd.array([2.0, 0.0])], exact=True)


@pytest.mark.parametrize("case", ["scalar", "row", "array", "full", "nd"])
def test_setitem(case):
    x = _data("float32", (4, 5), 10)
    jx, tx = _pair(x)
    key, value = {
        "scalar": ((1, 2), 3.5),
        "row": (2, 7.0),
        "array": ((slice(1, 3), slice(0, 2)), np.ones((2, 2), np.float32)),
        "full": (slice(None), np.arange(5, dtype=np.float32)),
        "nd": (0, None),
    }[case]
    if case == "nd":
        jv, tv = _pair(np.full(5, -2.0, np.float32))
        jx[key] = jv
        tx[key] = tv
    else:
        jx[key] = value
        tx[key] = value
    _check(jx, tx, exact=True)


@pytest.mark.parametrize("op", ["iadd", "isub", "imul", "itruediv"])
def test_inplace_operators(op):
    x = _data("float32", (3, 4), 11)
    y = _data("float32", (3, 4), 12, positive=True)
    jx, tx = _pair(x)
    jy, ty = _pair(y)
    view = tx.reshape((12,))   # taken before the write: keeps the old value
    for (a, b) in ((jx, jy), (tx, ty)):
        handle = a
        if op == "iadd":
            a += b
            a += 2
        elif op == "isub":
            a -= b
            a -= 2
        elif op == "imul":
            a *= b
            a *= 2
        else:
            a /= b
            a /= 2
        assert a is handle
    _check(jx, tx)
    np.testing.assert_array_equal(view.asnumpy(), x.reshape(12))


# ---------------------------------------------------------------------------
# files
# ---------------------------------------------------------------------------

DTYPES = ["float32", "float16", "int32", "uint8", "bfloat16"]


def _arrays(dtype, n=3):
    out = []
    for i, shape in enumerate([(2, 3), (5,), (1, 2, 2)][:n]):
        a = _data("float32" if dtype == "bfloat16" else dtype, shape,
                  20 + i)
        if dtype == "bfloat16":
            a = a * 3.1   # values that bfloat16 rounds
            out.append((jnd.array(a).astype("bfloat16"),
                        tnd.array(a).astype("bfloat16")))
        else:
            out.append(_pair(a))
    return out


def _container(pairs, kind, side):
    arrs = [p[side] for p in pairs]
    if kind == "single":
        return arrs[0]
    if kind == "list":
        return arrs
    return {f"arg:w{i}": a for i, a in enumerate(arrs)}


def _bits(a):
    """Comparable numpy bits of either package's array."""
    if isinstance(a, tnd.NDArray):
        if a._data.dtype == torch.bfloat16:
            return a._data.view(torch.int16).numpy()
        return a.asnumpy()
    v = a.asnumpy()
    return v.view(np.int16) if v.dtype.name == "bfloat16" else v


def _same_values(want, got):
    if isinstance(want, dict):
        assert list(want) == list(got)
        want, got = list(want.values()), list(got.values())
    if not isinstance(want, list):
        want, got = [want], [got]
    assert len(want) == len(got)
    for w, g in zip(want, got):
        np.testing.assert_array_equal(_bits(g), _bits(w))


@pytest.mark.parametrize("kind", ["single", "list", "dict"])
@pytest.mark.parametrize("fmt", ["tpmx", "mxnet"])
@pytest.mark.parametrize("dtype", DTYPES)
def test_save_bytes_match_and_cross_load(tmp_path, dtype, fmt, kind):
    pairs = _arrays(dtype)
    jdata, tdata = _container(pairs, kind, 0), _container(pairs, kind, 1)
    jf, tf = tmp_path / "j.nd", tmp_path / "t.nd"
    if fmt == "mxnet" and dtype == "bfloat16":
        # the MXNet format has no type flag for bfloat16, in either package
        with pytest.raises(KeyError):
            jnd.save(str(jf), jdata, format=fmt)
        with pytest.raises(MXNetError, match="bfloat16"):
            tnd.save(str(tf), tdata, format=fmt)
        return
    jnd.save(str(jf), jdata, format=fmt)
    tnd.save(str(tf), tdata, format=fmt)
    assert tf.read_bytes() == jf.read_bytes()
    # each package loads the other's file
    got = tnd.load(str(jf), ctx=tmx.cpu())
    want = jnd.load(str(tf))
    if fmt == "mxnet" and kind == "single":
        jdata, tdata = [jdata], [tdata]   # stored as a list of one
    _same_values(jdata, got)
    _same_values(want, tdata)


def test_load_refuses_other_files(tmp_path):
    f = tmp_path / "bad.nd"
    f.write_bytes(b"not an array file")
    with pytest.raises(ValueError, match="not a tpu-mx or MXNet"):
        tnd.load(str(f), ctx=tmx.cpu())
