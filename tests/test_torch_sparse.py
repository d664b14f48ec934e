"""PyTorch port: sparse storage (``nd.sparse``: row_sparse and csr arrays,
``cast_storage``, ``retain``, ``dot``), the row-sparse kvstore
(``row_sparse_pull``, the compacted reduce), ``LibSVMIter``, csr
arguments of the executor (``Module.fit`` over LibSVM batches), the
sparse and non-detection ``_contrib_*`` ops, ``gluon.contrib.nn`` and the
``contrib`` namespaces, against the JAX package.

The cases mirror the reference's own sparse tests
(``tests/test_metric_io_kvstore.py``, ``tests/test_core_fixes.py``,
``tests/test_spatial_ops.py``, ``tests/test_mxnet_checkpoint_interop.py``
and ``tests/test_train.py::test_sparse_linear_convergence``): the same
numpy inputs through both packages, values within f32 rtol 1e-5 (1e-4
for fitted parameters), indices, pads and file bytes exact.
"""
import os
import types

import numpy as np
import pytest
import torch

import mxnet_tpu as jmx
import mxnet_tpu_torch as tmx
from mxnet_tpu.ndarray import sparse as jsp
from mxnet_tpu_torch.base import MXNetError
from mxnet_tpu_torch.ndarray import sparse as tsp

TOL = dict(rtol=1e-5, atol=1e-6)
ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


@pytest.fixture(autouse=True)
def _cpu():
    with tmx.cpu():
        yield


def _np(a):
    return np.asarray(a.asnumpy())


def _same(t, j, exact=False):
    a, b = _np(t), _np(j)
    assert a.shape == b.shape, (a.shape, b.shape)
    assert a.dtype == b.dtype, (a.dtype, b.dtype)
    if exact:
        np.testing.assert_array_equal(a, b)
    else:
        np.testing.assert_allclose(a, b, **TOL)


# ---------------------------------------------------------------------------
# the arrays (tests/test_metric_io_kvstore.py, tests/test_core_fixes.py)
# ---------------------------------------------------------------------------

def test_row_sparse_basics():
    dense = np.zeros((5, 3), np.float32)
    dense[1] = 1
    dense[3] = 2
    for mx, sp in ((tmx, tsp), (jmx, jsp)):
        rsp = sp.row_sparse_array(dense)
        assert rsp.stype == "row_sparse" and rsp.shape == (5, 3)
        assert np.allclose(rsp.asnumpy(), dense)
        back = rsp.tostype("default")
        assert back.stype == "default"
        assert np.allclose(back.asnumpy(), dense)
    t = tsp.row_sparse_array((np.ones((2, 3), np.float32), np.array([1, 4])),
                             shape=(6, 3))
    j = jsp.row_sparse_array((np.ones((2, 3), np.float32), np.array([1, 4])),
                             shape=(6, 3))
    _same(t, j, exact=True)
    _same(t.indices, j.indices, exact=True)
    _same(t.data, j.data, exact=True)
    assert (t.dtype, t.size, t.ndim) == (j.dtype, j.size, len(j.shape))
    assert t.context == tmx.cpu()
    # the padded slots drop out of indices and data
    pad = tsp.RowSparseNDArray(torch.ones(3, 2), torch.tensor(
        [2, -1, 0], dtype=torch.int32), (4, 2))
    np.testing.assert_array_equal(pad.indices.asnumpy(), [2, 0])
    assert pad.data.shape == (2, 2)
    np.testing.assert_array_equal(pad.asnumpy()[[0, 2]], 1)


def test_csr_basics():
    dense = np.array([[1, 0, 2], [0, 0, 3]], np.float32)
    t, j = tsp.csr_matrix(dense), jsp.csr_matrix(dense)
    assert t.stype == "csr" and t.data.shape == (3,)
    _same(t, j, exact=True)
    for a in ("data", "indices", "indptr"):
        _same(getattr(t, a), getattr(j, a), exact=True)
    rhs = np.arange(6, dtype=np.float32).reshape(3, 2)
    _same(tsp.dot(t, tmx.nd.array(rhs)), jsp.dot(j, jmx.nd.array(rhs)))
    lhs2 = np.arange(4, dtype=np.float32).reshape(2, 2)
    _same(tsp.dot(t, tmx.nd.array(lhs2), transpose_a=True),
          jsp.dot(j, jmx.nd.array(lhs2), transpose_a=True))
    # [a:b] is a csr array, [i] a dense row
    for key in (slice(0, 1), slice(1, 2), 1):
        tk, jk = t[key], j[key]
        _same(tk, jk, exact=True)
        assert type(tk).__name__ == type(jk).__name__
    # the (data, indices, indptr) triple and a scipy matrix (float32 data)
    import scipy.sparse as ss

    trip = (np.array([5., 6., 7.], np.float32), np.array([0, 2, 1]),
            np.array([0, 2, 2, 3]))
    _same(tsp.csr_matrix(trip, shape=(3, 3)),
          jsp.csr_matrix(trip, shape=(3, 3)), exact=True)
    m = ss.random(6, 5, density=0.4, random_state=0, format="csr")
    tm, jm = tsp.csr_matrix(m), jsp.csr_matrix(m)
    _same(tm, jm, exact=True)
    assert tm.data.dtype == np.float32


def test_cast_storage_roundtrip():
    x = np.diag([1.0, 2, 3]).astype(np.float32)
    for mx in (tmx, jmx):
        a = mx.nd.array(x)
        csr, rsp = a.tostype("csr"), a.tostype("row_sparse")
        assert (csr.stype, rsp.stype) == ("csr", "row_sparse")
        assert np.allclose(csr.asnumpy(), x)
        assert np.allclose(rsp.asnumpy(), x)
        assert np.allclose(csr.tostype("default").asnumpy(), x)
        assert mx.nd.cast_storage(a, "row_sparse").stype == "row_sparse"
        assert a.tostype("default") is a
    z = tmx.nd.zeros((4, 2), stype="row_sparse")
    jz = jmx.nd.zeros((4, 2), stype="row_sparse")
    assert (z.stype, z.indices_.shape, z.values_.shape) == (
        jz.stype, tuple(jz.indices_.shape), tuple(jz.values_.shape))
    assert tmx.nd.zeros((3, 5), stype="csr").indptr.shape == (4,)


def test_row_sparse_overflow_semantics():
    """Eager accumulation compacts (one slot a distinct row); a dense
    write keeps the rows outside the old pattern."""
    results = {}
    for name, sp in (("t", tsp), ("j", jsp)):
        acc = sp.row_sparse_array(
            (np.ones((2, 3), np.float32), np.array([1, 4])), shape=(6, 3))
        one = sp.row_sparse_array(
            (np.ones((2, 3), np.float32), np.array([4, 1])), shape=(6, 3))
        for _ in range(10):
            acc = sp.elemwise_add(acc, one)
        assert acc.indices_.shape[0] == 2
        results[name] = acc
    _same(results["t"], results["j"], exact=True)
    np.testing.assert_array_equal(results["t"].indices_.numpy(),
                                  np.asarray(results["j"].indices_))

    dup = tsp.RowSparseNDArray(torch.ones(3, 2), torch.tensor(
        [2, 2, 0], dtype=torch.int32), (4, 2))
    dup.compact()
    assert dup.indices_.shape[0] == 2
    np.testing.assert_array_equal(dup.indices_.numpy(), [0, 2])
    assert np.allclose(dup.asnumpy()[2], 2.0)

    r = tsp.row_sparse_array((np.ones((1, 2), np.float32), np.array([0])),
                             shape=(4, 2))
    new = np.zeros((4, 2), np.float32)
    new[3] = 7.0
    r._data = torch.from_numpy(new)
    assert np.allclose(r.asnumpy(), new), "the write dropped row 3"
    np.testing.assert_array_equal(r.indices.asnumpy(), [3])
    r[:] = np.ones((4, 2), np.float32)
    assert r.indices_.shape[0] == 4
    # elemwise_add of dense operands is dense
    _same(tsp.elemwise_add(tmx.nd.array(new), tmx.nd.array(new)),
          jsp.elemwise_add(jmx.nd.array(new), jmx.nd.array(new)))


def test_retain_and_sparse_dot_dense_rhs():
    w = np.arange(12, dtype=np.float32).reshape(4, 3)
    t = tsp.retain(tsp.row_sparse_array(w), tmx.nd.array([1, 3]))
    j = jsp.retain(jsp.row_sparse_array(w), jmx.nd.array([1, 3]))
    _same(t, j, exact=True)
    np.testing.assert_array_equal(t.indices.asnumpy(), j.indices.asnumpy())
    lhs = np.ones((2, 4), np.float32)
    _same(tsp.dot(tmx.nd.array(lhs), tsp.row_sparse_array(w)),
          jsp.dot(jmx.nd.array(lhs), jsp.row_sparse_array(w)))


# ---------------------------------------------------------------------------
# the kvstore
# ---------------------------------------------------------------------------

def test_kvstore_row_sparse_pull():
    w = np.arange(12).reshape(4, 3).astype(np.float32)
    outs = []
    for mx in (tmx, jmx):
        kv = mx.kv.create("local")
        kv.init("emb", mx.nd.array(w))
        out = mx.nd.zeros((4, 3))
        kv.row_sparse_pull("emb", out=out, row_ids=mx.nd.array([1, 3]))
        outs.append(out)
    _same(*outs, exact=True)
    expect = np.zeros_like(w)
    expect[[1, 3]] = w[[1, 3]]
    np.testing.assert_array_equal(outs[0].asnumpy(), expect)


def test_row_sparse_pull_per_output_row_ids():
    got = []
    for mx in (tmx, jmx):
        kv = mx.kv.create("local")
        kv.init(101, mx.nd.array(np.arange(9, dtype=np.float32).reshape(3, 3)))
        o1, o2 = mx.nd.zeros((3, 3)), mx.nd.zeros((3, 3))
        kv.row_sparse_pull(101, out=[o1, o2],
                           row_ids=[mx.nd.array([0]), mx.nd.array([2])])
        got.append((o1, o2))
    for a, b in zip(*got):
        _same(a, b, exact=True)
    np.testing.assert_allclose(got[0][0].asnumpy()[0], [0, 1, 2])
    np.testing.assert_allclose(got[0][1].asnumpy()[2], [6, 7, 8])


def test_kvstore_row_sparse_accumulation_bounded():
    """A reduce over row-sparse pushes holds one row a distinct touched
    row; a row-sparse pull of every row gives the dense sum."""
    got = []
    for mx, sp in ((tmx, tsp), (jmx, jsp)):
        kv = mx.kv.create("local")
        kv.init("emb", sp.zeros("row_sparse", (10, 4)))
        kv.push("emb", [sp.row_sparse_array(
            (np.full((2, 4), float(i + 1), np.float32),
             np.array([1, 5 + i])), shape=(10, 4)) for i in range(3)])
        merged = kv._store["emb"]
        assert isinstance(merged, sp.RowSparseNDArray)
        assert merged.indices_.shape[0] == 4
        out = sp.zeros("row_sparse", (10, 4))
        kv.row_sparse_pull("emb", out=out,
                           row_ids=mx.nd.array(np.arange(10)))
        dense = mx.nd.zeros((10, 4))
        kv.pull("emb", out=dense)
        got.append((out, dense))
    _same(got[0][0], got[1][0], exact=True)
    _same(got[0][1], got[1][1], exact=True)
    oracle = np.zeros((10, 4), np.float32)
    for i in range(3):
        oracle[1] += i + 1
        oracle[5 + i] += i + 1
    np.testing.assert_array_equal(got[0][0].asnumpy(), oracle)


def test_kvstore_sparse_update_matches_dense_rule():
    """With an optimizer on the store, a row-sparse gradient updates a
    row-sparse weight by the dense rule (the per-parameter loop)."""
    rs = np.random.RandomState(0)
    w = rs.randn(6, 3).astype(np.float32)
    g = np.zeros((6, 3), np.float32)
    g[[1, 4]] = rs.randn(2, 3)
    got = []
    for mx, sp in ((tmx, tsp), (jmx, jsp)):
        kv = mx.kv.create("local")
        kv.set_optimizer(mx.optimizer.create("sgd", learning_rate=0.1,
                                             momentum=0.9, wd=0.01))
        kv.init(0, sp.row_sparse_array(w))
        for _ in range(2):
            kv.push(0, sp.row_sparse_array(g))
        out = mx.nd.zeros((6, 3))
        kv.pull(0, out=out)
        got.append(out)
    _same(*got)


# ---------------------------------------------------------------------------
# the sparse ops and files
# ---------------------------------------------------------------------------

def test_sparse_retain_and_scatter_ops_numeric():
    from mxnet_tpu.ops.registry import get_op as jget
    from mxnet_tpu_torch.ops.registry import get_op as tget
    import jax.numpy as jnp

    x = np.array([[1, 2], [3, 4], [5, 6]], np.float32)
    y = np.array([0.0, 2.0, 0.0, -1.0], np.float32)
    d = np.array([1.0, 2.0, 3.0, 4.0], np.float32)
    cases = [("_sparse_retain", (x, np.array([0, 2])), {}),
             ("_scatter_plus_scalar", (y,), {"scalar": 5.0}),
             ("_scatter_minus_scalar", (y,), {"scalar": 5.0}),
             ("_scatter_elemwise_div", (y, d), {}),
             ("_scatter_set_nd", (x, np.array([9., 8.], np.float32),
                                  np.array([[0, 2], [1, 0]])), {}),
             ("cast_storage", (x,), {"stype": "row_sparse"})]
    for name, args, kw in cases:
        want = np.asarray(jget(name).fn(*[jnp.asarray(a) for a in args],
                                        **kw))
        got = tget(name).fn(*[torch.from_numpy(np.asarray(a))
                              for a in args], **kw).numpy()
        assert got.dtype == want.dtype, name
        np.testing.assert_allclose(got, want, **TOL, err_msg=name)
    np.testing.assert_allclose(
        tget("_sparse_retain").fn(torch.from_numpy(x), torch.tensor([0, 2]))
        .numpy(), [[1, 2], [0, 0], [5, 6]])


def test_row_sparse_and_csr_round_trip(tmp_path):
    """``nd.save(format="mxnet")`` of sparse arrays: the reference's bytes,
    and each package loads the other's file."""
    vals = (np.array([[1., 2.], [3., 4.]], np.float32), np.array([1, 3]))
    trip = (np.array([5., 6., 7.], np.float32), np.array([0, 2, 1]),
            np.array([0, 2, 2, 3]))
    files = {}
    for name, mx, sp in (("t", tmx, tsp), ("j", jmx, jsp)):
        rsp = sp.row_sparse_array(vals, shape=(5, 2))
        csr = sp.csr_matrix(trip, shape=(3, 3))
        files[name] = str(tmp_path / f"{name}.params")
        mx.nd.save(files[name], {"rsp": rsp, "csr": csr}, format="mxnet")
    with open(files["t"], "rb") as a, open(files["j"], "rb") as b:
        assert a.read() == b.read()
    back = tmx.nd.load(files["j"])
    ref = jmx.nd.load(files["t"])
    assert back["rsp"].stype == "row_sparse" and back["csr"].stype == "csr"
    for k in ("rsp", "csr"):
        _same(back[k], ref[k], exact=True)
    np.testing.assert_array_equal(back["csr"].indptr.asnumpy(), trip[2])
    # the default format writes the dense values
    tmx.nd.save(str(tmp_path / "d.tpmx"), {"rsp": back["rsp"]})
    jmx.nd.save(str(tmp_path / "d.jax"), {"rsp": ref["rsp"]})
    with open(tmp_path / "d.tpmx", "rb") as a, \
            open(tmp_path / "d.jax", "rb") as b:
        assert a.read() == b.read()


# the 17 names this slice registers: (name, input shapes, attrs); the
# first input's values are shaped for the op
_NEW_OPS = [
    ("cast_storage", [(3, 4)], {"stype": "default"}),
    ("_sparse_retain", [(5, 3), "rows"], {}),
    ("_scatter_plus_scalar", ["sparse"], {"scalar": 1.5}),
    ("_scatter_minus_scalar", ["sparse"], {"scalar": 0.5}),
    ("_scatter_elemwise_div", ["sparse", "pos"], {}),
    ("_scatter_set_nd", [(4, 3), (2,), "nd_index"], {}),
    ("_contrib_SparseEmbedding", ["ids", (10, 4)],
     {"input_dim": 10, "output_dim": 4}),
    ("_contrib_getnnz", ["sparse"], {}),
    ("_contrib_arange_like", [(2, 3)], {"start": 1.0, "step": 0.5}),
    ("_contrib_index_copy", [(5, 3), "rows", (2, 3)], {}),
    ("_contrib_div_sqrt_dim", [(2, 3, 8)], {}),
    ("_contrib_quadratic", [(3, 4)], {"a": 0.5, "b": -1.0, "c": 2.0}),
    ("quadratic", [(3, 4)], {"a": 1.5, "b": 0.0, "c": -1.0}),
    ("_contrib_count_sketch", [(3, 6), "hash", "sign"], {"out_dim": 4}),
    ("_contrib_fft", [(2, 8)], {}),
    ("_contrib_ifft", [(2, 16)], {}),
    ("_contrib_SyncBatchNorm", [(4, 3, 2, 2), (3,), (3,), (3,), "var"],
     {"fix_gamma": False}),
]


def _op_inputs(specs, rs):
    out = []
    for s in specs:
        if isinstance(s, tuple):
            out.append(rs.randn(*s).astype(np.float32))
        elif s == "rows":
            out.append(np.array([0, 3], np.int32))
        elif s == "sparse":
            v = rs.randn(6).astype(np.float32)
            v[[0, 3]] = 0
            out.append(v)
        elif s == "pos":
            out.append(rs.rand(6).astype(np.float32) + 0.5)
        elif s == "nd_index":
            out.append(np.array([[0, 2], [1, 0]], np.int32))
        elif s == "ids":
            out.append(np.array([[1, 9], [3, 3]], np.float32))
        elif s == "hash":
            out.append(np.array([0, 3, 1, 1, 2, 0], np.float32))
        elif s == "sign":
            out.append(np.array([1, -1, 1, 1, -1, 1], np.float32))
        elif s == "var":
            out.append(rs.rand(3).astype(np.float32) + 0.5)
    return out


@pytest.mark.parametrize("name,specs,attrs", _NEW_OPS,
                         ids=[c[0] for c in _NEW_OPS])
def test_new_op_names(name, specs, attrs):
    """Each added name against the reference's op: output dtype and
    values, and the gradient of ``sum(out * c)`` for its float inputs."""
    import jax
    import jax.numpy as jnp
    from mxnet_tpu.ops.registry import OP_REGISTRY as JREG
    from mxnet_tpu_torch.ops.registry import OP_REGISTRY as TREG

    jop, top = JREG[name], TREG[name]
    assert top.name == jop.name and set(top.aliases) == set(jop.aliases)
    rs = np.random.RandomState(len(name))
    ins = _op_inputs(specs, rs)
    kw = dict(attrs)
    if "_training" in str(jop.fn.__code__.co_varnames):
        kw["_training"] = True
    fl = [i for i, a in enumerate(ins) if a.dtype == np.float32]

    def f(*fargs):
        full = [jnp.asarray(a) for a in ins]
        for i, v in zip(fl, fargs):
            full[i] = v
        return jop.fn(*full, **kw)

    want, vjp = jax.vjp(f, *[jnp.asarray(ins[i]) for i in fl])
    t_ins = [torch.from_numpy(a).requires_grad_(a.dtype == np.float32)
             for a in ins]
    got = top.fn(*t_ins, **kw)
    assert str(got.dtype).split(".")[-1] == str(want.dtype), name
    np.testing.assert_allclose(got.detach().numpy(), np.asarray(want),
                               rtol=1e-5, atol=1e-5, err_msg=name)
    if not jop.differentiable:
        return
    c = rs.randn(*np.asarray(want).shape).astype(np.float32)
    jg = vjp(jnp.asarray(c, dtype=want.dtype))
    tg = torch.autograd.grad((got * torch.from_numpy(c)).sum(),
                             [t_ins[i] for i in fl], allow_unused=True)
    for i, a, b in zip(fl, tg, jg):
        a = np.zeros_like(ins[i]) if a is None else a.numpy()
        np.testing.assert_allclose(a, np.asarray(b), rtol=1e-5, atol=1e-5,
                                   err_msg=f"{name} grad {i}")


def test_registry_shares_the_new_names():
    from mxnet_tpu.ops.registry import OP_REGISTRY as JREG
    from mxnet_tpu_torch.ops.registry import OP_REGISTRY as TREG

    for name, _, _ in _NEW_OPS:
        assert name in TREG and TREG[name].name == JREG[name].name
    assert "quadratic" in dir(tmx.sym.contrib)
    assert tmx.nd.contrib.getnnz is tmx.nd._contrib_getnnz
    assert tmx.contrib.ndarray.fft is tmx.nd._contrib_fft
    assert tmx.contrib.symbol.foreach is tmx.sym.contrib.foreach
    assert tmx.sym.contrib._contrib_SyncBatchNorm is not None


# ---------------------------------------------------------------------------
# LibSVMIter and Module.fit over csr batches
# ---------------------------------------------------------------------------

def _libsvm_file(path, rows, features, seed):
    """``example/sparse/linear_classification.py``'s synthetic rows, with
    one repeated index and one explicit zero thrown in."""
    rs = np.random.RandomState(seed)
    w_true = rs.randn(features)
    with open(path, "w") as f:
        for r in range(rows):
            nnz = rs.randint(5, 20 if features >= 20 else features)
            idx = np.sort(rs.choice(features, nnz, replace=False))
            val = rs.randn(nnz)
            label = 1 if float(val @ w_true[idx]) > 0 else 0
            feats = " ".join(f"{i}:{v:.4f}" for i, v in zip(idx, val))
            if r == 2:
                feats += f" {idx[0]}:0.5 {idx[1]}:0"
            f.write(f"{label} {feats}\n")
    return path


def test_libsvm_iter_batches_and_pad(tmp_path):
    path = _libsvm_file(str(tmp_path / "a.libsvm"), 70, 30, 1)
    kw = dict(data_libsvm=path, data_shape=(30,), batch_size=16,
              label_name="softmax_label")
    ti, ji = tmx.io.LibSVMIter(**kw), jmx.io.LibSVMIter(**kw)
    assert [tuple(d) for d in ti.provide_data] == \
        [tuple(d) for d in ji.provide_data]
    assert ti.provide_data[0].dtype == ji.provide_data[0].dtype
    assert ti.provide_label[0].dtype == ji.provide_label[0].dtype
    want = [(jb.data[0], jb.label[0], jb.pad) for jb in ji]
    assert len(want) == 5 and want[-1][2] == 10
    for epoch in range(2):   # the second after reset() serves the same
        got = list(ti)
        assert len(got) == len(want)
        for tb, (jd, jl, jpad) in zip(got, want):
            td = tb.data[0]
            assert td.stype == "csr" and td.shape == jd.shape
            # the reference's stored arrays as they are (its dense view
            # compiles anew for every nnz): values, columns, row pointers
            for a in ("data", "indices", "indptr"):
                np.testing.assert_array_equal(
                    getattr(td, a).asnumpy(), np.asarray(getattr(jd, a + "_")))
            assert td.data.dtype == np.float32
            import scipy.sparse as ss

            np.testing.assert_array_equal(td.asnumpy(), ss.csr_matrix(
                (np.asarray(jd.data_), np.asarray(jd.indices_),
                 np.asarray(jd.indptr_)), shape=jd.shape).toarray())
            _same(tb.label[0], jl, exact=True)
            assert tb.pad == jpad
        with pytest.raises(StopIteration):
            next(ti)
        ti.reset()


def _linear_model(mx, features, csr):
    data = mx.sym.Variable("data", stype="csr" if csr else None)
    label = mx.sym.Variable("softmax_label")
    weight = mx.sym.Variable("weight", stype="row_sparse",
                             shape=(features, 2))
    bias = mx.sym.Variable("bias", shape=(2,))
    pred = mx.sym.broadcast_add(mx.sym.dot(data, weight), bias)
    return mx.sym.SoftmaxOutput(data=pred, label=label, name="softmax")


def _fit_linear(mx, path, features, csr, init, epochs=2):
    it = mx.io.LibSVMIter(data_libsvm=path, data_shape=(features,),
                          batch_size=16, label_name="softmax_label")
    mod = mx.mod.Module(_linear_model(mx, features, csr),
                        label_names=["softmax_label"])
    if mx is tmx:
        mod = mx.mod.Module(_linear_model(mx, features, csr),
                            label_names=["softmax_label"],
                            context=tmx.cpu())
    mod.fit(it, num_epoch=epochs, optimizer="sgd",
            optimizer_params={"learning_rate": 0.5},
            arg_params={k: mx.nd.array(v) for k, v in init.items()},
            initializer=mx.init.Zero(), eval_metric="accuracy")
    metric = mx.metric.Accuracy()
    it.reset()
    mod.score(it, metric)
    arg, _ = mod.get_params()
    return {k: v.asnumpy() for k, v in arg.items()}, metric.get()[1], mod


@pytest.fixture(scope="module")
def _linear_case(tmp_path_factory):
    """The LibSVM file, the weights and the reference's fitted parameters
    and accuracy (its data always dense)."""
    features = 60
    path = _libsvm_file(str(tmp_path_factory.mktemp("lin") / "t.libsvm"),
                        40, features, 3)
    rs = np.random.RandomState(0)
    init = {"weight": (rs.randn(features, 2) * 0.01).astype(np.float32),
            "bias": np.zeros(2, np.float32)}
    jp, jacc, _ = _fit_linear(jmx, path, features, False, init)
    return path, features, init, jp, jacc


@pytest.mark.parametrize("csr", [True, False], ids=["declared_csr", "dense"])
def test_sparse_linear_fit_matches_reference(_linear_case, csr):
    """``tests/test_train.py::test_sparse_linear_convergence``'s fit for a
    few steps on both packages from the same weights: the parameters
    agree at rtol 1e-5 with the data variable declared csr (the port
    computes from the stored values) and undeclared (dense batches)."""
    path, features, init, jp, jacc = _linear_case
    with tmx.cpu():
        tp, tacc, tmod = _fit_linear(tmx, path, features, csr, init)
    for k in jp:
        np.testing.assert_allclose(tp[k], jp[k], rtol=1e-5, atol=1e-6,
                                   err_msg=k)
    assert tacc == jacc
    arg = tmod._exec.arg_dict["data"]
    assert isinstance(arg, tsp.CSRNDArray) == csr


def test_csr_argument_rules():
    """A csr argument: no gradient (refused by name), no dense buffer,
    refused as a mesh batch argument; ``stype_dict`` binds one too."""
    net = _linear_model(tmx, 8, True)
    with pytest.raises(MXNetError, match="'data'.*csr"):
        net.simple_bind(ctx=tmx.cpu(), grad_req="write", data=(4, 8))
    ex = net.simple_bind(ctx=tmx.cpu(), grad_req={"weight": "write",
                                                  "bias": "write"},
                         data=(4, 8))
    assert isinstance(ex.arg_dict["data"], tsp.CSRNDArray)
    assert ex.arg_dict["data"].data_.numel() == 0
    mesh = types.SimpleNamespace(shape={"dp": 1})
    with pytest.raises(MXNetError, match="'data'.*csr"):
        ex.set_spmd(mesh, ["data", "softmax_label"])
    plain = _linear_model(tmx, 8, False)
    ex2 = plain.simple_bind(ctx=tmx.cpu(), grad_req="null", data=(4, 8),
                            stype_dict={"data": "csr"})
    assert isinstance(ex2.arg_dict["data"], tsp.CSRNDArray)
    x = np.zeros((4, 8), np.float32)
    x[[0, 2], [1, 5]] = [2.0, -1.0]
    w = np.arange(16, dtype=np.float32).reshape(8, 2)
    out = ex2.forward(data=tsp.csr_matrix(x), weight=tmx.nd.array(w),
                      bias=tmx.nd.zeros((2,)),
                      softmax_label=tmx.nd.zeros((4,)))[0]
    ref = ex2.forward(data=tmx.nd.array(x))[0]   # a dense batch compressed
    np.testing.assert_allclose(out.asnumpy(), ref.asnumpy())
    e = np.exp(x @ w - (x @ w).max(1, keepdims=True))
    np.testing.assert_allclose(out.asnumpy(), e / e.sum(1, keepdims=True),
                               rtol=1e-6)


def test_csr_dot_gradient_matches_dense():
    """``dot(csr, w)``'s gradient in ``w`` (an ``index_add``) against the
    dense product's, transposed and not."""
    from mxnet_tpu_torch.ops.spatial import CsrTensor, csr_dot

    rs = np.random.RandomState(4)
    x = rs.randn(5, 7).astype(np.float32)
    x[rs.rand(5, 7) < 0.6] = 0
    c = tsp.csr_matrix(x)
    for ta, wshape in ((False, (7, 3)), (True, (5, 3))):
        w = torch.from_numpy(rs.randn(*wshape).astype(np.float32))
        w1, w2 = w.clone().requires_grad_(), w.clone().requires_grad_()
        ct = CsrTensor.make(c.data_, c.indices_, c.indptr_, c.shape)
        y1 = csr_dot(ct, w1, transpose_a=ta)
        xd = torch.from_numpy(x)
        y2 = (xd.T if ta else xd) @ w2
        g = torch.from_numpy(rs.randn(*y2.shape).astype(np.float32))
        (y1 * g).sum().backward()
        (y2 * g).sum().backward()
        np.testing.assert_allclose(y1.detach().numpy(), y2.detach().numpy(),
                                   **TOL)
        np.testing.assert_allclose(w1.grad.numpy(), w2.grad.numpy(), **TOL)


# ---------------------------------------------------------------------------
# gluon.contrib.nn
# ---------------------------------------------------------------------------

def test_sparse_embedding_under_trainer():
    """``gluon.contrib.nn.SparseEmbedding`` (``grad_stype="row_sparse"``)
    trained by ``gluon.Trainer`` over the ``device`` store: the same
    weights as the reference's after two steps (momentum), and the rows
    ``Trainer._row_sparse_pull`` brings back."""
    rs = np.random.RandomState(5)
    w0 = rs.randn(20, 6).astype(np.float32)
    ids = [rs.randint(0, 20, (4, 3)).astype(np.float32) for _ in range(2)]
    got = []
    for mx in (tmx, jmx):
        emb = mx.gluon.contrib.nn.SparseEmbedding(20, 6)
        emb.initialize(mx.init.Constant(0.0), ctx=mx.cpu())
        emb.weight.set_data(mx.nd.array(w0))
        tr = mx.gluon.Trainer(emb.collect_params(), "sgd",
                              {"learning_rate": 0.5, "momentum": 0.9})
        for x in ids:
            with mx.autograd.record():
                loss = (emb(mx.nd.array(x)) ** 2).sum()
            loss.backward()
            tr.step(4)
        got.append(emb.weight.data())
        assert repr(emb) == "SparseEmbedding(20 -> 6)"
        rows = mx.nd.zeros((20, 6))
        tr._row_sparse_pull(emb.weight, rows, mx.nd.array([2, 7]))
        got.append(rows)
    _same(got[0], got[2])
    _same(got[1], got[3])
    np.testing.assert_array_equal(got[1].asnumpy()[[0, 1, 3]], 0)


def test_contrib_blocks():
    rs = np.random.RandomState(6)
    x = rs.randn(2, 5).astype(np.float32)
    outs = []
    for mx in (tmx, jmx):
        nn, cnn = mx.gluon.nn, mx.gluon.contrib.nn
        for cls in (cnn.Concurrent, cnn.HybridConcurrent):
            net = cls(axis=1)
            net.add(nn.Dense(3, in_units=5), cnn.Identity())
            net.initialize(mx.init.Constant(0.25), ctx=mx.cpu())
            if cls is cnn.HybridConcurrent:
                net.hybridize()
            outs.append(net(mx.nd.array(x)))
    for a, b in zip(outs[:2], outs[2:]):
        assert a.shape == (2, 8)
        _same(a, b)
    bn = tmx.gluon.contrib.nn.SyncBatchNorm(in_channels=3, num_devices=4)
    assert bn._axis == 1


def test_sparse_differs_by_design():
    """Where the port departs from the reference (ROADMAP.md, "differs by
    design"): ``copyto(ctx)`` keeps the storage type (the reference gives
    a dense array); ``dot(csr, b, transpose_b=True)`` transposes ``b``
    (the reference ignores the flag); ``attach_grad`` on a sparse array
    raises (the reference attaches a dense gradient that the sparse
    handle cannot carry here)."""
    w = np.arange(12, dtype=np.float32).reshape(4, 3)
    t, j = tsp.row_sparse_array(w), jsp.row_sparse_array(w)
    tc, jc = t.copyto(tmx.cpu()), j.copyto(jmx.cpu())
    assert tc.stype == "row_sparse" and type(jc).__name__ == "NDArray"
    np.testing.assert_array_equal(tc.asnumpy(), _np(jc))
    x = np.array([[1, 0, 2], [0, 0, 3]], np.float32)
    b = np.arange(6, dtype=np.float32).reshape(2, 3)
    got = tsp.dot(tsp.csr_matrix(x), tmx.nd.array(b), transpose_b=True)
    np.testing.assert_allclose(got.asnumpy(), x @ b.T)
    with pytest.raises(MXNetError, match="sparse"):
        t.attach_grad()
