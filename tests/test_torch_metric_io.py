"""PyTorch port: the metrics, the data iterators and the callbacks against
the JAX package's.

- Every metric's ``get()`` after the same updates (numpy labels and
  predictions from a seed, given as each package's NDArrays) to 1e-6,
  through ``create`` by name, alias, list (composite) and callable.
- ``NDArrayIter`` in its three ``last_batch_handle`` modes (pad, discard,
  roll_over), shuffled from the same numpy seed, over two epochs: every
  batch's data, label and pad equal; ``ResizeIter`` and
  ``PrefetchingIter`` over it (its reader thread on the caller's context,
  a reader's exception raised to the caller); ``MNISTIter`` over idx
  files the test
  writes (plain and gzipped, flat and not, sharded); ``CSVIter`` with and
  without labels and ``round_batch``.
- ``Speedometer``, ``log_train_metric``, ``ProgressBar`` and
  ``LogValidationMetricsCallback`` log as the reference's do.
"""
import gzip
import logging
import struct

import numpy as np
import pytest

import mxnet_tpu as jmx
import mxnet_tpu_torch as tmx

TOL = dict(rtol=1e-6, atol=1e-6)


@pytest.fixture(autouse=True)
def _cpu():
    with tmx.cpu():
        yield


def _probs(rs, n, c):
    p = rs.rand(n, c).astype(np.float32) + 0.05
    return p / p.sum(1, keepdims=True)


def _metric_cases():
    rs = np.random.RandomState(0)
    cls = (rs.randint(0, 5, 12).astype(np.float32), _probs(rs, 12, 5))
    binary = (rs.randint(0, 2, 12).astype(np.float32), _probs(rs, 12, 2))
    reg = (rs.randn(12).astype(np.float32), rs.randn(12).astype(np.float32))
    reg2 = (rs.randn(12, 3).astype(np.float32),
            rs.randn(12, 3).astype(np.float32))
    seq_lab = rs.randint(0, 6, (4, 3)).astype(np.float32)
    seq_lab[0, 0] = 5
    seq = (seq_lab, _probs(rs, 12, 6))
    loss = (None, rs.rand(12).astype(np.float32))
    return {
        "acc": ("acc", {}, cls),
        "accuracy_axis": ("accuracy", {"axis": 1}, cls),
        "top_k": ("top_k_accuracy", {"top_k": 3}, cls),
        "f1_macro": ("f1", {}, binary),
        "f1_micro": ("f1", {"average": "micro"}, binary),
        "mcc_macro": ("mcc", {}, binary),
        "mcc_micro": ("mcc", {"average": "micro"}, binary),
        "perplexity": ("perplexity", {"ignore_label": None}, seq),
        "perplexity_ignore": ("perplexity", {"ignore_label": 5}, seq),
        "mae": ("mae", {}, reg),
        "mse": ("mse", {}, reg2),
        "rmse": ("rmse", {}, reg),
        "ce": ("ce", {}, cls),
        "nll_loss": ("nll_loss", {}, cls),
        "pearsonr": ("pearsonr", {}, reg),
        "loss": ("loss", {}, loss),
        "torch": ("torch", {}, loss),
        "caffe": ("caffe", {}, loss),
    }


def _updated(pkg, name, kw, labels, preds, rounds=2):
    m = pkg.metric.create(name, **kw)
    for r in range(rounds):
        lab = None if labels is None else [pkg.nd.array(labels + 0 * r)]
        m.update(lab, [pkg.nd.array(preds[::-1] if r else preds)])
    return m


@pytest.mark.parametrize("case", sorted(_metric_cases()))
def test_metric_matches(case):
    name, kw, (labels, preds) = _metric_cases()[case]
    if case.startswith("perplexity"):
        labels = labels.reshape(-1)
    jm = _updated(jmx, name, kw, labels, preds)
    tm = _updated(tmx, name, kw, labels, preds)
    jn, jv = jm.get()
    tn, tv = tm.get()
    assert tn == jn
    np.testing.assert_allclose(tv, jv, **TOL)
    assert tm.get_config() == jm.get_config()
    tm.reset()
    assert np.isnan(tm.get()[1])


def test_composite_custom_and_update_dict():
    rs = np.random.RandomState(1)
    labels, preds = rs.randint(0, 4, 8).astype(np.float32), _probs(rs, 8, 4)

    def feval(label, pred):
        return float((pred.argmax(1) == label).sum()), label.size

    got = []
    for pkg in (jmx, tmx):
        comp = pkg.metric.create(["acc", pkg.metric.create(
            "top_k_accuracy", top_k=2), feval])
        comp.update_dict({"softmax_label": pkg.nd.array(labels)},
                         {"softmax_output": pkg.nd.array(preds)},
                         device=True)
        np_metric = pkg.metric.np(lambda l, p: float(np.abs(l - p.argmax(1))
                                                     .mean()), name="dist")
        np_metric.update([pkg.nd.array(labels)], [pkg.nd.array(preds)])
        got.append((comp.get(), np_metric.get(), comp.get_name_value()))
    assert got[1][0][0] == got[0][0][0]
    np.testing.assert_allclose(got[1][0][1], got[0][0][1], **TOL)
    assert got[1][1] == got[0][1]
    assert [n for n, _ in got[1][2]] == [n for n, _ in got[0][2]]
    with pytest.raises(KeyError):
        tmx.metric.create("no_such_metric")


# ---------------------------------------------------------------------------
# iterators
# ---------------------------------------------------------------------------

def _batches(it, epochs=2):
    out = []
    for _ in range(epochs):
        it.reset()
        for b in it:
            out.append(([d.asnumpy() for d in b.data],
                        [l.asnumpy() for l in (b.label or [])], b.pad))
    return out


def _same_batches(a, b):
    assert len(a) == len(b)
    for (ad, al, ap), (bd, bl, bp) in zip(a, b):
        assert ap == bp
        for x, y in zip(ad + al, bd + bl):
            np.testing.assert_array_equal(x, y)


@pytest.mark.parametrize("mode", ["pad", "discard", "roll_over"])
@pytest.mark.parametrize("shuffle", [False, True])
def test_ndarray_iter_matches(mode, shuffle):
    rs = np.random.RandomState(2)
    X = rs.randn(23, 3, 2).astype(np.float32)
    Y = rs.randint(0, 4, 23).astype(np.float32)
    got = []
    for pkg in (jmx, tmx):
        np.random.seed(7)
        it = pkg.io.NDArrayIter(X, Y, batch_size=5, shuffle=shuffle,
                                last_batch_handle=mode)
        assert [tuple(d) for d in it.provide_data] == [("data", (5, 3, 2))]
        assert [tuple(d) for d in it.provide_label] == \
            [("softmax_label", (5,))]
        got.append(_batches(it, epochs=3))
    _same_batches(*got)


def test_multi_input_resize_and_prefetch():
    rs = np.random.RandomState(3)
    data = {"a": rs.randn(10, 2).astype(np.float32),
            "b": rs.randn(10, 3).astype(np.float32)}
    label = rs.randn(10).astype(np.float32)
    got = []
    for pkg in (jmx, tmx):
        base = pkg.io.NDArrayIter(data, label, batch_size=4)
        got.append((_batches(pkg.io.ResizeIter(base, 5), epochs=2),
                    [d.name for d in base.provide_data]))
        pre = pkg.io.PrefetchingIter(pkg.io.NDArrayIter(data, label,
                                                        batch_size=4))
        got.append((_batches(pre, epochs=2), None))
    _same_batches(got[0][0], got[2][0])
    _same_batches(got[1][0], got[3][0])
    assert got[0][1] == got[2][1]


def test_prefetch_keeps_context_and_surfaces_errors():
    class Failing(tmx.io.DataIter):
        provide_data = provide_label = []

        def next(self):
            raise ValueError("reader failed")

    pre = tmx.io.PrefetchingIter(tmx.io.NDArrayIter(np.zeros((4, 2)),
                                                    batch_size=2))
    # the reader thread makes its batches on the context current here
    assert next(iter(pre)).data[0].context == tmx.cpu()
    with pytest.raises(ValueError, match="reader failed"):
        next(iter(tmx.io.PrefetchingIter(Failing(2))))


def _write_idx(path, arr, gz):
    opener = gzip.open if gz else open
    with opener(path, "wb") as f:
        f.write(struct.pack(">I", 0x0800 | arr.ndim))
        for d in arr.shape:
            f.write(struct.pack(">I", d))
        f.write(arr.astype(np.uint8).tobytes())


@pytest.mark.parametrize("gz", [False, True])
@pytest.mark.parametrize("flat", [False, True])
def test_mnist_iter_over_idx_files(tmp_path, gz, flat):
    rs = np.random.RandomState(4)
    imgs = rs.randint(0, 256, (30, 28, 28))
    labs = rs.randint(0, 10, 30)
    img_path = str(tmp_path / "img-idx3-ubyte")
    lab_path = str(tmp_path / "lab-idx1-ubyte")
    _write_idx(img_path + (".gz" if gz else ""), imgs, gz)
    _write_idx(lab_path + (".gz" if gz else ""), labs, gz)
    got = []
    for pkg in (jmx, tmx):
        np.random.seed(9)
        it = pkg.io.MNISTIter(image=img_path, label=lab_path, batch_size=8,
                              shuffle=True, flat=flat, num_parts=2,
                              part_index=1)
        got.append(_batches(it))
    _same_batches(*got)
    assert got[0][0][0][0].shape == ((8, 784) if flat else (8, 1, 28, 28))


def test_mnist_iter_synthetic():
    got = [_batches(pkg.io.MNISTIter(image=None, batch_size=500,
                                     shuffle=False), epochs=1)
           for pkg in (jmx, tmx)]
    _same_batches(*got)


@pytest.mark.parametrize("round_batch", [True, False])
@pytest.mark.parametrize("with_label", [True, False])
def test_csv_iter(tmp_path, round_batch, with_label):
    rs = np.random.RandomState(5)
    data = rs.randn(11, 6).astype(np.float32)
    dpath = str(tmp_path / "d.csv")
    np.savetxt(dpath, data, delimiter=",")
    kw = {}
    if with_label:
        lpath = str(tmp_path / "l.csv")
        np.savetxt(lpath, rs.randint(0, 3, 11).astype(np.float32),
                   delimiter=",")
        kw = dict(label_csv=lpath)
    got = [_batches(pkg.io.CSVIter(data_csv=dpath, data_shape=(2, 3),
                                   batch_size=4, round_batch=round_batch,
                                   **kw))
           for pkg in (jmx, tmx)]
    _same_batches(*got)


def test_data_desc_and_batch():
    for pkg in (jmx, tmx):
        d = pkg.io.DataDesc("x", (2, 3), layout="NHWC")
        assert (d.name, d.shape, d.layout) == ("x", (2, 3), "NHWC")
        assert pkg.io.DataDesc.get_batch_axis("TNC") == 1
        b = pkg.io.DataBatch(pkg.nd.zeros((2, 3)), pad=1)
        assert len(b.data) == 1 and b.label is None and b.pad == 1


# ---------------------------------------------------------------------------
# callbacks
# ---------------------------------------------------------------------------

def _param(pkg, nbatch, metric):
    return pkg.model.BatchEndParam(epoch=0, nbatch=nbatch,
                                   eval_metric=metric, locals={})


def test_callbacks_log_as_the_reference(caplog):
    logs = []
    for pkg in (jmx, tmx):
        caplog.clear()
        m = pkg.metric.create("acc")
        m.update([pkg.nd.array(np.array([1.0, 0.0]))],
                 [pkg.nd.array(np.array([[0.2, 0.8], [0.9, 0.1]]))])
        with caplog.at_level(logging.INFO):
            sp = pkg.callback.Speedometer(4, frequent=2, auto_reset=False)
            for n in range(5):
                sp(_param(pkg, n, m))
            pkg.callback.log_train_metric(2)(_param(pkg, 2, m))
            pkg.callback.ProgressBar(total=4, length=8)(_param(pkg, 2, m))
            pkg.callback.LogValidationMetricsCallback()(_param(pkg, 3, m))
        logs.append([r.getMessage().split("Speed:")[0] for r in
                     caplog.records])
    assert logs[1] == logs[0] and len(logs[0]) >= 4
