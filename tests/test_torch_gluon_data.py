"""PyTorch port: ``gluon.data`` and ``gluon.utils`` against the JAX
package's.

The same numpy dataset (from a seed) through both packages'
``ArrayDataset`` and ``DataLoader``: the batches, in order, under a
sequential sampler, a random one (numpy's global generator seeded alike on
both sides) and an explicit ``BatchSampler``; each ``last_batch`` mode
(keep, discard, rollover across two epochs); ``num_workers`` 0 and a
thread pool; ``transform``/``transform_first``.  Batches are equal
exactly (the port's are CPU NDArrays).  A dataset of NDArrays is stacked
with ``nd.stack`` on the samples' own device, as the reference does: the
batches equal the reference's, and samples on another device (torch's
``meta``, which holds no data) give a batch there, not on the host.  ``split_data``,
``split_and_load`` and ``clip_global_norm`` agree (rtol 1e-6);
``check_sha1`` and ``download`` (a file already in place; an error
otherwise) behave alike.
"""
import hashlib

import numpy as np
import pytest
import torch

import mxnet_tpu as jmx
import mxnet_tpu_torch as tmx
from mxnet_tpu_torch.base import MXNetError

N = 10


@pytest.fixture(autouse=True)
def _cpu():
    with tmx.cpu():
        yield


def _data():
    rs = np.random.RandomState(0)
    return (rs.randn(N, 3, 2).astype(np.float32),
            rs.randint(0, 5, N).astype(np.int32))


def _epochs(mx, epochs=1, seed=None, **kw):
    X, Y = _data()
    loader = mx.gluon.data.DataLoader(mx.gluon.data.ArrayDataset(X, Y), **kw)
    if seed is not None:
        np.random.seed(seed)
    out = []
    for _ in range(epochs):
        out.append([[a.asnumpy() for a in batch] for batch in loader])
    return out, len(loader)


CASES = {
    "sequential_keep": dict(batch_size=4),
    "sequential_discard": dict(batch_size=4, last_batch="discard"),
    "rollover": dict(batch_size=4, last_batch="rollover"),
    "shuffle": dict(batch_size=3, shuffle=True),
    "threads": dict(batch_size=3, num_workers=2),
    "threads_prefetch": dict(batch_size=2, num_workers=3, prefetch=1,
                             last_batch="discard"),
}


@pytest.mark.parametrize("case", sorted(CASES))
def test_dataloader_batches_match_jax(case):
    kw = CASES[case]
    epochs = 2 if case == "rollover" else 1
    seed = 7 if kw.get("shuffle") else None
    (want, wlen), (got, glen) = [_epochs(mx, epochs, seed, **kw)
                                 for mx in (jmx, tmx)]
    assert glen == wlen
    assert len(got) == len(want)
    for we, ge in zip(want, got):
        assert len(ge) == len(we)
        for wb, gb in zip(we, ge):
            for w, g in zip(wb, gb):
                assert g.dtype == w.dtype
                np.testing.assert_array_equal(g, w)


def test_batch_sampler_and_transforms():
    X, Y = _data()
    outs = []
    for mx in (jmx, tmx):
        d = mx.gluon.data
        ds = d.ArrayDataset(X, Y).transform_first(lambda x: x * 2)
        bs = d.BatchSampler(d.SequentialSampler(N), 4, "keep")
        batches = [[a.asnumpy() for a in b]
                   for b in d.DataLoader(ds, batch_sampler=bs)]
        single = d.SimpleDataset(list(range(5))).transform(lambda v: v + 1)
        outs.append((batches, [single[i] for i in range(5)],
                     len(d.ArrayDataset(X).take(3))))
    (wb, ws, wt), (gb, gs, gt) = outs
    assert gs == ws and gt == wt
    for w, g in zip(wb, gb):
        for a, b in zip(w, g):
            np.testing.assert_array_equal(b, a)


def test_loader_batches_are_host_arrays():
    X, Y = _data()
    x, y = next(iter(tmx.gluon.data.DataLoader(
        tmx.gluon.data.ArrayDataset(X, Y), batch_size=4)))
    assert x.context == tmx.cpu() and y.dtype == np.int32
    with pytest.raises(MXNetError, match="process pool"):
        tmx.gluon.data.DataLoader(tmx.gluon.data.ArrayDataset(X, Y),
                                  batch_size=2, num_workers=2,
                                  thread_pool=False)


@pytest.mark.parametrize("workers", [0, 2])
def test_ndarray_dataset_batches_match_jax(workers):
    X, Y = _data()
    outs = []
    for mx in (jmx, tmx):
        ds = mx.gluon.data.ArrayDataset(mx.nd.array(X), Y)
        loader = mx.gluon.data.DataLoader(ds, batch_size=4,
                                          num_workers=workers)
        outs.append([(x.asnumpy(), y.asnumpy()) for x, y in loader])
    x, _ = next(iter(tmx.gluon.data.DataLoader(
        tmx.gluon.data.ArrayDataset(tmx.nd.array(X), Y), batch_size=4)))
    assert x.context == tmx.cpu()
    assert len(outs[1]) == len(outs[0])
    for (wx, wy), (gx, gy) in zip(*outs):
        assert gx.dtype == wx.dtype and gy.dtype == wy.dtype
        np.testing.assert_array_equal(gx, wx)
        np.testing.assert_array_equal(gy, wy)


def test_ndarray_batches_stay_on_their_device():
    """Samples that live off the host are stacked where they are: a batch
    of ``meta`` samples is a ``meta`` tensor (copying one to the host
    raises), of the stacked shape and dtype."""
    samples = [tmx.nd.NDArray(torch.empty(3, 2, device="meta"))
               for _ in range(6)]
    loader = tmx.gluon.data.DataLoader(tmx.gluon.data.SimpleDataset(samples),
                                       batch_size=4, pin_memory=True)
    batches = list(loader)
    assert [b.shape for b in batches] == [(4, 3, 2), (2, 3, 2)]
    for b in batches:
        assert b._data.device.type == "meta"
        assert b._data.dtype == torch.float32


@pytest.mark.parametrize("axis", [0, 1])
def test_split_and_load_matches_jax(axis):
    X = np.arange(24, dtype=np.float32).reshape(4, 6)
    outs = []
    for mx in (jmx, tmx):
        u = mx.gluon.utils
        parts = u.split_data(mx.nd.array(X), 2, batch_axis=axis)
        loaded = u.split_and_load(X, [mx.cpu()], batch_axis=axis)
        uneven = u.split_data(mx.nd.array(X), 3,
                              batch_axis=axis, even_split=False)
        outs.append([p.asnumpy() for p in parts + loaded + uneven])
        with pytest.raises(ValueError):
            u.split_data(mx.nd.array(X), 5, batch_axis=axis)
    for w, g in zip(*outs):
        np.testing.assert_array_equal(g, w)


def test_clip_global_norm_matches_jax():
    rs = np.random.RandomState(2)
    arrays = [rs.randn(3, 4).astype(np.float32) * 3,
              rs.randn(5).astype(np.float32)]
    outs = []
    for mx in (jmx, tmx):
        nds = [mx.nd.array(a) for a in arrays]
        norm = mx.gluon.utils.clip_global_norm(nds, 1.5)
        outs.append((norm, [a.asnumpy() for a in nds]))
    (wn, wa), (gn, ga) = outs
    np.testing.assert_allclose(gn, wn, rtol=1e-6)
    for w, g in zip(wa, ga):
        np.testing.assert_allclose(g, w, rtol=1e-6)


def test_check_sha1_and_download(tmp_path):
    f = tmp_path / "weights.bin"
    f.write_bytes(b"abc" * 100)
    sha = hashlib.sha1(f.read_bytes()).hexdigest()
    for mx in (jmx, tmx):
        u = mx.gluon.utils
        assert u.check_sha1(str(f), sha) and not u.check_sha1(str(f), "0")
        url = "https://example.invalid/models/weights.bin"
        assert u.download(url, path=str(tmp_path), sha1_hash=sha) == str(f)
        with pytest.raises(RuntimeError):
            u.download(url, path=str(tmp_path), sha1_hash="0" * 40)
        with pytest.raises(RuntimeError):
            u.download("https://example.invalid/missing.bin",
                       path=str(tmp_path))
