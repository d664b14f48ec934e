"""PyTorch port: ``recordio`` and the RecordIO iterators against the JAX
package's.

- ``MXRecordIO``/``MXIndexedRecordIO`` files (``.idx`` included), ``pack``/
  ``unpack`` and ``pack_img``/``unpack_img``: the same bytes from either
  package, and each reads the other's, a payload holding the magic word
  (a multipart record) too.
- ``RecordIOIter``: each of three round-robin shards yields the
  reference's records.
- ``ImageRecordIter`` against the reference's default route (its native
  ``ImagePipeline``, ``cpp/src/imagedec.cc``; skipped where that library
  cannot be built): RAW0 images of several sizes resized on either side,
  the uint8 batches of centered crops and of one-thread random crops and
  mirrors (the workers' ``mt19937`` streams) bitwise, with the labels and
  the count of a trailing batch; the iterators' batches after the
  device-side mean/std and NCHW transpose within 1 ulp (the reference's
  XLA multiplies by the reciprocal), and ``pad``.  A three-thread epoch
  holds the same batches as a one-thread epoch (as multisets: the threads
  draw nothing here).  A JPEG record decodes through PIL.
"""
import struct
import sys

import numpy as np
import pytest

import mxnet_tpu as jmx
import mxnet_tpu_torch as tmx
from mxnet_tpu_torch.base import MXNetError


@pytest.fixture(autouse=True)
def _cpu():
    with tmx.cpu():
        yield


def _raw0(img):
    shape = np.asarray(img.shape, np.int32)
    return b"RAW0" + struct.pack("<I", len(shape)) + shape.tobytes() + \
        img.astype(np.uint8).tobytes()


def _images(n, seed=0):
    """n RGB (or gray) images of several shapes, as (header, RAW0 bytes)."""
    rs = np.random.RandomState(seed)
    shapes = [(20, 30, 3), (40, 24, 3), (16, 16, 3), (25, 25), (18, 33, 3)]
    out = []
    for i in range(n):
        img = rs.randint(0, 256, size=shapes[i % len(shapes)])
        label = [float(i % 7), float(i)] if i % 3 == 0 else float(i % 7)
        out.append((tmx.recordio.IRHeader(0, label, i, 0), _raw0(img)))
    return out


def _write(pkg, path, records, indexed=False):
    if indexed:
        w = pkg.recordio.MXIndexedRecordIO(path + ".idx", path, "w")
        for i, r in enumerate(records):
            w.write_idx(i, r)
    else:
        w = pkg.recordio.MXRecordIO(path, "w")
        for r in records:
            w.write(r)
    w.close()


def test_recordio_bytes_both_ways(tmp_path):
    magic = struct.pack("<I", 0xCED7230A)
    records = [tmx.recordio.pack(h, b) for h, b in _images(6)]
    records += [b"abcd" + magic + b"tail" + magic, b"", b"xyz"]
    for indexed in (False, True):
        data = []
        for pkg in (jmx, tmx):
            path = str(tmp_path / f"{pkg.__name__}{indexed}.rec")
            _write(pkg, path, records, indexed)
            files = [open(path, "rb").read()]
            if indexed:
                files.append(open(path + ".idx", "rb").read())
            data.append((path, files))
        assert data[1][1] == data[0][1]
        for (path, _), pkg in zip(data, (tmx, jmx)):   # each reads the other's
            if indexed:
                r = pkg.recordio.MXIndexedRecordIO(path + ".idx", path, "r")
                got = [r.read_idx(i) for i in reversed(range(len(records)))]
                got.reverse()
            else:
                r = pkg.recordio.MXRecordIO(path, "r")
                got = [r.read() for _ in records]
                assert r.read() is None
            r.close()
            assert got == records
    # headers with scalar and array labels
    for h, b in _images(4):
        packed = tmx.recordio.pack(h, b)
        assert packed == jmx.recordio.pack(jmx.recordio.IRHeader(*h), b)
        th, tb = tmx.recordio.unpack(packed)
        jh, jb = jmx.recordio.unpack(packed)
        assert tb == jb and th.flag == jh.flag and th.id == jh.id
        np.testing.assert_array_equal(th.label, jh.label)


def test_pack_img_both_ways():
    img = np.random.RandomState(3).randint(0, 256, (12, 10, 3))
    h = tmx.recordio.IRHeader(0, 2.0, 5, 0)
    for fmt in (".png", ".jpg"):
        t = tmx.recordio.pack_img(h, img, quality=90, img_fmt=fmt)
        j = jmx.recordio.pack_img(jmx.recordio.IRHeader(*h), img,
                                  quality=90, img_fmt=fmt)
        assert t == j
        th, timg = tmx.recordio.unpack_img(j)
        jh, jimg = jmx.recordio.unpack_img(t)
        np.testing.assert_array_equal(timg, jimg)
        assert th.label == jh.label == 2.0
    # a RAW0 blob decodes without PIL
    _, raw = tmx.recordio.unpack_img(tmx.recordio.pack(h, _raw0(img)))
    np.testing.assert_array_equal(raw, img)


def test_recordio_iter_shards(tmp_path):
    path = str(tmp_path / "s.rec")
    records = [bytes([i]) * (i + 1) for i in range(11)]
    _write(tmx, path, records)
    for part in range(3):
        want = list(jmx.io.RecordIOIter(path, part_index=part, num_parts=3))
        it = tmx.io.RecordIOIter(path, part_index=part, num_parts=3)
        assert list(it) == want == records[part::3]
        it.reset()
        assert list(it) == want
        it.close()


def _rec_file(tmp_path, n, name="img.rec"):
    path = str(tmp_path / name)
    _write(tmx, path, [tmx.recordio.pack(h, b) for h, b in _images(n)])
    return path


def _native():
    from mxnet_tpu import _native

    if _native.lib() is None:
        pytest.skip("the reference's native image pipeline cannot be built "
                    "here")


ITER = dict(data_shape=(3, 16, 16), batch_size=4, resize=20,
            mean_r=123.68, mean_g=116.779, mean_b=103.939,
            std_r=58.4, std_g=57.1, std_b=57.4, label_width=2)


def _epoch(pkg, path, **kw):
    it = pkg.io.ImageRecordIter(path_imgrec=path, **{**ITER, **kw})
    out = [(b.data[0].asnumpy(), b.label[0].asnumpy(), b.pad) for b in it]
    if hasattr(it, "close"):
        it.close()
    return out


def _pipelines(path, **kw):
    """The uint8 batches of one epoch of the reference's native pipeline
    and of the port's, one worker each: [(NHWC uint8, labels, count)]."""
    from mxnet_tpu import _native

    args = dict(batch_size=4, data_shape=(3, 16, 16), resize=20,
                label_width=2, **kw)
    ref = _native.ImagePipeline(path, num_threads=1, **args)
    want = list(ref)
    ref.close()
    port = tmx.io._ImagePipeline(
        path, args["batch_size"], args["data_shape"], args["resize"], 1, 4,
        0, 1, kw.get("rand_crop", False), kw.get("rand_mirror", False),
        False, args["label_width"], kw.get("seed", 0), pin=False)
    got = []
    while (batch := port.next()) is not None:
        got.append((batch[0].numpy(), batch[1], batch[2]))
    port.close()
    return got, want


@pytest.mark.parametrize("aug", [{}, {"rand_crop": True, "rand_mirror": True,
                                      "seed": 7}])
def test_image_record_iter_matches_native(tmp_path, aug):
    _native()
    path = _rec_file(tmp_path, 10)
    got, want = _pipelines(path, **aug)
    assert [c for _, _, c in got] == [c for _, _, c in want] == [4, 4, 2]
    for (td, tl, _), (jd, jl, _) in zip(got, want):
        np.testing.assert_array_equal(td, jd)
        np.testing.assert_array_equal(tl, jl)
    # the iterators: mean/std and the NCHW transpose on the device (the
    # reference's XLA divides by a constant as a multiply by its
    # reciprocal: within 1 ulp)
    kw = dict(preprocess_threads=1, **aug)
    want = _epoch(jmx, path, **kw)
    got = _epoch(tmx, path, **kw)
    assert [p for _, _, p in got] == [p for _, _, p in want] == [0, 0, 2]
    for (td, tl, _), (jd, jl, _) in zip(got, want):
        assert td.shape == (4, 3, 16, 16) and td.dtype == np.float32
        np.testing.assert_array_max_ulp(td, jd, maxulp=1)
        np.testing.assert_array_equal(tl, jl)


def test_image_record_iter_epochs_and_threads(tmp_path):
    _native()
    path = _rec_file(tmp_path, 13)
    one = _epoch(tmx, path, preprocess_threads=1)
    three = _epoch(tmx, path, preprocess_threads=3, prefetch_buffer=1)
    assert [p for _, _, p in three] == [p for _, _, p in one] == [0, 0, 0, 3]

    def rows(epoch):
        return sorted(d[i].tobytes() + l[i].tobytes() for d, l, p in epoch
                      for i in range(4 - p))

    assert rows(three) == rows(one)
    # more workers than batches, switching threads every 10 us: the
    # shared reader and the hand-over lose and repeat no record
    interval = sys.getswitchinterval()
    sys.setswitchinterval(1e-5)
    try:
        many = _epoch(tmx, path, preprocess_threads=8, prefetch_buffer=1)
    finally:
        sys.setswitchinterval(interval)
    assert [p for _, _, p in many] == [0, 0, 0, 3]
    assert rows(many) == rows(one)
    # a new epoch draws other crops; reset starts the file again
    it = tmx.io.ImageRecordIter(path_imgrec=path, rand_crop=True,
                                preprocess_threads=1, **ITER)
    e1 = [b.data[0].asnumpy() for b in it]
    it.reset()
    e2 = [b.data[0].asnumpy() for b in it]
    it.close()
    assert len(e1) == len(e2) == 4
    assert any(not np.array_equal(a, b) for a, b in zip(e1, e2))


def test_image_record_iter_shards_and_jpeg(tmp_path):
    path = _rec_file(tmp_path, 10)
    # two shards step equally: the short one ends on a copy of its first
    # batch counting no images
    parts = [_epoch(tmx, path, num_parts=2, part_index=p, batch_size=3,
                    preprocess_threads=1) for p in (0, 1)]
    assert [[p for _, _, p in e] for e in parts] == [[0, 1], [0, 1]]
    parts = [_epoch(tmx, path, num_parts=3, part_index=p, batch_size=2,
                    preprocess_threads=1) for p in (0, 1, 2)]
    assert [[p for _, _, p in e] for e in parts] == \
        [[0, 0], [0, 1], [0, 1]]
    # JPEG through PIL
    pytest.importorskip("PIL")
    img = np.random.RandomState(0).randint(0, 256, (40, 40, 3))
    jpath = str(tmp_path / "j.rec")
    _write(tmx, jpath, [tmx.recordio.pack_img(
        tmx.recordio.IRHeader(0, 1.0, 0, 0), img, img_fmt=".jpg")])
    (d, l, p), = _epoch(tmx, jpath, batch_size=1, label_width=1)
    assert d.shape == (1, 3, 16, 16) and p == 0 and l.tolist() == [1.0]
    # an undecodable record raises, never skipped
    bad = str(tmp_path / "bad.rec")
    _write(tmx, bad, [tmx.recordio.pack(tmx.recordio.IRHeader(0, 0.0, 0, 0),
                                        b"RAW0" + b"\x03\x00")])
    with pytest.raises(MXNetError, match="malformed"):
        _epoch(tmx, bad, batch_size=1, label_width=1)
