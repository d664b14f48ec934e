"""PyTorch port: the image ops, ``mx.image`` (helpers, augmenters,
``ImageIter``, ``ImageDetIter``), ``ImageRecordIter``'s ``ImageIter``
route and ``gluon.data.vision`` against the JAX package.

Both packages get the same numpy images (small, from a seed) and, where
they draw, the same seeds: the registered random ops the same key, the
``nd.image`` namespace the same ``mx.random.seed``, and the augmenters
Python's ``random`` and numpy's global stream seeded alike before each
package runs.  Float32 results within rtol 1e-5 (atol 1e-4 on [0, 255]
values), uint8 results, flips, crops, labels and random bits exactly, and
the output dtypes the reference's.
"""
import functools
import random

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import mxnet_tpu as jmx
import mxnet_tpu_torch as tmx
from mxnet_tpu.ops.registry import OP_REGISTRY as JREG
from mxnet_tpu_torch.base import dtype_name
from mxnet_tpu_torch.ops.registry import OP_REGISTRY as TREG
from test_torch_ops_breadth import TOL, _close, check

PIX = dict(rtol=1e-5, atol=1e-4)     # float results on a [0, 255] scale
EXACT = dict(rtol=0, atol=0)


@pytest.fixture(autouse=True)
def _cpu():
    with tmx.cpu():
        yield


def _img(rs, *shape, dtype=np.uint8):
    if dtype == np.uint8:
        return rs.randint(0, 256, shape).astype(np.uint8)
    return (rs.rand(*shape) * 255).astype(np.float32)


_JITTED = {}


def _both(name, args, attrs, key=None):
    """The op on both registries: (want, got).  A random op's reference
    is jitted, as its ``invoke`` runs it, with the key an argument."""
    jargs = [jnp.asarray(a) for a in args]
    tkw = dict(attrs)
    if key is None:
        want = JREG[name].fn(*jargs, **attrs)
    else:
        sig = (name, repr(sorted(attrs.items())))
        if sig not in _JITTED:
            _JITTED[sig] = jax.jit(functools.partial(JREG[name].fn, **attrs))
        want = _JITTED[sig](*jargs, rng_key=jnp.asarray(key, jnp.uint32))
        tkw["rng_key"] = torch.tensor(key, dtype=torch.int64)
    got = TREG[name].fn(*[torch.from_numpy(np.ascontiguousarray(a))
                          for a in args], **tkw)
    return np.asarray(want), got


# ---------------------------------------------------------------------------
# the _image_* ops
# ---------------------------------------------------------------------------

def test_to_tensor_normalize_flips_crop():
    rs = np.random.RandomState(0)
    for x in (_img(rs, 6, 5, 3), _img(rs, 2, 6, 5, 3)):
        check("_image_to_tensor", [x], tol=EXACT)
    chw = _img(rs, 3, 6, 5, dtype=np.float32)
    nchw = _img(rs, 2, 3, 6, 5, dtype=np.float32)
    norm = {"mean": (120.0, 110.0, 100.0), "std": (50.0, 55.0, 60.0)}
    check("_image_normalize", [chw], norm)
    check("_image_normalize", [nchw], norm)
    for name in ("_image_flip_left_right", "_image_flip_top_bottom"):
        check(name, [chw], tol=EXACT)
        check(name, [_img(rs, 3, 6, 5)], tol=EXACT)
    check("_image_crop", [chw], {"x": 1, "y": 2, "width": 3, "height": 4},
          tol=EXACT)
    check("_image_crop", [_img(rs, 2, 3, 6, 5)],
          {"x": 0, "y": 1, "width": 4, "height": 2}, tol=EXACT)


@pytest.mark.parametrize("interp", [0, 1])
def test_resize_shrink_and_grow(interp):
    rs = np.random.RandomState(1)
    for x in (_img(rs, 3, 9, 12, dtype=np.float32), _img(rs, 3, 9, 12),
              _img(rs, 2, 3, 7, 6, dtype=np.float32)):
        for attrs in ({"size": (5, 4)}, {"size": (17, 13)}, {"size": 8},
                      {"size": 6, "keep_ratio": True}):
            want, got = _both("_image_resize", [x], dict(attrs,
                                                         interp=interp))
            assert str(want.dtype) == dtype_name(got.dtype)
            _close(got, want, EXACT if want.dtype == np.uint8 else PIX)


def test_adjust_lighting_and_integer_saturation():
    rs = np.random.RandomState(2)
    for x in (_img(rs, 3, 5, 4, dtype=np.float32), _img(rs, 3, 5, 4)):
        for alpha in ((0.1, -0.2, 0.3), (2.0, 1.0, -3.0)):
            want, got = _both("_image_adjust_lighting", [x],
                              {"alpha": alpha})
            _close(got, want, EXACT if x.dtype == np.uint8 else PIX)


RANDOM_OPS = {
    "_image_random_flip_left_right": {},
    "_image_random_flip_top_bottom": {"p": 0.7},
    "_image_random_brightness": {"min_factor": 0.3, "max_factor": 1.8},
    "_image_random_contrast": {},
    "_image_random_saturation": {"min_factor": 0.2, "max_factor": 1.2},
    "_image_random_hue": {"min_factor": -0.4, "max_factor": 0.4},
    "_image_random_lighting": {"alpha_std": 0.3},
    "_image_random_color_jitter": {"brightness": 0.4, "contrast": 0.3,
                                   "saturation": 0.5, "hue": 0.2},
}


@pytest.mark.parametrize("name", sorted(RANDOM_OPS))
def test_random_ops_bits(name):
    """The same key gives the same draw: uint8 images exactly (the
    saturating round included), float ones within rtol 1e-5."""
    rs = np.random.RandomState(3)
    for x in (_img(rs, 3, 6, 7), _img(rs, 3, 6, 7, dtype=np.float32)):
        for key in ((0, 7), (11, 3), (5, 123456)):
            want, got = _both(name, [x], RANDOM_OPS[name], key=key)
            assert str(want.dtype) == dtype_name(got.dtype)
            _close(got, want, EXACT if x.dtype == np.uint8 else PIX)


def test_nd_image_namespace_under_seed():
    """``nd.image`` draws one key a call from the stream:
    ``mx.random.seed`` gives both packages the same images."""
    rs = np.random.RandomState(4)
    x = _img(rs, 3, 8, 8)
    outs = []
    for mx in (jmx, tmx):
        mx.random.seed(42)
        a = mx.nd.array(x, dtype="uint8")
        im = mx.nd.image
        outs.append([o.asnumpy() for o in (
            im.random_flip_left_right(a), im.random_brightness(a),
            im.random_color_jitter(a, brightness=0.3, contrast=0.3,
                                   saturation=0.3, hue=0.1),
            im.to_tensor(mx.nd.array(x.transpose(1, 2, 0), dtype="uint8")),
            im._image_flip_top_bottom(a))])
    for w, g in zip(*outs):
        _close(g, w, EXACT)
    assert set(n for n in dir(tmx.nd.image) if not n.startswith("__")) >= \
        {n[len("_image_"):] for n in JREG if n.startswith("_image_")}


def test_cv_helpers_and_copyto():
    rs = np.random.RandomState(5)
    for x in (_img(rs, 7, 9, 3), _img(rs, 7, 9, 3, dtype=np.float32)):
        check("_cvcopyMakeBorder", [x], {"top": 1, "bot": 2, "left": 3,
                                         "right": 0, "value": 7.0},
              tol=EXACT)
        for interp in (0, 1, 2, 3):
            for w, h in ((5, 4), (13, 11)):
                want, got = _both("_cvimresize", [x], {"w": w, "h": h,
                                                       "interp": interp})
                tol = PIX if x.dtype == np.float32 else EXACT
                _close(got, want, tol)
        check("_copyto", [x], tol=EXACT)
    assert TREG["cv_imresize"] is TREG["_cvimresize"]
    assert TREG["copyMakeBorder"] is TREG["_cvcopyMakeBorder"]


# ---------------------------------------------------------------------------
# mx.image helpers and augmenters
# ---------------------------------------------------------------------------

def _seeded(fn, seed=7):
    """``fn(mx)`` for each package, Python's ``random`` and numpy's
    global stream seeded alike before each."""
    out = []
    for mx in (jmx, tmx):
        random.seed(seed)
        np.random.seed(seed)
        out.append(fn(mx))
    return out


def test_host_helpers():
    rs = np.random.RandomState(6)
    img = _img(rs, 20, 15, 3)
    for interp in (0, 1, 2):
        for w, h in ((7, 9), (31, 22)):
            want, got = _seeded(lambda mx: mx.image.imresize(img, w, h,
                                                             interp))
            assert got.dtype == want.dtype == np.float32
            _close(torch.from_numpy(got), want, PIX)
    calls = [
        lambda mx: mx.image.resize_short(img, 10),
        lambda mx: mx.image.fixed_crop(img, 2, 3, 6, 5, size=(9, 8)),
        lambda mx: mx.image.random_crop(img, (8, 6))[0],
        lambda mx: mx.image.random_crop(img, (8, 6), interp=1)[1],
        lambda mx: mx.image.center_crop(img, (12, 10))[0],
        lambda mx: mx.image.random_size_crop(img, (9, 9), (0.2, 0.8),
                                             (0.75, 1.33))[0],
        lambda mx: mx.image.color_normalize(img, np.float32([100, 110, 120]),
                                            np.float32([50, 60, 70])),
    ]
    for call in calls:
        want, got = _seeded(call)
        want, got = np.asarray(want), np.asarray(got)
        assert want.dtype == got.dtype
        _close(torch.from_numpy(np.ascontiguousarray(got)), want, PIX)


AUGMENTER_SETS = {
    "crop_mirror_mean": dict(resize=12, rand_crop=True, rand_mirror=True,
                             mean=True, std=True),
    "sized_crop_jitter": dict(rand_resize=True, rand_mirror=True,
                              brightness=0.3, contrast=0.3, saturation=0.3,
                              pca_noise=0.1, mean=True, std=True),
    "center": dict(resize=10, inter_method=1),
}


@pytest.mark.parametrize("case", sorted(AUGMENTER_SETS))
def test_create_augmenter(case):
    """CreateAugmenter's list, the same classes in the same order, applied
    to the same images under the same seeds (five draws each)."""
    rs = np.random.RandomState(8)
    imgs = [_img(rs, 14, 17, 3) for _ in range(5)]

    def run(mx):
        augs = mx.image.CreateAugmenter((3, 8, 9), **AUGMENTER_SETS[case])
        outs = []
        for im in imgs:
            for a in augs:
                im = a(im)
            outs.append(np.asarray(im))
        return [type(a).__name__ for a in augs], [a.dumps() for a in augs], \
            outs

    (jn, jd, jo), (tn, td, to) = _seeded(run)
    assert jn == tn and jd == td
    for g, w in zip(to, jo):
        assert g.dtype == w.dtype
        _close(torch.from_numpy(np.ascontiguousarray(g)), w, PIX)


# ---------------------------------------------------------------------------
# ImageIter, ImageRecordIter's ImageIter route, ImageDetIter
# ---------------------------------------------------------------------------

def _write_rec(tmp_path, imgs, labels, name="data"):
    """A ``.rec``/``.idx`` pair of PNG records (lossless) written by the
    port; ``labels`` are floats or arrays."""
    rec = str(tmp_path / f"{name}.rec")
    w = tmx.recordio.MXIndexedRecordIO(str(tmp_path / f"{name}.idx"), rec,
                                       "w")
    for i, (im, lab) in enumerate(zip(imgs, labels)):
        hdr = tmx.recordio.IRHeader(0, lab, i, 0)
        w.write_idx(i, tmx.recordio.pack_img(hdr, im, img_fmt=".png"))
    w.close()
    return rec


def _epoch(it):
    return [(b.data[0].asnumpy(), b.label[0].asnumpy(), b.pad) for b in it]


def _same_epochs(want, got, tol=PIX):
    assert len(want) == len(got) > 0
    for (wd, wl, wp), (gd, gl, gp) in zip(want, got):
        assert wd.dtype == gd.dtype and wl.dtype == gl.dtype
        assert wp == gp
        _close(torch.from_numpy(gd), wd, tol)
        _close(torch.from_numpy(gl), wl, EXACT)


def test_image_iter_rec_lst_imglist(tmp_path):
    from PIL import Image

    rs = np.random.RandomState(9)
    imgs = [_img(rs, 12 + i % 3, 14, 3) for i in range(7)]
    labels = [float(i % 4) for i in range(7)]
    rec = _write_rec(tmp_path, imgs, labels)
    lst = tmp_path / "data.lst"
    with open(lst, "w") as f:
        for i, im in enumerate(imgs):
            Image.fromarray(im).save(tmp_path / f"im{i}.png")
            f.write(f"{i}\t{labels[i]}\t{2 * labels[i]}\tim{i}.png\n")
    imglist = [[labels[i], f"im{i}.png"] for i in range(7)]
    kw = dict(rand_crop=True, rand_mirror=True, resize=13, mean=True,
              std=True)
    for args in (dict(path_imgrec=rec, shuffle=True, **kw),
                 dict(path_imglist=str(lst), path_root=str(tmp_path),
                      label_width=2, **kw),
                 dict(imglist=imglist, path_root=str(tmp_path), **kw),
                 dict(path_imgrec=rec, num_parts=2, part_index=1)):
        def run(mx):
            it = mx.image.ImageIter(3, (3, 10, 11), **args)
            first = _epoch(it)
            it.reset()
            return first + _epoch(it), it.provide_data, it.provide_label

        (want, jpd, jpl), (got, tpd, tpl) = _seeded(run)
        _same_epochs(want, got)
        assert [tuple(d) for d in jpd] == [tuple(d) for d in tpd]
        assert [tuple(d) for d in jpl] == [tuple(d) for d in tpl]


def test_image_record_iter_python_route(tmp_path):
    """``use_native=False`` (train_imagenet's settings, scaled down) and a
    C = 1 shape through ``ImageRecordIter``: the ImageIter route."""
    rs = np.random.RandomState(10)
    rgb = _write_rec(tmp_path, [_img(rs, 16, 16, 3) for _ in range(6)],
                     [float(i) for i in range(6)], "rgb")
    gray = _write_rec(tmp_path, [_img(rs, 16, 16) for _ in range(6)],
                      [float(i) for i in range(6)], "gray")
    cases = (dict(path_imgrec=rgb, data_shape=(3, 12, 12), resize=16,
                  rand_crop=True, rand_mirror=True, mean_r=123.68,
                  mean_g=116.779, mean_b=103.939, std_r=58.4, std_g=57.1,
                  std_b=57.4, use_native=False, shuffle=True),
             dict(path_imgrec=gray, data_shape=(1, 10, 10), rand_crop=True))
    for args in cases:
        def run(mx):
            it = mx.io.ImageRecordIter(batch_size=4, **args)
            return _epoch(it), type(it).__name__

        (want, jt), (got, tt) = _seeded(run)
        assert jt == tt == "ImageIter"
        _same_epochs(want, got)


def test_image_det_iter(tmp_path):
    rs = np.random.RandomState(11)
    imgs, labels = [], []
    for i in range(6):
        n = 1 + i % 3
        objs = np.concatenate([rs.randint(0, 3, (n, 1)),
                               np.sort(rs.uniform(0, 1, (n, 2)), 1)[:, [0]],
                               np.sort(rs.uniform(0, 1, (n, 2)), 1)[:, [0]],
                               rs.uniform(0.5, 1, (n, 2))], 1)
        imgs.append(_img(rs, 10 + i, 12, 3))
        labels.append(tmx.image.ImageDetIter.pack_label(objs))
    np.testing.assert_array_equal(labels[2], jmx.image.ImageDetIter.pack_label(
        np.asarray(labels[2][2:]).reshape(-1, 5)))
    rec = _write_rec(tmp_path, imgs, labels)
    for kw in (dict(rand_mirror=True, max_objects=4, shuffle=True),
               dict(mean=True, std=True, brightness=0.2, max_objects=2,
                    obj_width=6)):
        def run(mx):
            it = mx.image.ImageDetIter(2, (3, 8, 9), path_imgrec=rec, **kw)
            return _epoch(it), it.provide_label

        (want, jpl), (got, tpl) = _seeded(run)
        _same_epochs(want, got)
        assert [tuple(d) for d in jpl] == [tuple(d) for d in tpl]
    with pytest.raises(NotImplementedError):
        tmx.image.ImageDetIter(2, (3, 8, 9), path_imgrec=rec, rand_crop=True)


def test_imdecode_imread_imresize(tmp_path):
    from PIL import Image

    rs = np.random.RandomState(12)
    im = _img(rs, 9, 11, 3)
    Image.fromarray(im).save(tmp_path / "a.png")
    buf = open(tmp_path / "a.png", "rb").read()
    for kw in ({}, {"flag": 0}, {"to_rgb": False}):
        want = jmx.nd.imdecode(buf, **kw).asnumpy()
        got = tmx.nd.imdecode(buf, **kw).asnumpy()
        assert want.dtype == got.dtype
        np.testing.assert_array_equal(got, want)
    np.testing.assert_array_equal(
        tmx.image.imread(str(tmp_path / "a.png")).asnumpy(),
        jmx.image.imread(str(tmp_path / "a.png")).asnumpy())
    for interp in (0, 1):
        for src in (im, im.astype(np.float32)):
            want = jmx.nd.imresize(jmx.nd.array(src, dtype=src.dtype), 6, 13,
                                   interp).asnumpy()
            got = tmx.nd.imresize(tmx.nd.array(src, dtype=src.dtype), 6, 13,
                                  interp).asnumpy()
            assert want.dtype == got.dtype
            _close(torch.from_numpy(got), want,
                   EXACT if src.dtype == np.uint8 else PIX)


# ---------------------------------------------------------------------------
# gluon.data.vision
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("name,kw", [
    ("MNIST", {}), ("FashionMNIST", {"train": False}), ("CIFAR10", {}),
    ("CIFAR100", {"fine_label": True, "train": False}), ("CIFAR100", {}),
])
def test_vision_synthetic_datasets(tmp_path, name, kw):
    """No files under ``root``: the reference's synthetic set, byte for
    byte, and its samples."""
    jd = getattr(jmx.gluon.data.vision, name)(root=str(tmp_path), **kw)
    td = getattr(tmx.gluon.data.vision, name)(root=str(tmp_path), **kw)
    assert len(jd) == len(td)
    np.testing.assert_array_equal(td._data, jd._data)
    np.testing.assert_array_equal(td._label, jd._label)
    ti, tl = td[3]
    ji, jl = jd[3]
    np.testing.assert_array_equal(ti.asnumpy(), ji.asnumpy())
    assert ti.asnumpy().dtype == ji.asnumpy().dtype and tl == jl


def test_vision_reads_mnist_files(tmp_path):
    import struct

    rs = np.random.RandomState(13)
    imgs = rs.randint(0, 256, (5, 28, 28)).astype(np.uint8)
    labs = rs.randint(0, 10, 5).astype(np.uint8)
    with open(tmp_path / "t10k-images-idx3-ubyte", "wb") as f:
        f.write(struct.pack(">IIII", 0x0803, 5, 28, 28) + imgs.tobytes())
    with open(tmp_path / "t10k-labels-idx1-ubyte", "wb") as f:
        f.write(struct.pack(">II", 0x0801, 5) + labs.tobytes())
    td = tmx.gluon.data.vision.MNIST(root=str(tmp_path), train=False)
    jd = jmx.gluon.data.vision.MNIST(root=str(tmp_path), train=False)
    np.testing.assert_array_equal(td._data, jd._data)
    np.testing.assert_array_equal(td._label, jd._label)


def test_vision_transforms(tmp_path):
    rs = np.random.RandomState(14)
    imgs = [_img(rs, 14 + i, 16, 3) for i in range(4)]
    mean, std = (0.485, 0.456, 0.406), (0.229, 0.224, 0.225)

    def pipeline(mx):
        T = mx.gluon.data.vision.transforms
        return [
            T.Compose([T.RandomResizedCrop(8), T.RandomFlipLeftRight(),
                       T.ToTensor(), T.Normalize(mean, std)]),
            T.Compose([T.Resize(9, keep_ratio=True), T.CenterCrop((7, 6)),
                       T.RandomFlipTopBottom(), T.Cast("float16")]),
            T.Compose([T.Resize((10, 5)), T.ToTensor()]),
        ]

    def run(mx):
        return [[t(mx.nd.array(im, dtype="uint8")).asnumpy() for im in imgs]
                for t in pipeline(mx)]

    want, got = _seeded(run)
    for ws, gs in zip(want, got):
        for w, g in zip(ws, gs):
            assert w.dtype == g.dtype, (w.dtype, g.dtype)
            _close(torch.from_numpy(g.astype(np.float32)),
                   w.astype(np.float32), dict(rtol=1e-3, atol=1e-3)
                   if w.dtype == np.float16 else TOL)


def test_image_record_dataset_loader(tmp_path):
    """``ImageRecordDataset`` with ``transform_first`` through a
    ``DataLoader``: the same batches from the same seeds."""
    rs = np.random.RandomState(15)
    rec = _write_rec(tmp_path, [_img(rs, 12, 12, 3) for _ in range(5)],
                     [float(i) for i in range(5)])

    def run(mx):
        T = mx.gluon.data.vision.transforms
        ds = mx.gluon.data.vision.ImageRecordDataset(rec).transform_first(
            T.Compose([T.RandomResizedCrop(8), T.RandomFlipLeftRight(),
                       T.ToTensor(), T.Normalize(0.5, 0.25)]))
        loader = mx.gluon.data.DataLoader(ds, batch_size=2, last_batch="keep")
        return [(x.asnumpy(), y.asnumpy()) for x, y in loader]

    want, got = _seeded(run)
    assert len(want) == len(got) == 3
    for (wx, wy), (gx, gy) in zip(want, got):
        _close(torch.from_numpy(gx), wx, TOL)
        np.testing.assert_array_equal(gy, wy)
