"""PyTorch port: the detection, spatial and CTC ops, the toy SSD and
``gluon.loss.CTCLoss`` against the JAX package.

Each op case gives both registries the same numpy inputs (small, from a
seed) through ``test_torch_ops_breadth.check``: the same dtypes and
number of outputs, float32 values within rtol 1e-5 / atol 1e-6, integer
and index outputs exact, and, where the reference op is differentiable,
the gradient of ``sum(out * c)`` with respect to every float input.  The
NMS outputs (kept rows, their order and the -1 rows) are compared
exactly.  Whole slices: three ``ToySSD`` steps (example/ssd/train.py's
loop: MultiBoxPrior, MultiBoxTarget, softmax cross-entropy + Huber,
Adam) and ``MultiBoxDetection`` after them, losses within rtol 1e-4;
the CTC example's BiLSTM through ``gluon.loss.CTCLoss``, loss and
gradients within rtol 1e-4.
"""
import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import mxnet_tpu as jmx
import mxnet_tpu_torch as tmx
from mxnet_tpu.ops.registry import OP_REGISTRY as JREG
from mxnet_tpu_torch.ops.registry import OP_REGISTRY as TREG
from test_torch_ops_breadth import TOL, _close, check

EXACT = dict(rtol=0, atol=0)


@pytest.fixture(autouse=True)
def _cpu():
    with tmx.cpu():
        yield


def _rs(seed):
    return np.random.RandomState(seed)


def _boxes(rs, *lead, lo=0.0, hi=1.0):
    """Random corner boxes with positive sides."""
    a = rs.uniform(lo, hi, lead + (2,)).astype(np.float32)
    b = rs.uniform(lo, hi, lead + (2,)).astype(np.float32)
    return np.concatenate([np.minimum(a, b), np.maximum(a, b) + 0.05],
                          -1).astype(np.float32)


# ---------------------------------------------------------------------------
# boxes
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("fmt", ["corner", "center"])
def test_box_iou(fmt):
    rs = _rs(1)
    check("_contrib_box_iou", [_boxes(rs, 2, 5), _boxes(rs, 2, 3)],
          {"format": fmt})
    assert TREG["box_iou"] is TREG["_contrib_box_iou"]


def _nms_rows(rs, B, N, classes=3, ties=True):
    rows = np.zeros((B, N, 6), np.float32)
    rows[..., 0] = rs.randint(0, classes, (B, N))
    rows[..., 1] = rs.uniform(0, 1, (B, N))
    if ties:   # equal scores: the stable sort keeps their order
        rows[:, 1::4, 1] = rows[:, 0::4, 1][:, :rows[:, 1::4].shape[1]]
    rows[..., 2:] = _boxes(rs, B, N, hi=0.6)
    return rows


NMS_CASES = {
    "default": {},
    "ids": {"id_index": 0, "overlap_thresh": 0.3},
    "force": {"id_index": 0, "force_suppress": True, "overlap_thresh": 0.2},
    "topk": {"topk": 7, "valid_thresh": 0.2, "overlap_thresh": 0.4},
    "center_out": {"out_format": "center", "overlap_thresh": 0.3},
    "center_in": {"in_format": "center", "id_index": 0},
}


@pytest.mark.parametrize("case", sorted(NMS_CASES))
def test_box_nms(case):
    """Batched through ``check`` (the reference jitted); one image (the
    2-d form) as the batched op's first row.  Jitted on XLA:CPU, the
    reference's 2-d format conversion leaves the last two coordinates
    unconverted; evaluated eagerly it gives the batched row."""
    rs = _rs(2)
    rows = _nms_rows(rs, 2, 16)
    attrs = NMS_CASES[case]
    check("_contrib_box_nms", [rows], attrs, tol=EXACT)
    batched = TREG["box_nms"].fn(torch.from_numpy(rows), **attrs)
    got = TREG["box_nms"].fn(torch.from_numpy(rows[0]), **attrs)
    assert torch.equal(got, batched[0])


def test_box_nms_identical_boxes_and_scores():
    """Equal scores and equal boxes: the first in input order survives."""
    rows = np.tile(np.asarray([[0, 0.5, 0.1, 0.1, 0.4, 0.4]], np.float32),
                   (5, 1))
    rows[3, 1] = 0.9
    check("box_nms", [rows], {"overlap_thresh": 0.5}, tol=EXACT)
    out = TREG["box_nms"].fn(torch.from_numpy(rows))
    assert out[0, 1] == pytest.approx(0.9) and (out[1:, 0] == -1).all()


def test_box_encode_and_bipartite_matching():
    rs = _rs(3)
    samples = rs.uniform(0, 1, (2, 6)).astype(np.float32)
    matches = rs.randint(0, 4, (2, 6)).astype(np.float32)
    anchors = np.abs(rs.randn(2, 6, 4)).astype(np.float32) + 0.2
    refs = np.abs(rs.randn(2, 4, 4)).astype(np.float32) + 0.2
    args = [samples, matches, anchors, refs]
    want = JREG["_contrib_box_encode"].fn(*[jnp.asarray(a) for a in args])
    got = TREG["_contrib_box_encode"].fn(*[torch.from_numpy(a)
                                           for a in args])
    assert len(got) == len(want) == 2
    for g, w in zip(got, want):
        _close(g, w, TOL)
    scores = rs.uniform(0, 1, (2, 5, 4)).astype(np.float32)
    scores[0, 1, 2] = scores[0, 3, 0]    # a tie: the first index wins
    for attrs in ({}, {"threshold": 0.3, "topk": 2},
                  {"is_ascend": True, "threshold": 0.6}):
        check("_contrib_bipartite_matching", [scores], attrs, tol=EXACT)


# ---------------------------------------------------------------------------
# ROI poolings
# ---------------------------------------------------------------------------

def _rois(rs, R, B, H, W, scale=1.0):
    """(R, 5) rois in input pixels, inside an (H, W) map at ``scale``."""
    x = np.sort(rs.uniform(0, (W - 1) / scale, (R, 2)), 1)
    y = np.sort(rs.uniform(0, (H - 1) / scale, (R, 2)), 1)
    b = rs.randint(0, B, (R, 1))
    return np.concatenate([b, x[:, :1], y[:, :1], x[:, 1:], y[:, 1:]],
                          1).astype(np.float32)


def test_roi_pooling():
    rs = _rs(4)
    data = rs.randn(2, 3, 12, 10).astype(np.float32)
    check("ROIPooling", [data, _rois(rs, 5, 2, 12, 10, 0.5)],
          {"pooled_size": (3, 2), "spatial_scale": 0.5})


@pytest.mark.parametrize("attrs", [
    {"pooled_size": (3, 3), "spatial_scale": 0.5},
    {"pooled_size": (2, 3), "sample_ratio": -1, "aligned": True},
])
def test_roi_align(attrs):
    rs = _rs(5)
    data = rs.randn(2, 3, 4, 6).astype(np.float32)
    check("_contrib_ROIAlign", [data, _rois(rs, 4, 2, 4, 6,
                                            attrs.get("spatial_scale", 1))],
          attrs)


def test_psroi_pooling():
    rs = _rs(6)
    data = rs.randn(2, 2 * 9, 10, 12).astype(np.float32)
    check("_contrib_PSROIPooling", [data, _rois(rs, 4, 2, 10, 12)],
          {"output_dim": 2, "pooled_size": 3, "group_size": 3,
           "spatial_scale": 1.0})


@pytest.mark.parametrize("no_trans", [False, True])
def test_deformable_psroi_pooling(no_trans):
    rs = _rs(7)
    data = rs.randn(2, 2 * 4, 9, 10).astype(np.float32)
    rois = _rois(rs, 3, 2, 9, 10)
    trans = (0.5 * rs.randn(3, 4, 2, 2)).astype(np.float32)
    check("_contrib_DeformablePSROIPooling", [data, rois, trans],
          {"output_dim": 2, "group_size": 2, "pooled_size": 3,
           "part_size": 2, "sample_per_part": 2, "trans_std": 0.1,
           "no_trans": no_trans, "spatial_scale": 1.0})


def test_deformable_convolution():
    rs = _rs(8)
    data = rs.randn(2, 4, 7, 8).astype(np.float32)
    offset = (1.5 * rs.randn(2, 2 * 2 * 9, 7, 8)).astype(np.float32)
    weight = rs.randn(6, 2, 3, 3).astype(np.float32)
    bias = rs.randn(6).astype(np.float32)
    check("_contrib_DeformableConvolution", [data, offset, weight, bias],
          {"kernel": (3, 3), "pad": (1, 1), "num_filter": 6,
           "num_group": 2, "num_deformable_group": 2})


# ---------------------------------------------------------------------------
# spatial transforms
# ---------------------------------------------------------------------------

def test_grid_generator_and_samplers():
    rs = _rs(9)
    theta = (np.asarray([1, 0, 0, 0, 1, 0], np.float32)
             + 0.2 * rs.randn(2, 6)).astype(np.float32)
    check("GridGenerator", [theta], {"transform_type": "affine",
                                     "target_shape": (5, 7)})
    flow = rs.randn(2, 2, 6, 5).astype(np.float32)
    check("GridGenerator", [flow], {"transform_type": "warp"})
    data = rs.randn(2, 3, 6, 5).astype(np.float32)
    grid = rs.uniform(-1.1, 1.1, (2, 2, 4, 7)).astype(np.float32)
    check("BilinearSampler", [data, grid])
    check("SpatialTransformer", [data, theta], {"target_shape": (4, 6)})


@pytest.mark.parametrize("attrs", [
    {"kernel_size": 1, "max_displacement": 2, "pad_size": 2},
    {"kernel_size": 3, "max_displacement": 2, "stride1": 2, "stride2": 2,
     "pad_size": 3, "is_multiply": False},
])
def test_correlation(attrs):
    rs = _rs(10)
    a = rs.randn(2, 3, 8, 9).astype(np.float32)
    b = rs.randn(2, 3, 8, 9).astype(np.float32)
    check("Correlation", [a, b], attrs)


# ---------------------------------------------------------------------------
# SSD and RPN
# ---------------------------------------------------------------------------

def test_multibox_prior():
    rs = _rs(11)
    feat = rs.randn(1, 2, 6, 8).astype(np.float32)
    for attrs in ({"sizes": (0.3, 0.6, 0.9), "ratios": (1.0, 2.0)},
                  {"sizes": "(0.2,0.4)", "ratios": "(1,2,0.5)", "clip": True,
                   "steps": (0.1, 0.2), "offsets": (0.3, 0.6)}):
        check("_contrib_MultiBoxPrior", [feat], attrs)


def _anchors(rs, H=6, W=6):
    feat = torch.zeros(1, 1, H, W)
    return TREG["_contrib_MultiBoxPrior"].fn(
        feat, sizes=(0.3, 0.5), ratios=(1.0, 2.0)).numpy()


def test_multibox_target_shared_anchor():
    """Two ground truths whose best anchor is the same: the later one
    takes it, on both packages; an argmax tie picks the first index."""
    rs = _rs(12)
    anchors = _anchors(rs)
    N = anchors.shape[1]
    a = anchors[0, 40]
    label = np.full((2, 4, 5), -1.0, np.float32)
    label[0, 0] = [0, a[0] + 0.01, a[1], a[2], a[3] - 0.01]
    label[0, 1] = [1, a[0], a[1] + 0.01, a[2] - 0.01, a[3]]
    label[1, :3] = np.concatenate([rs.randint(0, 2, (3, 1)),
                                   _boxes(rs, 3, hi=0.7)], 1)
    cls_pred = rs.randn(2, 3, N).astype(np.float32)
    check("_contrib_MultiBoxTarget", [anchors, label, cls_pred],
          {"overlap_threshold": 0.5}, tol=TOL)
    got = TREG["_contrib_MultiBoxTarget"].fn(*[torch.from_numpy(x) for x in
                                              (anchors, label, cls_pred)])
    assert float(got[2][0, 40]) == 2.0     # gt 1 (class 1) + 1
    check("_contrib_MultiBoxTarget", [anchors, label, cls_pred],
          {"negative_mining_ratio": 3.0, "minimum_negative_samples": 2,
           "negative_mining_thresh": 0.4, "ignore_label": -1.0})


def test_multibox_detection():
    rs = _rs(13)
    anchors = _anchors(rs)
    N = anchors.shape[1]
    logits = 2.0 * rs.randn(2, 4, N).astype(np.float32)
    probs = np.exp(logits) / np.exp(logits).sum(1, keepdims=True)
    loc = (0.5 * rs.randn(2, N * 4)).astype(np.float32)
    for attrs in ({}, {"nms_threshold": 0.45, "threshold": 0.2},
                  {"nms_topk": 20, "force_suppress": True, "clip": False}):
        check("_contrib_MultiBoxDetection",
              [probs.astype(np.float32), loc, anchors], attrs, tol=TOL)


@pytest.mark.parametrize("name,attrs", [
    ("_contrib_Proposal", {"rpn_pre_nms_top_n": 60, "rpn_post_nms_top_n": 12,
                           "threshold": 0.6, "rpn_min_size": 4,
                           "scales": (2.0, 4.0), "ratios": (0.5, 1.0, 2.0),
                           "feature_stride": 8}),
    ("_contrib_MultiProposal", {"rpn_pre_nms_top_n": 40,
                                "rpn_post_nms_top_n": 50, "threshold": 0.5,
                                "rpn_min_size": 8, "scales": (4.0,),
                                "ratios": (1.0, 2.0), "feature_stride": 8,
                                "output_score": True}),
])
def test_proposal(name, attrs):
    rs = _rs(14)
    A = len(attrs["scales"]) * len(attrs["ratios"])
    H, W = 5, 6
    cls = rs.uniform(0, 1, (2, 2 * A, H, W)).astype(np.float32)
    bbox = (0.3 * rs.randn(2, 4 * A, H, W)).astype(np.float32)
    info = np.asarray([[40, 48, 1.0], [36, 44, 0.8]], np.float32)
    if not attrs.get("output_score"):
        check(name, [cls, bbox, info], attrs, tol=TOL)
        return
    # two outputs where the registry declares one, in both packages
    want = jax.jit(functools.partial(JREG[name].fn, **attrs))(
        *[jnp.asarray(a) for a in (cls, bbox, info)])
    got = TREG[name].fn(*[torch.from_numpy(a) for a in (cls, bbox, info)],
                        **attrs)
    assert len(got) == len(want) == 2
    for g, w in zip(got, want):
        _close(g, w, TOL)


# ---------------------------------------------------------------------------
# CTC
# ---------------------------------------------------------------------------

def _ctc_inputs(rs, T=7, B=4, A=6, L=3, blank="first"):
    data = rs.randn(T, B, A).astype(np.float32)
    if blank == "first":
        label = rs.randint(1, A, (B, L)).astype(np.float32)
        label[1, 2:] = 0          # a shorter label, 0-padded
        label[2, 1] = label[2, 0]  # a repeat (no skip between them)
    else:
        label = rs.randint(0, A - 1, (B, L)).astype(np.float32)
        label[1, 2:] = -1
        label[2, 1] = label[2, 0]
    return data, label


@pytest.mark.parametrize("blank", ["first", "last"])
def test_ctc_loss(blank):
    rs = _rs(15)
    data, label = _ctc_inputs(rs, blank=blank)
    check("_contrib_CTCLoss", [data, label], {"blank_label": blank},
          tol=dict(rtol=1e-5, atol=1e-5))
    dl = np.asarray([7, 6, 7, 5], np.float32)
    ll = np.asarray([3, 2, 1, 2], np.float32)
    check("CTCLoss", [data, label, dl, ll],
          {"blank_label": blank, "use_data_lengths": True,
           "use_label_lengths": True}, tol=dict(rtol=1e-5, atol=1e-5))


def test_ctc_loss_infeasible_label():
    """A label longer than the sequence: the loss sits at the -1e30
    floor's negation, its gradient the reference's."""
    rs = _rs(16)
    data = rs.randn(3, 2, 5).astype(np.float32)
    label = np.asarray([[1, 2, 3, 4], [1, 1, 0, 0]], np.float32)
    check("ctc_loss", [data, label], tol=dict(rtol=1e-5, atol=1e-5))


def _column_bilstm(mx, hidden, classes):
    gluon = mx.gluon

    class ColumnBiLSTM(gluon.HybridBlock):
        def __init__(self, **kw):
            super().__init__(**kw)
            with self.name_scope():
                self.lstm = gluon.rnn.LSTM(hidden, bidirectional=True,
                                           layout="NTC")
                self.head = gluon.nn.Dense(classes, flatten=False)

        def hybrid_forward(self, F, x):
            return self.head(self.lstm(F.transpose(x, axes=(0, 2, 1))))

    return ColumnBiLSTM()


def test_gluon_ctc_loss_slice():
    """The CTC example's BiLSTM (hidden 8) on its glyph stripes through
    ``gluon.loss.CTCLoss`` (blank last), with and without lengths: loss
    and every parameter gradient."""
    rs = _rs(17)
    B, T, H = 4, 8, 6
    x = rs.rand(B, H, T).astype(np.float32)
    y = rs.randint(0, 10, (B, 3)).astype(np.float32)
    pl = np.asarray([8, 6, 7, 8], np.float32)
    yl = np.asarray([3, 2, 3, 1], np.float32)
    jnet = _column_bilstm(jmx, 8, 11)
    jnet.initialize(jmx.init.Xavier())
    tnet = _column_bilstm(tmx, 8, 11)
    tnet.initialize(tmx.init.Xavier(), ctx=tmx.cpu())
    jnet(jmx.nd.array(x))
    tnet(tmx.nd.array(x))
    jp = {k: v.data().asnumpy() for k, v in jnet.collect_params().items()}
    tmx.gluon.params_from_jax(tnet, jp)
    for args in ((), (pl, yl)):
        losses = []
        for mx, net in ((jmx, jnet), (tmx, tnet)):
            loss_fn = mx.gluon.loss.CTCLoss()
            with mx.autograd.record():
                out = net(mx.nd.array(x))
                L = loss_fn(out, mx.nd.array(y),
                            *[mx.nd.array(a) for a in args])
            L.backward()
            grads = [p.grad().asnumpy() for p in
                     net.collect_params().values()]
            losses.append((L.asnumpy(), grads))
        np.testing.assert_allclose(losses[1][0], losses[0][0], rtol=1e-4)
        for g, w in zip(losses[1][1], losses[0][1]):
            np.testing.assert_allclose(g, w, rtol=1e-4, atol=1e-5)


# ---------------------------------------------------------------------------
# the toy SSD (example/ssd/train.py)
# ---------------------------------------------------------------------------

def toy_ssd(mx, num_classes, num_anchors):
    gluon, nn, nd = mx.gluon, mx.gluon.nn, mx.nd

    class ToySSD(gluon.Block):
        """example/ssd/train.py's, its NDArray methods as ``nd`` calls
        (the port's blocks compute on tensors)."""

        def __init__(self, **kwargs):
            super().__init__(**kwargs)
            with self.name_scope():
                self.body = nn.Sequential()
                for f in (16, 32, 64):
                    self.body.add(nn.Conv2D(f, 3, padding=1, strides=2,
                                            activation="relu"))
                self.cls_head = nn.Conv2D(num_anchors * (num_classes + 1), 3,
                                          padding=1)
                self.loc_head = nn.Conv2D(num_anchors * 4, 3, padding=1)

        def forward(self, x):
            feat = self.body(x)
            cls = self.cls_head(feat)
            loc = self.loc_head(feat)
            B = x.shape[0]
            cls = nd.reshape(nd.transpose(cls, axes=(0, 2, 3, 1)),
                             shape=(B, -1, num_classes + 1))
            loc = nd.reshape(nd.transpose(loc, axes=(0, 2, 3, 1)),
                             shape=(B, -1))
            return feat, cls, loc

    return ToySSD()


def synthetic_batch(rs, batch_size, size=64):
    """example/ssd/train.py's: one square per image, its class's channel."""
    X = np.zeros((batch_size, 3, size, size), np.float32)
    Y = np.zeros((batch_size, 1, 5), np.float32)
    for i in range(batch_size):
        cls = rs.randint(0, 2)
        w = rs.randint(size // 4, size // 2)
        l = rs.randint(0, size - w)
        t = rs.randint(0, size - w)
        X[i, cls, t:t + w, l:l + w] = 1.0
        Y[i, 0] = [cls, l / size, t / size, (l + w) / size, (t + w) / size]
    return X, Y


SSD_SIZES, SSD_RATIOS = (0.3, 0.6, 0.9), (1.0, 2.0)


def ssd_steps(mx, net, batches, lr=0.005):
    """example/ssd/train.py's loop over ``batches``: the (cls, loc) losses
    of each step, then MultiBoxDetection on the last batch's images."""
    nd, gluon, autograd = mx.nd, mx.gluon, mx.autograd
    trainer = gluon.Trainer(net.collect_params(), "adam",
                            {"learning_rate": lr})
    cls_loss = gluon.loss.SoftmaxCrossEntropyLoss()
    loc_loss = gluon.loss.HuberLoss()
    losses = []
    for X, Y in batches:
        X, Y = nd.array(X), nd.array(Y)
        with autograd.record():
            feat, cls_preds, loc_preds = net(X)
            anchors = nd.contrib.MultiBoxPrior(feat, sizes=SSD_SIZES,
                                               ratios=SSD_RATIOS)
            loc_t, loc_m, cls_t = nd.contrib.MultiBoxTarget(
                anchors, Y, cls_preds.transpose((0, 2, 1)))
            L_cls = cls_loss(cls_preds, cls_t)
            L_loc = loc_loss(loc_preds * loc_m, loc_t * loc_m)
            L = L_cls + L_loc
        L.backward()
        trainer.step(X.shape[0])
        losses.append((L_cls.asnumpy(), L_loc.asnumpy()))
    feat, cls_preds, loc_preds = net(X)
    anchors = nd.contrib.MultiBoxPrior(feat, sizes=SSD_SIZES,
                                       ratios=SSD_RATIOS)
    probs = nd.softmax(cls_preds, axis=-1).transpose((0, 2, 1))
    dets = nd.contrib.MultiBoxDetection(probs, loc_preds, anchors,
                                        nms_threshold=0.45)
    return losses, dets.asnumpy()


def test_toy_ssd_three_steps():
    rs = np.random.RandomState(0)
    batches = [synthetic_batch(rs, 2) for _ in range(3)]
    A = len(SSD_SIZES) + len(SSD_RATIOS) - 1
    jnet = toy_ssd(jmx, 2, A)
    jnet.initialize(jmx.init.Xavier())
    tnet = toy_ssd(tmx, 2, A)
    tnet.initialize(tmx.init.Xavier(), ctx=tmx.cpu())
    x0 = batches[0][0]
    jnet(jmx.nd.array(x0))
    tnet(tmx.nd.array(x0))
    tmx.gluon.params_from_jax(tnet, {k: v.data().asnumpy() for k, v in
                                     jnet.collect_params().items()})
    jl, jdet = ssd_steps(jmx, jnet, batches)
    tl, tdet = ssd_steps(tmx, tnet, batches)
    for (jc, jloc), (tc, tloc) in zip(jl, tl):
        np.testing.assert_allclose(tc, jc, rtol=1e-4, atol=1e-6)
        np.testing.assert_allclose(tloc, jloc, rtol=1e-4, atol=1e-6)
    np.testing.assert_array_equal(tdet[..., 0], jdet[..., 0])
    np.testing.assert_allclose(tdet, jdet, rtol=1e-4, atol=1e-5)


def _ssd_graph(mx):
    """An SSD-style graph over the new ops, every node named."""
    sym = mx.sym
    data = sym.var("data")
    label = sym.var("label")
    rois = sym.var("rois")
    feat = sym.Convolution(data, num_filter=8, kernel=(3, 3), pad=(1, 1),
                           name="feat")
    cls = sym.Convolution(feat, num_filter=3 * 3, kernel=(1, 1), name="cls")
    loc = sym.Convolution(feat, num_filter=3 * 4, kernel=(1, 1), name="loc")
    cls = sym.reshape(sym.transpose(cls, axes=(0, 2, 3, 1)),
                      shape=(0, -1, 3), name="cls_flat")
    loc = sym.flatten(sym.transpose(loc, axes=(0, 2, 3, 1)), name="loc_flat")
    anchors = sym.contrib.MultiBoxPrior(feat, sizes=(0.3, 0.6),
                                        ratios=(1.0, 2.0), name="anchors")
    target = sym.contrib.MultiBoxTarget(anchors, label,
                                        sym.transpose(cls, axes=(0, 2, 1)),
                                        name="target")
    det = sym.contrib.MultiBoxDetection(
        sym.softmax(sym.transpose(cls, axes=(0, 2, 1)), axis=1), loc,
        anchors, nms_threshold=0.45, name="det")
    pooled = sym.ROIPooling(feat, rois, pooled_size=(2, 2),
                            spatial_scale=0.5, name="roipool")
    aligned = sym.contrib.ROIAlign(feat, rois, pooled_size=(2, 2),
                                   name="roialign")
    return sym.Group([target[0], target[2], det, pooled, aligned])


def test_graph_json_with_detection_ops():
    """The graph's JSON is the reference's bytes, and each package loads
    the other's; the port's bound graph runs."""
    graphs = []
    for mx in (jmx, tmx):
        with mx.name.NameManager():
            graphs.append(_ssd_graph(mx))
    js, ts = graphs
    assert ts.tojson() == js.tojson()
    assert tmx.sym.load_json(js.tojson()).tojson() == js.tojson()
    assert jmx.sym.load_json(ts.tojson()).tojson() == js.tojson()
    rs = _rs(18)
    args = {"data": rs.randn(2, 3, 8, 8).astype(np.float32),
            "label": np.asarray([[[0, .1, .1, .5, .6]], [[1, .3, .2, .9, .8]]],
                                np.float32),
            "rois": _rois(rs, 3, 2, 8, 8, 0.5)}
    shapes = {k: v.shape for k, v in args.items()}
    ex = ts.simple_bind(ctx=tmx.cpu(), grad_req="null", **shapes)
    outs = ex.forward(is_train=False, **{k: tmx.nd.array(v)
                                         for k, v in args.items()})
    assert [o.shape for o in outs] == [(2, 64 * 3 * 4), (2, 64 * 3),
                                       (2, 64 * 3, 6), (3, 8, 2, 2),
                                       (3, 8, 2, 2)]


def test_relu_gradient_at_zero():
    """``Activation(relu)`` and ``relu`` are ``max(x, 0)`` as in the
    reference: half the gradient at exactly 0 (the toy SSD's zero-bias
    convolutions over blank image regions sit there)."""
    x = np.asarray([[-1.0, 0.0, 2.0], [0.0, 3.0, -0.5]], np.float32)
    check("Activation", [x], {"act_type": "relu"})
    check("relu", [x])
    t = torch.from_numpy(x).requires_grad_(True)
    TREG["relu"].fn(t).sum().backward()
    assert t.grad.tolist() == [[0.0, 0.5, 1.0], [0.5, 1.0, 0.0]]


@pytest.mark.parametrize("op", ["box_nms", "_image_random_color_jitter"])
def test_host_reads_keep_a_program_uncaptured(op):
    """NMS's greedy pass and color jitter's order are read on the host:
    inside a hybridized block's program each marks the program
    (``cached_op.note_host_sync``), which on the card then runs
    uncaptured, as one with a ``Custom`` op does; outside a program
    nothing is marked."""
    from mxnet_tpu_torch.gluon import cached_op

    rs = _rs(19)
    if op == "box_nms":
        x = tmx.nd.array(_nms_rows(rs, 2, 8))

        def run():
            return tmx.nd.contrib.box_nms(x, overlap_thresh=0.3)
    else:
        x = tmx.nd.array(rs.rand(3, 5, 4).astype(np.float32))

        def run():
            return tmx.nd.image.random_color_jitter(x, brightness=0.3,
                                                    hue=0.1)
    cached_op._tls.host_sync = None
    try:
        run()
        assert cached_op._tls.host_sync is None
        with cached_op.program_scope():
            run()
        assert cached_op._tls.host_sync == op
    finally:
        cached_op._tls.host_sync = None
