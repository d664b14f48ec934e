"""PyTorch port: every Gluon loss against the JAX package.

The same numpy inputs from a seed go through ``mxnet_tpu.gluon.loss``
(over NDArrays) and ``mxnet_tpu_torch.gluon.loss`` (over tensors), with
the default constructor arguments and with ``weight``, ``sample_weight``,
``batch_axis``, ``sparse_label=False``, ``from_logits=True``,
``from_sigmoid``, ``pos_weight`` and the other options each loss has.
Tolerance: f32 rtol 1e-5 / atol 1e-6 (XLA:CPU and torch evaluate
log-softmax, softplus and the reductions in different orders).
``CTCLoss`` (blank last) against the reference's loss.
"""
import numpy as np
import pytest
import torch

from mxnet_tpu import gluon as jgluon, nd
from mxnet_tpu_torch import gluon as tgluon

TOL = dict(rtol=1e-5, atol=1e-6)
B, C = 4, 5


def _data(seed):
    rs = np.random.RandomState(seed)

    def f(*shape, scale=1.0):
        return (rs.randn(*shape) * scale).astype(np.float32)

    probs = rs.rand(B, C).astype(np.float32) + 0.1
    probs /= probs.sum(1, keepdims=True)
    signs = np.where(rs.rand(B, C) > 0.5, 1.0, -1.0).astype(np.float32)
    return {
        "pred": f(B, C, scale=2.0),
        "label": f(B, C),
        "sparse": rs.randint(0, C, B).astype(np.float32),
        "probs": probs,
        "logp": np.log(probs).astype(np.float32),
        "sigmoid": (1.0 / (1.0 + np.exp(-f(B, C)))).astype(np.float32),
        "binary": (rs.rand(B, C) > 0.5).astype(np.float32),
        "signs": signs,
        "pos_weight": (rs.rand(C) + 0.5).astype(np.float32),
        "sw": (rs.rand(B, 1) + 0.5).astype(np.float32),
        "cos_label": np.where(rs.rand(B) > 0.5, 1.0, -1.0).astype(
            np.float32),
    }


# (loss class name, constructor kwargs, input keys, keyword input keys)
CASES = [
    ("L2Loss", {}, ("pred", "label"), ()),
    ("L2Loss", {"weight": 2.0, "batch_axis": 1}, ("pred", "label"), ()),
    ("L2Loss", {}, ("pred", "label", "sw"), ()),
    ("L1Loss", {}, ("pred", "label"), ()),
    ("L1Loss", {"weight": 0.5}, ("pred", "label", "sw"), ()),
    ("SigmoidBinaryCrossEntropyLoss", {}, ("pred", "binary"), ()),
    ("SigmoidBCELoss", {"weight": 1.5}, ("pred", "binary", "sw"), ()),
    ("SigmoidBCELoss", {}, ("pred", "binary"), ("pos_weight",)),
    ("SigmoidBCELoss", {"from_sigmoid": True}, ("sigmoid", "binary"), ()),
    ("SigmoidBCELoss", {"from_sigmoid": True}, ("sigmoid", "binary"),
     ("pos_weight",)),
    ("SoftmaxCrossEntropyLoss", {}, ("pred", "sparse"), ()),
    ("SoftmaxCELoss", {"weight": 0.7}, ("pred", "sparse", "sw"), ()),
    ("SoftmaxCELoss", {"sparse_label": False}, ("pred", "probs"), ()),
    ("SoftmaxCELoss", {"from_logits": True}, ("logp", "sparse"), ()),
    ("SoftmaxCELoss", {"from_logits": True, "sparse_label": False},
     ("logp", "probs", "sw"), ()),
    ("KLDivLoss", {}, ("logp", "probs"), ()),
    ("KLDivLoss", {"from_logits": False, "weight": 2.0},
     ("pred", "probs", "sw"), ()),
    ("HuberLoss", {}, ("pred", "label"), ()),
    ("HuberLoss", {"rho": 0.5, "weight": 3.0}, ("pred", "label", "sw"), ()),
    ("HingeLoss", {}, ("pred", "signs"), ()),
    ("HingeLoss", {"margin": 2, "weight": 0.5}, ("pred", "signs", "sw"), ()),
    ("SquaredHingeLoss", {}, ("pred", "signs"), ()),
    ("SquaredHingeLoss", {"margin": 0.5}, ("pred", "signs", "sw"), ()),
    ("LogisticLoss", {}, ("pred", "signs"), ()),
    ("LogisticLoss", {"label_format": "binary", "weight": 2.0},
     ("pred", "binary", "sw"), ()),
    ("TripletLoss", {}, ("pred", "label", "probs"), ()),
    ("TripletLoss", {"margin": 0.1, "weight": 2.0},
     ("pred", "label", "probs"), ()),
    ("CosineEmbeddingLoss", {}, ("pred", "label", "cos_label"), ()),
    ("CosineEmbeddingLoss", {"margin": 0.2, "weight": 0.5},
     ("pred", "label", "cos_label"), ()),
]


@pytest.mark.parametrize("i", range(len(CASES)),
                         ids=[f"{c[0]}-{j}" for j, c in enumerate(CASES)])
def test_loss_matches_jax(i):
    name, kw, keys, kwkeys = CASES[i]
    data = _data(100 + i)
    jl = getattr(jgluon.loss, name)(**kw)
    tl = getattr(tgluon.loss, name)(**kw)
    want = jl(*(nd.array(data[k]) for k in keys),
              **{k: nd.array(data[k]) for k in kwkeys})
    got = tl(*(torch.from_numpy(data[k]) for k in keys),
             **{k: torch.from_numpy(data[k]) for k in kwkeys})
    want = want.asnumpy()
    assert tuple(got.shape) == want.shape and got.dtype == torch.float32
    np.testing.assert_allclose(got.numpy(), want, **TOL)


def test_aliases_and_signatures():
    assert tgluon.loss.SoftmaxCELoss is tgluon.loss.SoftmaxCrossEntropyLoss
    assert tgluon.loss.SigmoidBCELoss is \
        tgluon.loss.SigmoidBinaryCrossEntropyLoss
    assert set(tgluon.loss.__all__) == set(jgluon.loss.__all__)
    loss = tgluon.loss.SoftmaxCrossEntropyLoss()
    assert isinstance(loss, tgluon.HybridBlock)
    assert repr(loss) == repr(jgluon.loss.SoftmaxCrossEntropyLoss())
    assert not list(loss.collect_params())


def test_softmax_ce_gradient_matches_closed_form():
    """The loss is differentiable through the op namespace: d/dpred of the
    mean sparse softmax cross-entropy is (softmax - onehot) / B."""
    data = _data(7)
    pred = torch.from_numpy(data["pred"]).requires_grad_()
    label = torch.from_numpy(data["sparse"])
    tgluon.loss.SoftmaxCrossEntropyLoss()(pred, label).mean().backward()
    p = np.exp(data["pred"]) / np.exp(data["pred"]).sum(1, keepdims=True)
    p[np.arange(B), data["sparse"].astype(int)] -= 1.0
    np.testing.assert_allclose(pred.grad.numpy(), p / B, rtol=1e-5,
                               atol=1e-6)


@pytest.mark.parametrize("layout,label_layout,lengths", [
    ("NTC", "NT", "none"), ("TNC", "TN", "none"), ("NTC", "TN", "both"),
    ("NTC", "NT", "pred"), ("TNC", "NT", "label")])
def test_ctc_loss_not_ported(layout, label_layout, lengths):
    """``CTCLoss`` is ported now (the name is the one the test had while
    it held the refusal): blank last, against the reference's loss in
    each activation and label layout, with and without the prediction
    and label lengths."""
    rs = np.random.RandomState(5)
    pred = rs.randn(3, 6, 5).astype(np.float32)           # N, T, C
    label = np.asarray([[0, 1, 2], [3, 3, -1], [2, -1, -1]], np.float32)
    if layout == "TNC":
        pred = np.ascontiguousarray(pred.transpose(1, 0, 2))
    if label_layout == "TN":
        label = np.ascontiguousarray(label.T)
    extra = {"none": [], "both": [[6, 4, 5], [3, 2, 1]],
             "pred": [[5, 6, 4]], "label": [None, [2, 1, 1]]}[lengths]
    extra = [None if e is None else np.asarray(e, np.float32) for e in extra]

    def args(conv):
        return [conv(pred), conv(label)] + [None if e is None else conv(e)
                                            for e in extra]

    want = jgluon.loss.CTCLoss(layout, label_layout)(*args(nd.array))
    got = tgluon.loss.CTCLoss(layout, label_layout)(*args(torch.from_numpy))
    np.testing.assert_allclose(got.numpy(), want.asnumpy(), rtol=1e-5)


def _op_cases():
    rs = np.random.RandomState(11)
    x = rs.randn(3, 4, 5).astype(np.float32)
    y = rs.randn(3, 4, 5).astype(np.float32)
    idx = np.array([[0, 4, 7, -2], [1, 2, 3, 9], [-6, 0, 5, 2]], np.float32)
    idx1 = np.array([[0, 3, 5, -1, 2.7], [1, -7, 2, 8, 0], [3, 3, 0, 1, 6]],
                    np.float32)
    cond = (rs.rand(3, 4, 5) > 0.5).astype(np.float32)
    return [
        ("softmax", (x,), {}), ("softmax", (x,), {"axis": 1}),
        ("softmax", (x,), {"temperature": 2.0}),
        ("log_softmax", (x,), {}), ("log_softmax", (x,), {"axis": 0}),
        ("log_softmax", (x,), {"temperature": 0.5}),
        ("pick", (x, idx), {}), ("pick", (x, idx), {"keepdims": True}),
        ("pick", (x, idx), {"mode": "wrap"}),
        ("pick", (x, idx1), {"axis": 1}),
        ("pick", (x, idx1), {"axis": 1, "mode": "wrap", "keepdims": True}),
        ("norm", (x,), {}), ("norm", (x,), {"ord": 1}),
        ("norm", (x,), {"axis": -1}),
        ("norm", (x,), {"axis": (0, 2), "keepdims": True}),
        ("sum", (x,), {}), ("sum", (x,), {"axis": 1, "keepdims": True}),
        ("sum", (x,), {"axis": 0, "exclude": True}),
        ("mean", (x,), {"axis": (0, 2)}), ("mean", (x,), {}),
        ("where", (cond, x, y), {}), ("reshape_like", (x, y.reshape(6, 10)),
                                      {}),
        ("broadcast_mul", (x, y[:, :1]), {}), ("elemwise_sub", (x, y), {}),
        ("broadcast_div", (x, y + 3.0), {}), ("broadcast_greater", (x, y), {}),
        ("_equal_scalar", (np.round(x),), {"scalar": 1.0}),
        ("_greater_scalar", (x,), {"scalar": 0.5}),
        ("_mul_scalar", (x,), {"scalar": 0.3}),
        ("_add_scalar", (x,), {"scalar": 1e-12}),
        ("_rsub_scalar", (x,), {"scalar": 1.0}),
        ("negative", (x,), {}), ("abs", (x,), {}), ("square", (x,), {}),
        ("relu", (x,), {}), ("log", (np.abs(x) + 0.1,), {}),
    ]


@pytest.mark.parametrize("i", range(len(_op_cases())),
                         ids=[f"{c[0]}-{j}" for j, c in enumerate(_op_cases())])
def test_loss_ops_match_jax(i):
    """The ops the losses call through ``F``, by the reference's names,
    against its registrations (pick's clip and wrap modes, reductions
    with axis, keepdims and exclude, the scalar variants)."""
    from mxnet_tpu import nd as jnd
    from mxnet_tpu_torch import ndarray as tnd

    name, args, kw = _op_cases()[i]
    want = getattr(jnd, name)(*(nd.array(a) for a in args), **kw).asnumpy()
    got = getattr(tnd, name)(*(torch.from_numpy(a) for a in args), **kw)
    assert tuple(got.shape) == want.shape and got.dtype == torch.float32
    np.testing.assert_allclose(got.numpy(), want, **TOL)
