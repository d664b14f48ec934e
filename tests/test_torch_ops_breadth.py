"""PyTorch port: the operator breadth of ``mxnet_tpu_torch.ops`` against the
JAX package's ops, one case per registered name.

Each case calls the reference op (``mxnet_tpu.ops.registry.OP_REGISTRY``)
eagerly on the CPU and the port's op on CPU tensors with the same numpy
inputs (small, made from a seed) and attributes, and asserts:
- the same output dtypes, and the same number of outputs;
- float32 values within rtol 1e-5 / atol 1e-6, integer values exact
  (the ``linalg_*`` decompositions compare reconstructions, since a
  factor's signs are free);
- where the reference op is differentiable and its output float, the
  gradient of ``sum(out * c)`` (``c`` random) with respect to every float
  input, at the same tolerance (the reference through ``jax.vjp``);
- the sampling ops bit for bit (int32 tokens from the same key).

The flash attention op runs the reference's Pallas kernels through the
interpreter (``TPUMX_PALLAS=1`` for its backward) against the port's
plain versions, at ``tests/test_torch_flash_attention.py``'s tolerances.
The registry check holds the port to at least 379 of the reference's op
names, every absent one in a family ROADMAP.md still lists.
"""
import zlib

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import mxnet_tpu  # noqa: F401  (registers the reference's ops)
import mxnet_tpu_torch as tmx
from mxnet_tpu.ops.registry import OP_REGISTRY as JREG
from mxnet_tpu_torch.base import dtype_name
from mxnet_tpu_torch.ops.registry import OP_REGISTRY as TREG

TOL = dict(rtol=1e-5, atol=1e-6)


@pytest.fixture(autouse=True)
def _cpu():
    with tmx.cpu():
        yield


def _rs(name):
    return np.random.RandomState(zlib.crc32(name.encode()) % (2 ** 31))


def _f32(*shape, lo=None, hi=None, name="x"):
    rs = _rs(name + str(shape))
    if lo is None:
        return rs.randn(*shape).astype(np.float32)
    return rs.uniform(lo, hi, shape).astype(np.float32)


def _to_torch(a, grad):
    t = torch.from_numpy(np.ascontiguousarray(a))
    if grad and t.dtype.is_floating_point:
        t.requires_grad_(True)
    return t


def _listed(r):
    return list(r) if isinstance(r, (tuple, list)) else [r]


def _close(got, want, tol):
    w = np.asarray(want)
    g = got.detach().numpy() if isinstance(got, torch.Tensor) else \
        np.asarray(got)
    assert str(w.dtype) == str(g.dtype), (w.dtype, g.dtype)
    assert w.shape == g.shape, (w.shape, g.shape)
    if w.dtype.kind == "f":
        np.testing.assert_allclose(g, w, **tol)
    else:
        np.testing.assert_array_equal(g, w)


def _reference(jop, inputs, attrs, fidx, grad_rs):
    """The reference op's outputs and, for its float outputs, the
    gradient of ``sum(out * c)`` (``c`` from ``grad_rs``) with respect to
    the float inputs ``fidx``: one jitted program (an op that cannot be
    traced runs eagerly)."""
    def fwd(*args):
        return _listed(jop.fn(*args, **attrs))

    args = [jnp.asarray(a) for a in inputs]
    try:
        want = jax.jit(fwd)(*args)
    except jax.errors.JAXTypeError:
        want = fwd(*args)
        return want, None, None
    outs = [i for i, w in enumerate(want)
            if jnp.issubdtype(w.dtype, jnp.floating)]
    if grad_rs is None or not outs or not fidx:
        return want, None, None
    cots = [np.asarray(grad_rs.randn(*want[i].shape), np.float32)
            for i in outs]

    def loss(*fl):
        a = list(args)
        for i, v in zip(fidx, fl):
            a[i] = v
        r = fwd(*a)
        return sum(jnp.sum(r[i] * c) for i, c in zip(outs, cots))

    grads = jax.jit(jax.grad(loss, argnums=tuple(range(len(fidx)))))(
        *[args[i] for i in fidx])
    return want, [outs, cots], grads


def check(name, inputs, attrs=None, grad=True, tol=TOL, compare=None):
    """Hold the port's op ``name`` against the reference's on ``inputs``
    (numpy arrays): outputs, dtypes and, where the reference op is
    differentiable, the gradient of every float input."""
    attrs = dict(attrs or {})
    jop, top = JREG[name], TREG[name]
    assert top.name == jop.name, (top.name, jop.name)
    assert top.differentiable == jop.differentiable
    assert top.rng == jop.rng
    fidx = [i for i, a in enumerate(inputs) if a.dtype.kind == "f"]
    do_grad = grad and jop.differentiable and bool(fidx)
    want, cot, jg = _reference(jop, inputs, attrs, fidx,
                               _rs(name + "cot") if do_grad else None)
    tins = [_to_torch(a, do_grad) for a in inputs]
    got = _listed(top.fn(*tins, **attrs))
    assert len(got) == len(want) == top.n_outputs(attrs)
    assert [dtype_name(g.dtype) for g in got] == \
        [str(w.dtype) for w in want]
    if compare is not None:
        compare([np.asarray(w) for w in want],
                [g.detach().numpy() for g in got], inputs)
    else:
        for g, w in zip(got, want):
            _close(g, w, tol)
    if jg is None:
        return
    outs, cots = cot
    loss = sum((got[i] * torch.from_numpy(c)).sum()
               for i, c in zip(outs, cots))
    leaves = [tins[i] for i in fidx]
    if not loss.requires_grad:   # no input reaches the output (BlockGrad)
        tg = [torch.zeros_like(t) for t in leaves]
    else:
        tg = torch.autograd.grad(loss, leaves, allow_unused=True)
        tg = [torch.zeros_like(t) if g is None else g
              for g, t in zip(tg, leaves)]
    for g, w in zip(tg, jg):
        _close(g, w, tol)


# ---------------------------------------------------------------------------
# 1. elementwise math
# ---------------------------------------------------------------------------

_POS = dict(lo=0.5, hi=2.0)
_UNIT = dict(lo=-0.9, hi=0.9)
UNARY_DOMAIN = {
    "floor": {}, "ceil": {}, "round": {}, "rint": {}, "fix": {},
    "trunc": {}, "reciprocal": _POS, "rsqrt": _POS, "cbrt": _POS,
    "rcbrt": _POS, "log1p": _POS, "expm1": {}, "log2": _POS,
    "log10": _POS, "sin": {}, "cos": {}, "tan": _UNIT, "arcsin": _UNIT,
    "arccos": _UNIT, "arctan": {}, "sinh": {}, "cosh": {}, "arcsinh": {},
    "arccosh": dict(lo=1.2, hi=3.0), "arctanh": _UNIT, "erf": {},
    "erfinv": _UNIT, "gamma": _POS, "gammaln": _POS, "degrees": {},
    "radians": {}, "softsign": {}, "hard_sigmoid": {},
}
BINARY = ["elemwise_hypot", "broadcast_hypot", "_hypot",
          "elemwise_logical_and", "elemwise_logical_or",
          "elemwise_logical_xor", "broadcast_logical_and",
          "broadcast_logical_or", "broadcast_logical_xor", "_logical_and",
          "_logical_or", "_logical_xor"]
SCALAR = {"_hypot_scalar": 1.5, "_logical_and_scalar": 1.0,
          "_logical_or_scalar": 0.0, "_logical_xor_scalar": 1.0,
          "_plus_scalar": 2.5, "_minus_scalar": 2.5, "_rminus_scalar": 2.5}
ELEMWISE = sorted(UNARY_DOMAIN) + ["logical_not"] + BINARY + sorted(SCALAR)


def _with_zeros(x):
    x = x.copy()
    x.flat[::3] = 0.0
    return x


@pytest.mark.parametrize("name", ELEMWISE)
def test_elemwise(name):
    x = _f32(3, 4, name=name, **UNARY_DOMAIN.get(name, {}))
    if name in ("floor", "ceil", "round", "rint", "fix", "trunc"):
        x = x * 3.0
    if name in UNARY_DOMAIN:
        check(name, [x])
    elif name == "logical_not":
        check(name, [_with_zeros(x)])
    elif name in SCALAR:
        if "logical" in name:
            x = _with_zeros(x)
        check(name, [x], {"scalar": SCALAR[name]})
    else:
        y = _f32(1 if name.startswith("broadcast") else 3, 4, name=name + "y")
        if "logical" in name:
            x, y = _with_zeros(x), _with_zeros(y)
        check(name, [x, y])


@pytest.mark.parametrize("name", ["floor", "logical_not", "_logical_or",
                                  "rint", "erfinv"])
def test_elemwise_int32(name):
    """Integer input: the rounding functions keep int32, the rest
    compute as the reference promotes them."""
    a = (np.arange(12, dtype=np.int32).reshape(3, 4) % 5) - 1
    check(name, [a, a[::-1].copy()] if name == "_logical_or" else [a],
          tol=dict(rtol=1e-5, atol=0, equal_nan=True))


# ---------------------------------------------------------------------------
# 2. gradient and sum
# ---------------------------------------------------------------------------

GRAD_SUM = ["BlockGrad", "stop_gradient", "stop_gradient_identity",
            "make_loss", "identity", "_identity_with_attr_like_rhs",
            "add_n", "ElementWiseSum", "_grad_add_n", "_grad_add"]


@pytest.mark.parametrize("name", GRAD_SUM)
def test_grad_and_sum(name):
    xs = [_f32(3, 4, name=name + str(i)) for i in range(3)]
    n = 3 if name in ("add_n", "ElementWiseSum", "_grad_add_n") else \
        2 if name in ("_grad_add", "_identity_with_attr_like_rhs") else 1
    check(name, xs[:n])


# ---------------------------------------------------------------------------
# 3. ordering and reductions
# ---------------------------------------------------------------------------

ORDERING = {
    "sort": ({"axis": 1, "is_ascend": False},),
    "argsort": ({"axis": 0},),
    "topk": ({"axis": 1, "k": 2, "ret_typ": "both"},),
    "histogram": ({"bin_cnt": 5},),
    "_histogram": ({"bin_cnt": 4, "range": (-1.0, 1.0)},),
    "nansum": ({"axis": 1},),
    "nanprod": ({},),
    "argmax_channel": ({},),
    "_square_sum": ({"axis": 0, "keepdims": True},),
}


@pytest.mark.parametrize("name", sorted(ORDERING))
def test_ordering(name):
    x = _f32(3, 4, name=name)
    if name in ("nansum", "nanprod"):
        x[0, 1] = np.nan
    check(name, [x], ORDERING[name][0])


def test_sort_ties_and_topk_mask():
    """Equal keys: descending sort and argsort reverse the ascending order;
    ``topk`` keeps lower indices first; the mask marks the k entries."""
    x = np.array([[1, 3, 3, 0], [2, 2, 2, 1], [5, 4, 5, 4]], np.float32)
    check("argsort", [x], {"is_ascend": False}, grad=False)
    check("topk", [x], {"k": 2}, grad=False)
    check("topk", [x], {"k": 3, "ret_typ": "mask", "is_ascend": True},
          grad=False)
    check("topk", [x], {"axis": None, "k": 4, "ret_typ": "value"},
          grad=False)


# ---------------------------------------------------------------------------
# 4. indexing and creation
# ---------------------------------------------------------------------------

def _indexing_case(name):
    x = _f32(3, 4, name=name)
    idx2 = np.array([[0, 2, -1], [1, 3, 0]], np.int32)
    flat = np.array([0, 5, 11, 7], np.int32)
    sl = {"begin": (0, 1), "end": (2, 4), "step": (1, 2)}
    return {
        "gather_nd": ([x, idx2], {}),
        "scatter_nd": ([_f32(3, name=name), np.array([[0, 2, 0],
                                                       [1, 3, 1]],
                                                      np.int32)],
                       {"shape": (3, 4)}),
        "batch_take": ([x, np.array([3, 0, 1], np.int32)], {}),
        "slice_like": ([x, _f32(2, 3, name="like")], {"axes": (0, 1)}),
        "_slice_assign": ([x, _f32(2, 2, name="rhs")], sl),
        "_slice_assign_scalar": ([x], dict(sl, scalar=7.0)),
        "ravel_multi_index": ([np.array([[0, 2, 1], [3, 1, 0]], np.int32)],
                              {"shape": (3, 4)}),
        "_ravel_multi_index": ([np.array([[0, 2, 1], [3, 1, 0]],
                                         np.float32)], {"shape": (3, 4)}),
        "unravel_index": ([flat], {"shape": (3, 4)}),
        "_unravel_index": ([flat.astype(np.float32)], {"shape": (3, 4)}),
        "diag": ([x], {"k": 1}),
        "roll": ([x], {"shift": 2, "axis": 1}),
        "shape_array": ([x], {}),
        "size_array": ([x], {}),
        "broadcast_axis": ([x[:, :1].copy()], {"axis": 1, "size": 5}),
        "broadcast_axes": ([x[None]], {"axis": (0,), "size": (2,)}),
        "_arange": ([], {"start": 1.0, "stop": 4.0, "step": 0.7,
                         "repeat": 2}),
        "_zeros": ([], {"shape": (2, 3), "dtype": "int32"}),
        "_ones": ([], {"shape": (2, 3)}),
        "_full": ([], {"shape": (3,), "value": 2.5}),
        "_eye": ([], {"N": 3, "M": 4, "k": 1}),
        "_copy": ([x], {}),
        "amp_cast": ([x * 100], {"dtype": "int8"}),
        "_rnn_param_concat": ([x, _f32(3, 2, name="b")], {"dim": 1}),
    }[name]


INDEXING = ["gather_nd", "scatter_nd", "batch_take", "slice_like",
            "_slice_assign", "_slice_assign_scalar", "ravel_multi_index",
            "_ravel_multi_index", "unravel_index", "_unravel_index", "diag",
            "roll", "shape_array", "size_array", "broadcast_axis",
            "broadcast_axes", "_arange", "_zeros", "_ones", "_full", "_eye",
            "_copy", "amp_cast", "_rnn_param_concat"]


@pytest.mark.parametrize("name", INDEXING)
def test_indexing_and_creation(name):
    inputs, attrs = _indexing_case(name)
    check(name, inputs, attrs)


def test_slice_assign_negative_step():
    x = _f32(4, 5, name="neg")
    check("_slice_assign", [x, _f32(2, 2, name="negr")],
          {"begin": (3, None), "end": (None, 3), "step": (-2, 2)})


# ---------------------------------------------------------------------------
# 5. layers and losses
# ---------------------------------------------------------------------------

def _layer_case(name):
    x4 = _f32(2, 8, 3, 4, name=name)
    return {
        "pad": ([x4], {"mode": "reflect",
                       "pad_width": (0, 0, 0, 0, 1, 2, 2, 1)}),
        "Pad": ([x4], {"mode": "constant",
                       "pad_width": (0, 0, 0, 0, 1, 0, 0, 2),
                       "constant_value": 1.5}),
        "L2Normalization": ([x4], {"mode": "channel"}),
        "smooth_l1": ([x4 * 2], {"scalar": 1.5}),
        "depth_to_space": ([x4], {"block_size": 2}),
        "space_to_depth": ([_f32(2, 2, 4, 6, name=name)],
                           {"block_size": 2}),
        "IdentityAttachKLSparseReg": ([x4], {}),
    }[name]


LAYERS = ["pad", "Pad", "L2Normalization", "smooth_l1", "depth_to_space",
          "space_to_depth", "IdentityAttachKLSparseReg"]


@pytest.mark.parametrize("name", LAYERS)
def test_layers_and_losses(name):
    inputs, attrs = _layer_case(name)
    check(name, inputs, attrs)


@pytest.mark.parametrize("mode", ["edge", "instance", "spatial"])
def test_pad_edge_and_l2_modes(mode):
    x = _f32(2, 3, 4, 5, name=mode)
    if mode == "edge":
        check("pad", [x], {"mode": "edge",
                           "pad_width": (0, 0, 1, 1, 0, 2, 1, 0)})
    else:
        check("L2Normalization", [x], {"mode": mode})


# ---------------------------------------------------------------------------
# 6. linear algebra
# ---------------------------------------------------------------------------

def _spd(n, name):
    a = _f32(2, n, n, name=name)
    return (a @ a.transpose(0, 2, 1) + n * np.eye(n, dtype=np.float32))


def _lower(n, name):
    return np.linalg.cholesky(_spd(n, name)).astype(np.float32)


def _syevd_recon(want, got, inputs):
    u, lam = got
    a = inputs[0]
    np.testing.assert_allclose(lam, want[1], rtol=1e-5, atol=1e-5)
    recon = np.einsum("bki,bk,bkj->bij", u, lam, u)
    np.testing.assert_allclose(recon, a, rtol=1e-5, atol=1e-5)


def _gelqf_recon(want, got, inputs):
    q, lo = got
    np.testing.assert_allclose(lo @ q, inputs[0], rtol=1e-5, atol=1e-5)
    np.testing.assert_allclose(q @ q.transpose(0, 2, 1),
                               np.broadcast_to(np.eye(q.shape[1]),
                                               (q.shape[0],) + (q.shape[1],) * 2),
                               atol=1e-5)
    # L's diagonal positive: then the factors are unique
    np.testing.assert_allclose(lo, want[1], rtol=1e-4, atol=1e-5)


def _linalg_case(name):
    a, b = _f32(2, 3, 4, name=name), _f32(2, 4, 5, name=name + "b")
    low = _lower(3, name)
    rhs = _f32(2, 3, 4, name=name + "r")
    return {
        "batch_dot": ([a, _f32(2, 5, 4, name="bt")],
                      {"transpose_b": True}, None),
        "khatri_rao": ([_f32(3, 2, name="k1"), _f32(4, 2, name="k2")],
                       {}, None),
        "linalg_gemm": ([a, b, _f32(2, 3, 5, name="c")],
                        {"alpha": 0.5, "beta": 2.0}, None),
        "linalg_gemm2": ([a, _f32(2, 3, 5, name="g2")],
                         {"transpose_a": True, "alpha": 1.5}, None),
        "linalg_potrf": ([_spd(3, name)], {}, None),
        "linalg_potri": ([low], {}, None),
        "linalg_trsm": ([low, rhs], {"transpose": True, "alpha": 2.0},
                        None),
        "linalg_trmm": ([low, _f32(2, 4, 3, name="tm")],
                        {"rightside": True, "lower": False}, None),
        "linalg_syrk": ([a], {"transpose": True, "alpha": 0.5}, None),
        "linalg_syevd": ([_spd(3, name)], {}, _syevd_recon),
        "linalg_gelqf": ([a], {}, _gelqf_recon),
        "linalg_sumlogdiag": ([_spd(3, name)], {}, None),
        "linalg_extractdiag": ([a], {"offset": 1}, None),
        "linalg_makediag": ([_f32(2, 3, name=name)], {"offset": -1}, None),
    }[name]


LINALG = ["batch_dot", "khatri_rao", "linalg_gemm", "linalg_gemm2",
          "linalg_potrf", "linalg_potri", "linalg_trsm", "linalg_trmm",
          "linalg_syrk", "linalg_syevd", "linalg_gelqf",
          "linalg_sumlogdiag", "linalg_extractdiag", "linalg_makediag"]


@pytest.mark.parametrize("name", LINALG)
def test_linalg(name):
    inputs, attrs, compare = _linalg_case(name)
    # the decompositions' gradients depend on the factors' free signs and
    # on which triangle a solver reads: compared through reconstructions
    # (values) only
    grad = compare is None and name not in ("linalg_potrf", "linalg_potri")
    check(name, inputs, attrs, grad=grad,
          tol=dict(rtol=1e-5, atol=1e-5), compare=compare)


def test_batch_dot_bfloat16_is_float32():
    a = jnp.asarray(_f32(2, 3, 4, name="h")).astype(jnp.bfloat16)
    b = jnp.asarray(_f32(2, 4, 2, name="hb")).astype(jnp.bfloat16)
    want = JREG["batch_dot"].fn(a, b)
    got = TREG["batch_dot"].fn(
        torch.from_numpy(np.asarray(a.astype(jnp.float32))).bfloat16(),
        torch.from_numpy(np.asarray(b.astype(jnp.float32))).bfloat16())
    _close(got, want, dict(rtol=1e-6, atol=1e-6))


# ---------------------------------------------------------------------------
# 7. ops/nn.py
# ---------------------------------------------------------------------------

def _nn_case(name):
    x = _f32(2, 4, 5, 6, name=name)
    return {
        "Deconvolution": ([x, _f32(4, 3, 3, 3, name="dw"),
                           _f32(6, name="db")],
                          {"kernel": (3, 3), "stride": (2, 2),
                           "pad": (1, 1), "adj": (1, 0), "num_filter": 6,
                           "num_group": 2}),
        "LRN": ([x], {"nsize": 3, "alpha": 0.01}),
        "UpSampling": ([x], {"scale": 2, "sample_type": "bilinear"}),
        "softmin": ([x], {"axis": 1}),
        "softmax_cross_entropy": ([_f32(3, 5, name=name),
                                   np.array([1, 4, 0], np.float32)], {}),
        "_contrib_AdaptiveAvgPooling2D": ([x], {"output_size": (5, 3)}),
        "_contrib_BilinearResize2D": ([x], {"height": 3, "width": 9}),
        "BatchNorm_v1": ([x, _f32(4, name="g"), _f32(4, name="b"),
                          np.zeros(4, np.float32), np.ones(4, np.float32)],
                         {"fix_gamma": False, "output_mean_var": True}),
        "Convolution_v1": ([x, _f32(3, 4, 2, 3, name="cw"),
                            _f32(3, name="cb")],
                           {"kernel": (2, 3), "num_filter": 3,
                            "pad": (1, 0)}),
        "Pooling_v1": ([x], {"kernel": (3, 2), "stride": (2, 2),
                             "pool_type": "avg",
                             "pooling_convention": "full"}),
    }[name]


NN = ["Deconvolution", "LRN", "UpSampling", "softmin",
      "softmax_cross_entropy", "_contrib_AdaptiveAvgPooling2D",
      "_contrib_BilinearResize2D", "BatchNorm_v1", "Convolution_v1",
      "Pooling_v1"]


@pytest.mark.parametrize("name", NN)
def test_nn(name):
    inputs, attrs = _nn_case(name)
    check(name, inputs, attrs)


NN_EXTRA = {
    "conv1d": ("Convolution", [(2, 3, 7), (4, 3, 3), (4,)],
               {"kernel": (3,), "stride": (2,), "pad": (1,),
                "num_filter": 4}),
    "conv3d": ("Convolution", [(1, 2, 4, 5, 3), (3, 2, 2, 3, 2), (3,)],
               {"kernel": (2, 3, 2), "num_filter": 3, "dilate": (1, 1, 2)}),
    "conv1d_nwc": ("Convolution", [(2, 7, 3), (4, 3, 3)],
                   {"kernel": (3,), "num_filter": 4, "no_bias": True,
                    "layout": "NWC"}),
    "conv3d_ndhwc": ("Convolution", [(1, 4, 5, 3, 2), (3, 2, 3, 2, 2)],
                     {"kernel": (2, 3, 2), "num_filter": 3, "no_bias": True,
                      "layout": "NDHWC"}),
    "deconv1d": ("Deconvolution", [(2, 4, 5), (4, 3, 4)],
                 {"kernel": (4,), "stride": (2,), "num_filter": 3,
                  "no_bias": True}),
    "deconv3d": ("Deconvolution", [(1, 2, 3, 4, 3), (2, 3, 2, 2, 3)],
                 {"kernel": (2, 2, 3), "stride": (2, 1, 2), "adj": (1, 0, 1),
                  "num_filter": 3, "no_bias": True}),
    "pool1d_max": ("Pooling", [(2, 3, 9)],
                   {"kernel": (3,), "stride": (2,), "pad": (2,)}),
    "pool3d_avg": ("Pooling", [(1, 2, 5, 4, 6)],
                   {"kernel": (2, 2, 3), "stride": (2, 1, 2),
                    "pool_type": "avg", "pad": (1, 0, 1),
                    "count_include_pad": False}),
    "pool2d_sum": ("Pooling", [(2, 3, 6, 5)],
                   {"kernel": (2, 3), "stride": (2, 1), "pool_type": "sum",
                    "pooling_convention": "full"}),
    "pool2d_same": ("Pooling", [(2, 3, 6, 5)],
                    {"kernel": (3, 3), "stride": (2, 2),
                     "pooling_convention": "same"}),
    "pool3d_global": ("Pooling", [(2, 3, 3, 4, 2)],
                      {"global_pool": True, "pool_type": "avg"}),
    "pool1d_nwc": ("Pooling", [(2, 8, 3)],
                   {"kernel": (2,), "stride": (2,), "layout": "NWC"}),
    "pool_default_kernel": ("Pooling", [(3, 4)], {}),
}


@pytest.mark.parametrize("case", sorted(NN_EXTRA))
def test_conv_pool_dims(case):
    """1-D and 3-D convolution and pooling, channels-last layouts, the
    sum pool and the "same" convention (read as "valid"), as the
    reference computes them."""
    name, shapes, attrs = NN_EXTRA[case]
    check(name, [_f32(*s, name=case + str(i)) for i, s in enumerate(shapes)],
          attrs)


def test_deconvolution_target_shape():
    """``target_shape`` sets pad and adj as MXNet's InferPad: the same as
    the reference called with those pad and adj.  The reference ignores
    the attribute, a known difference (ROADMAP.md): there the same call
    gives the plain (5 - 1) * 2 + 4 = 12 per side."""
    x, w = _f32(1, 2, 5, 5, name="ts"), _f32(2, 3, 4, 4, name="tw")
    got = TREG["Deconvolution"].fn(
        torch.from_numpy(x), torch.from_numpy(w), kernel=(4, 4),
        stride=(2, 2), num_filter=3, no_bias=True, target_shape=(11, 10))
    want = JREG["Deconvolution"].fn(
        jnp.asarray(x), jnp.asarray(w), kernel=(4, 4), stride=(2, 2),
        num_filter=3, no_bias=True, pad=(1, 1), adj=(1, 0))
    assert tuple(got.shape) == (1, 3, 11, 10)
    _close(got, want, TOL)
    ignored = JREG["Deconvolution"].fn(
        jnp.asarray(x), jnp.asarray(w), kernel=(4, 4), stride=(2, 2),
        num_filter=3, no_bias=True, target_shape=(11, 10))
    assert tuple(ignored.shape) == (1, 3, 12, 12)


# ---------------------------------------------------------------------------
# 8. Crop and SVMOutput
# ---------------------------------------------------------------------------

SPATIAL = {
    "Crop": ([(2, 3, 9, 8), (2, 1, 5, 4)], {"offset": (2, 3)}),
    "SVMOutput": ([(4, 5)], {"margin": 0.5, "regularization_coefficient":
                             2.0, "use_linear": False}),
}


@pytest.mark.parametrize("name", sorted(SPATIAL))
def test_spatial(name):
    shapes, attrs = SPATIAL[name]
    inputs = [_f32(*s, name=name + str(i)) for i, s in enumerate(shapes)]
    if name == "SVMOutput":
        inputs.append(np.array([0, 3, 4, 1], np.float32))
    check(name, inputs, attrs)


@pytest.mark.parametrize("case", ["crop_center", "crop_hw", "svm_l1"])
def test_spatial_options(case):
    x = _f32(2, 3, 9, 8, name=case)
    if case == "crop_center":
        check("Crop", [x, _f32(2, 1, 4, 5, name="l")],
              {"center_crop": True, "num_args": 2})
    elif case == "crop_hw":
        check("Crop", [x], {"h_w": (5, 3), "offset": (1, 4)})
    else:
        check("SVMOutput", [_f32(3, 4, name=case),
                            np.array([1, 0, 3], np.float32)],
              {"use_linear": True, "margin": 0.3})


# ---------------------------------------------------------------------------
# 9. update rules as ops
# ---------------------------------------------------------------------------

def _pos(*shape, name):
    return _f32(*shape, name=name, lo=0.1, hi=1.0)


UPDATES = {
    "sgd_update": (["w", "g"], {"lr": 0.1, "wd": 0.01, "clip_gradient": 0.5}),
    "sgd_mom_update": (["w", "g", "m"], {"lr": 0.1, "momentum": 0.9,
                                         "wd": 0.01}),
    "mp_sgd_update": (["w", "g", "w"], {"lr": 0.1, "rescale_grad": 0.5}),
    "mp_sgd_mom_update": (["w", "g", "m", "w"], {"lr": 0.1,
                                                 "momentum": 0.9}),
    "adam_update": (["w", "g", "m", "p"], {"lr": 0.01, "wd": 0.1}),
    "ftrl_update": (["w", "g", "m", "p"], {"lr": 0.1, "lamda1": 0.05}),
    "ftml_update": (["w", "g", "p", "p", "m"], {"lr": 0.01, "t": 2}),
    "rmsprop_update": (["w", "g", "p"], {"lr": 0.01, "clip_weights": 0.8}),
    "rmspropalex_update": (["w", "g", "p", "m", "m"], {"lr": 0.01}),
    "signsgd_update": (["w", "g"], {"lr": 0.1, "wd": 0.1}),
    "signum_update": (["w", "g", "m"], {"lr": 0.1, "momentum": 0.9,
                                        "wd_lh": 0.01}),
    "_sparse_adagrad_update": (["w", "g", "p"], {"lr": 0.1}),
}


@pytest.mark.parametrize("name", sorted(UPDATES))
def test_update_ops(name):
    """New weight and states; the port's op leaves its inputs unchanged,
    as the reference's pure function does."""
    kinds, attrs = UPDATES[name]
    inputs = []
    for i, k in enumerate(kinds):
        if k == "p":
            inputs.append(_pos(3, 4, name=name + str(i)))
        elif k == "m":
            inputs.append(_f32(3, 4, name=name + str(i)) * 0.1)
        else:
            inputs.append(_f32(3, 4, name=name + k + str(i)))
    before = [a.copy() for a in inputs]
    check(name, inputs, attrs)
    tins = [torch.from_numpy(a) for a in inputs]
    TREG[name].fn(*tins, **attrs)
    for a, b in zip(tins, before):
        np.testing.assert_array_equal(a.numpy(), b)


# ---------------------------------------------------------------------------
# 10. sampling ops: bit for bit from the same key
# ---------------------------------------------------------------------------

SAMPLING = {
    "_sampling_greedy": {}, "sample_greedy": {},
    "_sampling_temperature": {"temperature": 0.7},
    "sample_temperature": {"temperature": 1.3},
    "_sampling_top_k": {"k": 5, "temperature": 0.9},
    "sample_top_k": {"k": 0},
    "_sampling_top_p": {"p": 0.6, "temperature": 1.1},
    "sample_top_p": {"p": 0.95},
}


@pytest.mark.parametrize("name", sorted(SAMPLING))
def test_sampling_ops(name):
    logits = _f32(8, 50, name=name) * 2.0
    attrs = dict(SAMPLING[name])
    jop, top = JREG[name], TREG[name]
    assert top.rng == jop.rng and not top.differentiable
    for seed in range(3):
        kw_j, kw_t = dict(attrs), dict(attrs)
        if jop.rng:
            key = jax.random.PRNGKey(seed)
            kw_j["rng_key"] = key
            kw_t["rng_key"] = torch.tensor([int(v) for v in np.asarray(key)],
                                           dtype=torch.int64)
        want = np.asarray(jop.fn(jnp.asarray(logits), **kw_j))
        got = top.fn(torch.from_numpy(logits), **kw_t).numpy()
        assert got.dtype == want.dtype == np.int32
        np.testing.assert_array_equal(got, want)


# ---------------------------------------------------------------------------
# 11. flash attention through the op registry (kernels 6-8 on the card)
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("name,causal", [("_contrib_flash_attention", True),
                                         ("flash_attention", False)])
def test_flash_attention_op(name, causal, monkeypatch):
    monkeypatch.setenv("TPUMX_PALLAS", "1")
    q, k, v = (_f32(1, 16, 2, 16, name=name + s) for s in "qkv")
    check(name, [q, k, v], {"causal": causal, "scale": 0.3},
          tol=dict(rtol=1e-4, atol=5e-5))


def test_flash_attention_nd_op_on_port():
    """``nd.flash_attention`` runs through ``invoke`` (the wrapper routes
    CPU tensors to the plain versions) and records a gradient."""
    q, k, v = (tmx.nd.array(_f32(1, 8, 2, 8, name=s)) for s in "qkv")
    for a in (q, k, v):
        a.attach_grad()
    with tmx.autograd.record():
        out = tmx.nd.flash_attention(q, k, v, causal=True)
    out.backward()
    assert out.shape == (1, 8, 2, 8)
    assert np.isfinite(q.grad.asnumpy()).all()


# ---------------------------------------------------------------------------
# the registry's coverage
# ---------------------------------------------------------------------------

# the family ROADMAP.md Queue 1 still lists (the _sample_* samplers)
_NOT_IN_SLICE = ("_sample_", "sample_")


def test_registry_coverage():
    missing = sorted(set(JREG) - set(TREG))
    assert len(set(JREG) & set(TREG)) >= 379, len(set(JREG) & set(TREG))
    assert len(missing) <= 14, missing
    stray = [n for n in missing if not n.startswith(_NOT_IN_SLICE)
             and n not in _NOT_IN_SLICE]
    assert not stray, stray
    # every name this file tests is registered under the reference's name
    tested = (ELEMWISE + GRAD_SUM + sorted(ORDERING) + INDEXING + LAYERS
              + LINALG + NN + sorted(SPATIAL) + sorted(UPDATES)
              + sorted(SAMPLING) + ["_contrib_flash_attention",
                                    "flash_attention"])
    assert all(TREG[n].name == JREG[n].name for n in tested)
