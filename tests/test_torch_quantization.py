"""PyTorch port: int8 quantization (``ops/quantization_ops.py``,
``quantization/``, ``contrib.quantization``, ``InferenceService(
quantize="int8")``) against the JAX package's.

- The twelve quantization ops on the same numpy inputs: int8, uint8 and
  int32 outputs (the ``_contrib_*`` accumulators) bit for bit, f32
  outputs within rtol 1e-5 (the ``_tpumx_*`` matmul and convolution:
  rtol 1e-5 with atol 1e-5 x max|ref|, the reference summing in f32 in
  its own order), with and without bias, strided, padded, dilated,
  grouped and channels-last convolutions, ``uint8``.
- ``CalibrationTable``: statistics against the reference's calibration
  (rtol 1e-5), files saved by either package load in the other with the
  same scales; a truncated, edited or missing file raises naming it.
- ``convert_symbol``'s graph JSON byte for byte the reference's, the
  shared quantize node, conversion from ``param_shapes`` alone;
  ``quantize_weights`` bit for bit; ``load_json`` of a converted graph.
- ``contrib.quantization``: ``quantize_graph``'s JSON the reference's and
  its executor's outputs, ``quantize_model`` with naive calibration.
- ``InferenceService(ServingConfig(quantize="int8",
  quantize_calibration=table))`` against the reference's int8 service on
  the same table (rtol 1e-5), int8 weights on the device,
  ``refresh_params``; the ``TPUMX_QUANT`` grammar; ``TPUMX_QUANT=0``
  leaves keys and outputs as unset; quantized binds key apart.
"""
import json

import jax.numpy as jnp
import numpy as np
import pytest
import torch

import mxnet_tpu as jmx
import mxnet_tpu_torch as tmx
from mxnet_tpu import quantization as jq
from mxnet_tpu.contrib import quantization as jcq
from mxnet_tpu.ops import quantization_ops as jops
from mxnet_tpu_torch import quantization as tq
from mxnet_tpu_torch.base import MXNetError
from mxnet_tpu_torch.contrib import quantization as tcq
from mxnet_tpu_torch.ops import quantization_ops as tops

F32_TOL = dict(rtol=1e-5, atol=1e-6)


@pytest.fixture(autouse=True)
def _cpu():
    with tmx.cpu():
        yield
    jmx.observability.recompile.reset()
    tmx.observability.recompile.reset()


# ---------------------------------------------------------------------------
# the ops
# ---------------------------------------------------------------------------

def _i8(rs, *shape):
    return rs.randint(-127, 128, shape).astype(np.int8)


def _rng(*vals):
    return [np.array([v], np.float32) for v in vals]


_RANGES = _rng(-1.3, 1.2, -0.4, 0.5, -0.2, 0.3)
_CONV = dict(kernel=(3, 3), stride=(2, 1), pad=(1, 2), dilate=(1, 2),
             num_filter=8, num_group=2)


def _op_cases():
    rs = np.random.RandomState(0)
    x = rs.randn(4, 3, 9, 9).astype(np.float32)
    qd, qw, qb = _i8(rs, 2, 6, 9, 9), _i8(rs, 8, 3, 3, 3), _i8(rs, 8)
    qdl, qwl = _i8(rs, 2, 9, 9, 6), _i8(rs, 8, 3, 3, 3)
    fx, fw, fb = _i8(rs, 5, 3, 4), _i8(rs, 7, 12), _i8(rs, 7)
    acc = rs.randint(-2 ** 20, 2 ** 20, (6, 7)).astype(np.int32)
    ws = (rs.rand(8) * 0.01 + 1e-3).astype(np.float32)
    ws7 = (rs.rand(7) * 0.01 + 1e-3).astype(np.float32)
    act = np.array([0.02], np.float32)
    bias8 = rs.randn(8).astype(np.float32)
    r = _RANGES
    u8 = rs.randint(0, 256, (3, 5)).astype(np.uint8)
    return {
        "quantize_int8": ("quantize", (x, r[0], r[1]), {}),
        "quantize_uint8": ("quantize", (x, r[0], r[1]),
                           {"out_type": "uint8"}),
        "quantize_v2_calib": ("quantize_v2", (x,),
                              {"min_calib_range": -2.5,
                               "max_calib_range": 2.1}),
        "quantize_v2_auto": ("quantize_v2", (x,), {}),
        "dequantize_int8": ("dequantize", (qd, r[0], r[1]), {}),
        "dequantize_uint8": ("dequantize", (u8, r[0], r[1]), {}),
        "dequantize_int32": ("dequantize", (acc, r[0], r[1]), {}),
        "requantize": ("requantize", (acc, r[0], r[1]), {}),
        "requantize_calib": ("requantize", (acc, r[0], r[1]),
                             {"min_calib_range": -3.0,
                              "max_calib_range": 2.0}),
        "quantized_fc": ("quantized_fully_connected", (fx, fw, fb, *r),
                         {"num_hidden": 7}),
        "quantized_fc_no_bias": ("quantized_fully_connected",
                                 (fx, fw, *r[:4]),
                                 {"num_hidden": 7, "no_bias": True}),
        "quantized_fc_no_flatten": ("quantized_fully_connected",
                                    (fx[:, :, :3].copy(), fw[:, :3].copy(),
                                     fb, *r),
                                    {"num_hidden": 7, "flatten": False}),
        "quantized_conv": ("quantized_conv", (qd, qw, qb, *r), _CONV),
        "quantized_conv_no_bias": ("quantized_conv", (qd, qw, *r[:4]),
                                   dict(_CONV, no_bias=True)),
        "quantized_conv_nhwc": ("quantized_conv", (qdl, qwl, *r[:4]),
                                dict(_CONV, no_bias=True, layout="NHWC")),
        "quantized_conv_uint8": ("quantized_conv",
                                 (qd.view(np.uint8), qw, qb, *r), _CONV),
        "quantized_pooling_max": ("quantized_pooling", (qd, r[0], r[1]),
                                  {"kernel": (3, 3), "stride": (2, 2),
                                   "pool_type": "max"}),
        "quantized_pooling_avg": ("quantized_pooling", (qd, r[0], r[1]),
                                  {"kernel": (3, 3), "stride": (2, 2),
                                   "pad": (1, 1), "pool_type": "avg"}),
        "quantized_pooling_global": ("quantized_pooling", (qd, r[0], r[1]),
                                     {"global_pool": True,
                                      "pool_type": "avg"}),
        "quantized_flatten": ("quantized_flatten", (qd, r[0], r[1]), {}),
        "tpumx_quantize_static": ("tpumx_quantize_int8", (x,),
                                  {"scale": 0.013}),
        "tpumx_quantize_dynamic": ("tpumx_quantize_int8", (x,), {}),
        "tpumx_dequantize_tensor": ("tpumx_dequantize_int8", (qd, act), {}),
        "tpumx_dequantize_channel": ("tpumx_dequantize_int8",
                                     (qd, ws[:6].copy()), {"axis": 1}),
        "tpumx_fc": ("tpumx_quantized_fc_int8", (fx, act, fw, ws7,
                                                 bias8[:7].copy()),
                     {"num_hidden": 7}),
        "tpumx_fc_no_bias": ("tpumx_quantized_fc_int8",
                             (fx, act, fw, ws7), {"num_hidden": 7,
                                                  "no_bias": True}),
        "tpumx_conv": ("tpumx_quantized_conv_int8",
                       (qd, act, qw, ws, bias8), _CONV),
        "tpumx_conv_nhwc": ("tpumx_quantized_conv_int8",
                            (qdl, act, qwl, ws, bias8),
                            dict(_CONV, layout="NHWC")),
    }


OP_CASES = _op_cases()


def _same(got, ref, name):
    got = got.numpy()
    ref = np.asarray(ref)
    assert got.shape == ref.shape, name
    assert got.dtype == ref.dtype, (name, got.dtype, ref.dtype)
    if got.dtype == np.float32:
        if name.startswith(("tpumx_fc", "tpumx_conv")):
            np.testing.assert_allclose(
                got, ref, rtol=1e-5, atol=1e-5 * np.abs(ref).max(),
                err_msg=name)
        else:
            np.testing.assert_allclose(got, ref, err_msg=name, **F32_TOL)
    else:
        np.testing.assert_array_equal(got, ref, err_msg=name)


@pytest.mark.parametrize("case", sorted(OP_CASES))
def test_quantization_op_matches_jax(case):
    fn, args, kw = OP_CASES[case]
    ref = getattr(jops, fn)(*[jnp.asarray(a) for a in args], **kw)
    got = getattr(tops, fn)(*[torch.from_numpy(np.ascontiguousarray(a))
                              for a in args], **kw)
    refs = ref if isinstance(ref, tuple) else (ref,)
    gots = got if isinstance(got, tuple) else (got,)
    assert len(refs) == len(gots)
    for i, (g, r) in enumerate(zip(gots, refs)):
        _same(g, r, f"{case}[{i}]")


def test_registry_names_and_int_route():
    """The twelve names are the reference's, not differentiable; the
    integer GEMM's two routes (int8: ``torch._int_mm`` with padding to its
    shape rules; any other integer dtype: float64) give the same exact
    sums as a Python-integer oracle at shapes off the rules."""
    names = [n for n in jmx.ops.registry.OP_REGISTRY
             if n.startswith(("_contrib_quantize", "_contrib_dequantize",
                              "_contrib_requantize", "_contrib_quantized_",
                              "_tpumx_"))]
    assert len(names) == 12
    for n in names:
        op = tmx.ops.registry.get_op(n)
        assert op.name == n and not op.differentiable
    rs = np.random.RandomState(3)
    for m, k, n in ((1, 3, 5), (16, 147, 64), (17, 8, 8), (40, 2048, 1000)):
        a, w = _i8(rs, m, k), _i8(rs, n, k)
        want = a.astype(np.int64) @ w.astype(np.int64).T
        got8 = tops.int8_matmul(torch.from_numpy(a), torch.from_numpy(w))
        got64 = tops.int8_matmul(torch.from_numpy(a).to(torch.int16),
                                 torch.from_numpy(w))
        assert got8.dtype == got64.dtype == torch.int32
        np.testing.assert_array_equal(got8.numpy(), want)
        np.testing.assert_array_equal(got64.numpy(), want)


# ---------------------------------------------------------------------------
# symbols, calibration, conversion
# ---------------------------------------------------------------------------

def _mlp_sym(mx, nh=16, classes=4):
    with mx.name.NameManager():
        data = mx.sym.Variable("data")
        h = mx.sym.Activation(mx.sym.FullyConnected(data, num_hidden=nh,
                                                    name="fc1"),
                              act_type="relu")
        return mx.sym.FullyConnected(h, num_hidden=classes, name="fc2")


def _mlp_params(seed=0, nh=16, classes=4, dim=8):
    rs = np.random.RandomState(seed)
    return {"fc1_weight": rs.randn(nh, dim).astype(np.float32) * 0.3,
            "fc1_bias": rs.randn(nh).astype(np.float32) * 0.1,
            "fc2_weight": rs.randn(classes, nh).astype(np.float32) * 0.3,
            "fc2_bias": np.zeros(classes, np.float32)}


def _conv_sym(mx):
    with mx.name.NameManager():
        data = mx.sym.Variable("data")
        c1 = mx.sym.Convolution(data, kernel=(3, 3), num_filter=6,
                                pad=(1, 1), name="c1")
        a1 = mx.sym.Activation(c1, act_type="relu")
        p1 = mx.sym.Pooling(a1, kernel=(2, 2), stride=(2, 2),
                            pool_type="max")
        c2 = mx.sym.Convolution(p1, kernel=(3, 3), num_filter=8,
                                no_bias=True, name="c2")
        f = mx.sym.Flatten(mx.sym.Activation(c2, act_type="relu"))
        return mx.sym.FullyConnected(f, num_hidden=5, name="fc")


def _conv_params(seed=1):
    rs = np.random.RandomState(seed)
    return {"c1_weight": rs.randn(6, 3, 3, 3).astype(np.float32) * 0.3,
            "c1_bias": rs.randn(6).astype(np.float32) * 0.1,
            "c2_weight": rs.randn(8, 6, 3, 3).astype(np.float32) * 0.2,
            "fc_weight": rs.randn(5, 32).astype(np.float32) * 0.2,
            "fc_bias": rs.randn(5).astype(np.float32) * 0.1}


def _calib_iter(mx, X, batch):
    return mx.io.NDArrayIter(X, None, batch_size=batch)


def _nd_params(mx, params):
    return {k: mx.nd.array(v) for k, v in params.items()}


def _tables(kind="mlp", entropy=False):
    rs = np.random.RandomState(4)
    if kind == "mlp":
        X = rs.rand(32, 8).astype(np.float32)
        sym, params, batch = _mlp_sym, _mlp_params(), 8
    else:
        X = rs.randn(8, 3, 8, 8).astype(np.float32)
        sym, params, batch = _conv_sym, _conv_params(), 4
    out = {}
    for mx, q in ((jmx, jq), (tmx, tq)):
        out[mx] = q.calibrate(sym(mx), _nd_params(mx, params),
                              _calib_iter(mx, X, batch), entropy=entropy)
    return out[jmx], out[tmx], params


@pytest.mark.parametrize("kind", ["mlp", "conv"])
def test_calibrate_matches_jax(kind):
    jt, tt, params = _tables(kind, entropy=(kind == "mlp"))
    assert set(tt.activations) == set(jt.activations)
    assert tt.weights == jt.weights
    for name, ent in jt.activations.items():
        got = tt.activations[name]
        assert got["samples"] == ent["samples"]
        for k in ("min", "max", "absmax", "percentile", "entropy"):
            if k in ent:
                np.testing.assert_allclose(got[k], ent[k], rtol=1e-5,
                                           err_msg=f"{name}.{k}")
    for name in jt.weights:
        np.testing.assert_array_equal(tt.weight_scales(name),
                                      jt.weight_scales(name))


def test_calibration_table_files_interchange(tmp_path):
    """A table saved by either package loads in the other with the same
    activation scales and weight scales; the converted graphs agree."""
    jt, tt, _ = _tables("mlp")
    for src, dst, tag in ((jt, tq, "jax"), (tt, jq, "port")):
        path = str(tmp_path / f"{tag}.calib.json")
        src.save(path)
        loaded = dst.CalibrationTable.load(path)
        assert loaded.method == src.method
        for name in src.activations:
            for m in ("naive", "percentile"):
                assert loaded.act_scale(name, m) == src.act_scale(name, m)
        for name in src.weights:
            np.testing.assert_array_equal(loaded.weight_scales(name),
                                          src.weight_scales(name))
    # the files are the same bytes for the same table
    path_j, path_t = str(tmp_path / "j.json"), str(tmp_path / "t.json")
    jt.save(path_j)
    tq.CalibrationTable.load(path_j).save(path_t)
    assert open(path_j).read() == open(path_t).read()


def test_corrupt_table_raises_naming_file(tmp_path):
    _, tt, _ = _tables("mlp")
    path = str(tmp_path / "model.calib.json")
    tt.save(path)
    raw = open(path).read()
    with open(path, "w") as f:
        f.write(raw[: len(raw) // 2])
    with pytest.raises(MXNetError, match="model.calib.json"):
        tq.CalibrationTable.load(path)
    with open(path, "w") as f:
        f.write(raw.replace('"method"', '"methoX"', 1))
    with pytest.raises(MXNetError, match="model.calib.json"):
        tq.CalibrationTable.load(path)
    with pytest.raises(MXNetError, match="nope.json"):
        tq.CalibrationTable.load(str(tmp_path / "nope.json"))
    with pytest.raises(MXNetError, match="unknown method"):
        tq.CalibrationTable(method="minmax")


def _same_table(jt):
    """The reference's table as the port's, through its file."""
    doc = json.loads(json.dumps({"activations": jt.activations,
                                 "weights": jt.weights}))
    return tq.CalibrationTable(doc["activations"], doc["weights"],
                               jt.method)


@pytest.mark.parametrize("kind", ["mlp", "conv"])
def test_convert_symbol_json_bytes(kind):
    jt, _, params = _tables(kind)
    tt = _same_table(jt)
    sym = _mlp_sym if kind == "mlp" else _conv_sym
    for method in ("naive", "percentile"):
        got = tq.convert_symbol(sym(tmx), tt, method=method)
        ref = jq.convert_symbol(sym(jmx), jt, method=method)
        assert got.tojson() == ref.tojson()
        assert tq.count_quantized_nodes(got) == \
            jq.count_quantized_nodes(ref) == (2 if kind == "mlp" else 3)
        assert got.list_arguments() == ref.list_arguments()
    part = tq.convert_symbol(sym(tmx), tt, exclude=["fc2" if kind == "mlp"
                                                    else "fc"])
    assert part.tojson() == jq.convert_symbol(
        sym(jmx), jt, exclude=["fc2" if kind == "mlp" else "fc"]).tojson()
    # the converted graph's JSON loads back, and binds
    loaded = tmx.sym.load_json(got.tojson())
    assert loaded.tojson() == got.tojson()
    assert tmx.sym.load_json(ref.tojson()).tojson() == ref.tojson()


def test_convert_from_param_shapes_and_shared_quantize_node():
    from mxnet_tpu_torch.symbol.graph import topo_order

    shapes = {"fc1_weight": (16, 8), "fc2_weight": (4, 16)}
    with pytest.raises(MXNetError, match="fc1_weight"):
        tq.convert_symbol(_mlp_sym(tmx))
    got = tq.convert_symbol(_mlp_sym(tmx), param_shapes=shapes)
    assert got.tojson() == jq.convert_symbol(
        _mlp_sym(jmx), param_shapes=shapes).tojson()
    groups = {}
    for mx in (jmx, tmx):
        with mx.name.NameManager():
            data = mx.sym.Variable("data")
            a = mx.sym.FullyConnected(data, num_hidden=4, name="fa")
            b = mx.sym.FullyConnected(data, num_hidden=4, name="fb")
            groups[mx] = mx.sym.Group([a, b])
    sh = {"fa_weight": (4, 8), "fb_weight": (4, 8)}
    conv = tq.convert_symbol(groups[tmx], param_shapes=sh)
    n_q = sum(1 for n in topo_order(conv._entries)
              if n.kind == "op" and n.op.name == "_tpumx_quantize_int8")
    assert n_q == 1
    assert conv.tojson() == jq.convert_symbol(groups[jmx],
                                              param_shapes=sh).tojson()
    # the shape solver reads the int8 twins' rules
    args, outs, _ = conv.infer_shape(data=(2, 8))
    assert dict(zip(conv.list_arguments(), args))["fa_weight_int8"] == (4, 8)
    assert outs == [(2, 4), (2, 4)]


@pytest.mark.parametrize("kind", ["mlp", "conv"])
def test_quantize_weights_and_converted_forward(kind):
    """``quantize_weights`` bit for bit (int8 values, f32 scales); the
    converted graph bound on the CPU against the reference's executor
    (rtol 1e-5), and near the float graph (int8 rounding moved it, by
    less than a tenth of its largest output)."""
    jt, _, params = _tables(kind)
    tt = _same_table(jt)
    sym = _mlp_sym if kind == "mlp" else _conv_sym
    jq_args = jq.quantize_weights(sym(jmx), params, table=jt)
    tq_args = tq.quantize_weights(sym(tmx), params, table=tt)
    assert sorted(jq_args) == sorted(tq_args)
    for k in jq_args:
        a, b = np.asarray(jq_args[k]), np.asarray(tq_args[k])
        assert a.dtype == b.dtype
        np.testing.assert_array_equal(b, a)
    X = np.random.RandomState(9).rand(*(
        (4, 8) if kind == "mlp" else (4, 3, 8, 8))).astype(np.float32)
    outs = {}
    for mx, q, table, qargs in ((jmx, jq, jt, jq_args),
                                (tmx, tq, tt, tq_args)):
        conv = q.convert_symbol(sym(mx), table)
        binds = {k: mx.nd.array(v) for k, v in qargs.items()}
        binds["data"] = mx.nd.array(X)
        ex = conv.bind(ctx=mx.cpu(), args=binds, args_grad=None,
                       grad_req="null")
        outs[mx] = ex.forward(is_train=False)[0].asnumpy()
        if mx is tmx:
            w = ex.arg_dict[[k for k in qargs if k.endswith("_int8")][0]]
            assert w._data.dtype == torch.int8
            fb = _nd_params(mx, params)
            fb["data"] = mx.nd.array(X)
            flt = sym(mx).bind(ctx=mx.cpu(), args=fb, args_grad=None,
                               grad_req="null").forward(
                                   is_train=False)[0].asnumpy()
    np.testing.assert_allclose(outs[tmx], outs[jmx], rtol=1e-5,
                               atol=1e-5 * np.abs(outs[jmx]).max())
    err = np.abs(outs[tmx] - flt).max()
    assert 0 < err <= 0.1 * np.abs(flt).max()


# ---------------------------------------------------------------------------
# contrib.quantization
# ---------------------------------------------------------------------------

def test_contrib_quantize_graph_and_params():
    params = _conv_params()
    thresholds = {"c1": 2.5, "fc": 4.0}
    shapes = {k: v.shape for k, v in params.items()}
    got = tcq.quantize_graph(_conv_sym(tmx), calib_thresholds=thresholds,
                             param_shapes=shapes, excluded_sym_names=["c2"])
    ref = jcq.quantize_graph(_conv_sym(jmx), calib_thresholds=thresholds,
                             param_shapes=shapes, excluded_sym_names=["c2"])
    assert got.tojson() == ref.tojson()
    X = np.random.RandomState(5).randn(4, 3, 8, 8).astype(np.float32)
    outs = {}
    for mx, qsym in ((jmx, ref), (tmx, got)):
        binds = _nd_params(mx, params)
        binds["data"] = mx.nd.array(X)
        outs[mx] = qsym.bind(ctx=mx.cpu(), args=binds, args_grad=None,
                             grad_req="null").forward(
                                 is_train=False)[0].asnumpy()
    np.testing.assert_allclose(outs[tmx], outs[jmx], rtol=1e-5,
                               atol=1e-5 * np.abs(outs[jmx]).max())
    qp_j = jcq.quantize_params(params, exclude=["c2_weight"])
    qp_t = tcq.quantize_params(params, exclude=["c2_weight"])
    for k in qp_j:
        if isinstance(qp_j[k], jcq.QuantizedParam):
            assert isinstance(qp_t[k], tcq.QuantizedParam)
            np.testing.assert_array_equal(qp_t[k].data, qp_j[k].data)
            assert qp_t[k].scale == qp_j[k].scale
            np.testing.assert_array_equal(qp_t[k].dequantize(),
                                          qp_j[k].dequantize())
        else:
            np.testing.assert_array_equal(qp_t[k], qp_j[k])


@pytest.mark.parametrize("mode", ["naive", "entropy"])
def test_contrib_quantize_model(mode):
    params = _conv_params()
    X = np.random.RandomState(6).randn(8, 3, 8, 8).astype(np.float32)
    res = {}
    for mx, cq in ((jmx, jcq), (tmx, tcq)):
        qsym, qargs, _ = cq.quantize_model(
            _conv_sym(mx), _nd_params(mx, params), {}, calib_mode=mode,
            calib_data=_calib_iter(mx, X, 4), num_calib_examples=8)
        binds = dict(qargs)
        binds["data"] = mx.nd.array(X[:4])
        out = qsym.bind(ctx=mx.cpu(), args=binds, args_grad=None,
                        grad_req="null").forward(is_train=False)[0]
        calib = {n.name: (n.attrs["min_calib_range"],
                          n.attrs["max_calib_range"])
                 for n in _nodes(qsym) if "min_calib_range" in n.attrs}
        res[mx] = (out.asnumpy(), calib)
    assert sorted(res[tmx][1]) == sorted(res[jmx][1]) == \
        ["c1_quantize", "c2_quantize", "fc_quantize"]
    for k, (lo, hi) in res[jmx][1].items():
        np.testing.assert_allclose(res[tmx][1][k], (lo, hi), rtol=1e-5)
    np.testing.assert_allclose(res[tmx][0], res[jmx][0], rtol=1e-4,
                               atol=1e-3 * np.abs(res[jmx][0]).max())


def _nodes(sym):
    from mxnet_tpu_torch.symbol.graph import topo_order as t_topo
    from mxnet_tpu.symbol.graph import topo_order as j_topo

    topo = t_topo if isinstance(sym, tmx.sym.Symbol) else j_topo
    return [n for n in topo(sym._entries) if n.kind == "op"]


# ---------------------------------------------------------------------------
# serving
# ---------------------------------------------------------------------------

def _bound_mlp(mx):
    mod = mx.mod.Module(_mlp_sym(mx), label_names=None, context=mx.cpu())
    mod.bind(data_shapes=[("data", (4, 8))], for_training=False)
    mod.init_params(arg_params=_nd_params(mx, _mlp_params()))
    return mod


def test_inference_service_int8_matches_jax(tmp_path):
    """The port's int8 service against the reference's on one table (the
    reference's file): outputs within rtol 1e-5, weights int8 on the
    device (the parameter bytes a quarter of the float graph's, biases
    aside); ``refresh_params``
    quantizes the updated float weights again (with the table's weight
    scales, as the reference does)."""
    jt, _, _ = _tables("mlp")
    path = str(tmp_path / "mlp.calib.json")
    jt.save(path)
    X = np.random.RandomState(8).rand(6, 8).astype(np.float32)
    outs = {}
    for mx in (jmx, tmx):
        mod = _bound_mlp(mx)
        svc = mx.serving.InferenceService(mod, mx.serving.ServingConfig(
            max_batch_size=4, quantize="int8", quantize_calibration=path))
        try:
            outs[mx] = np.stack([np.asarray(svc.predict(x, timeout=60)
                                            .asnumpy()) for x in X])
            if mx is tmx:
                ad = svc._adapter
                assert ad._base.arg_dict["fc1_weight_int8"]._data.dtype \
                    == torch.int8
                assert "fc1_weight" not in ad._base.arg_dict
                nb = {k: sum(a._data.numel() * a._data.element_size()
                             for n, a in ex.arg_dict.items() if n != "data")
                      for k, ex in (("served", ad._base),
                                    ("float", ad._float_base))}
                assert nb["served"] == 16 * 8 + 4 * 16 + 4 * (16 + 4) \
                    + 4 * (16 + 4)
                assert nb["float"] == 4 * (16 * 8 + 16 + 4 * 16 + 4)
                w = mod._exec.arg_dict["fc2_weight"]
                w._data.mul_(2.0)
                svc.refresh_params()
                moved = np.asarray(svc.predict(X[0], timeout=60).asnumpy())
                want = tq.quantize_weights(
                    _mlp_sym(tmx), dict(mod._exec.arg_dict),
                    table=tq.CalibrationTable.load(path))
        finally:
            svc.stop()
    np.testing.assert_allclose(outs[tmx], outs[jmx], rtol=1e-5,
                               atol=1e-5 * np.abs(outs[jmx]).max())
    assert not np.allclose(moved, outs[tmx][0])
    np.testing.assert_array_equal(
        ad._base.arg_dict["fc2_weight_int8"].asnumpy(),
        want["fc2_weight_int8"])


def test_quant_env_grammar(monkeypatch):
    for raw, want in (("int8", "int8"), ("1", "int8"), (" INT8 ", "int8"),
                      ("0", None), ("none", None), ("off", None),
                      ("false", None), ("", None)):
        monkeypatch.setenv("TPUMX_QUANT", raw)
        assert tq.active_dtype() == jq.active_dtype() == want, raw
        assert tq.enabled() == (want is not None)
        assert tmx.serving.ServingConfig().quantize == want
    monkeypatch.delenv("TPUMX_QUANT")
    assert tq.active_dtype() is None
    monkeypatch.setenv("TPUMX_QUANT", "fp4")
    with pytest.raises(MXNetError, match="TPUMX_QUANT"):
        tq.active_dtype()
    with pytest.raises(MXNetError, match="TPUMX_QUANT"):
        tmx.serving.ServingConfig()


def test_quant_off_keys_and_outputs_as_unset(monkeypatch):
    """``TPUMX_QUANT=0``: the same bucket keys (none mentions the
    quantization) and the same output bits as with the variable unset."""
    X = np.random.RandomState(7).rand(3, 8).astype(np.float32)
    runs = {}
    for env in (None, "0"):
        if env is None:
            monkeypatch.delenv("TPUMX_QUANT", raising=False)
        else:
            monkeypatch.setenv("TPUMX_QUANT", env)
        svc = tmx.serving.InferenceService(
            _bound_mlp(tmx), tmx.serving.ServingConfig(max_batch_size=4))
        try:
            outs = [svc.predict(x, timeout=60).asnumpy() for x in X]
            runs[env] = (sorted(map(repr, svc._adapter._cache)), outs)
        finally:
            svc.stop()
    assert runs[None][0] == runs["0"][0]
    assert not any("quant" in k for k in runs[None][0])
    for a, b in zip(runs[None][1], runs["0"][1]):
        np.testing.assert_array_equal(a, b)
