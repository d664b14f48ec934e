"""PyTorch port: output dtypes and values of casts, integer reductions and
``dot`` against the JAX package's.

The same numpy inputs go through both packages (the port's on the CPU);
every test asserts the dtype and the value.
- Casts from float to int8/uint8/int32 (``Cast`` and ``astype``) truncate
  toward zero and saturate at the target's range, NaN giving 0, as XLA's
  convert does.
- Integer input is 32-bit: ``nd.array`` of Python or numpy int64 data is
  int32, ``sum``/``prod`` of int32 stay int32 and ``mean`` is float32, and
  ``nd.save`` of such an array writes the reference's bytes.
- ``dot`` of bfloat16/float16 accumulates and returns float32.
- A sweep over every op name both registries share, called with default
  attributes on float32, bfloat16 and int32 inputs: wherever the
  reference computes a result the port computes one too (a refusal is
  listed by name), and its dtypes agree.
- The four cases that sweep once found the port raising on: ``Pooling``
  with its default kernel, ``Embedding`` past its table, ``_mod_scalar``
  of int32 by 0 and ``SoftmaxOutput`` of int32.
"""
import numpy as np
import pytest
import torch

import jax.numpy as jnp
import mxnet_tpu as jmx
import mxnet_tpu_torch as tmx
from mxnet_tpu.ops.registry import OP_REGISTRY as JREG
from mxnet_tpu_torch import nd as tnd
from mxnet_tpu_torch.base import dtype_name
from mxnet_tpu_torch.ops.registry import OP_REGISTRY as TREG

jnd = jmx.nd

# finite values past both ends of every target, fractions of both signs,
# NaN and the infinities
CAST_IN = np.array([-300.0, -129.0, -3.7, -0.5, 0.5, 3.7, 127.6, 200.2,
                    255.5, 256.0, 300.0, 3e9, -3e9, np.nan, np.inf,
                    -np.inf], np.float32)


@pytest.fixture(autouse=True)
def _cpu():
    with tmx.cpu():
        yield


def _same(want, got):
    """Same dtype; integer values equal, float values within 1 ulp (XLA
    divides a mean by multiplying with the reciprocal)."""
    w, g = want.asnumpy(), got.asnumpy()
    assert str(w.dtype) == str(g.dtype), (w.dtype, g.dtype)
    if w.dtype.kind == "f":
        np.testing.assert_allclose(g, w, rtol=2e-7, atol=0)
    else:
        np.testing.assert_array_equal(g, w)


@pytest.mark.parametrize("dtype", ["uint8", "int8", "int32"])
@pytest.mark.parametrize("how", ["Cast", "astype"])
def test_float_to_int_cast_saturates(dtype, how):
    ja, ta = jnd.array(CAST_IN), tnd.array(CAST_IN)
    if how == "Cast":
        want, got = jnd.Cast(ja, dtype=dtype), tnd.Cast(ta, dtype=dtype)
    else:
        want, got = ja.astype(dtype), ta.astype(dtype)
    _same(want, got)


def test_bfloat16_to_uint8_cast_saturates():
    x = np.array([-5.0, 3.5, 300.0, np.nan], np.float32)
    _same(jnd.array(x).astype("bfloat16").astype("uint8"),
          tnd.array(x).astype("bfloat16").astype("uint8"))


@pytest.mark.parametrize("source", [[1, 2], np.arange(3),
                                    np.arange(6).reshape(2, 3)],
                         ids=["list", "arange", "arange2d"])
def test_int_array_is_int32(source):
    want, got = jnd.array(source), tnd.array(source)
    assert want.dtype == np.int32
    _same(want, got)


@pytest.mark.parametrize("op", ["sum", "prod", "mean", "max", "min"])
@pytest.mark.parametrize("axis", [None, 0, 1])
def test_int32_reductions(op, axis):
    a = (np.arange(12, dtype=np.int32).reshape(3, 4) % 5) + 1
    kw = {} if axis is None else {"axis": axis}
    _same(getattr(jnd, op)(jnd.array(a), **kw),
          getattr(tnd, op)(tnd.array(a), **kw))


def test_int32_mean_of_arange():
    a = np.arange(12, dtype=np.int32)
    got = tnd.mean(tnd.array(a))
    _same(jnd.mean(jnd.array(a)), got)
    assert got.asnumpy() == np.float32(5.5)


def test_int32_sum_wraps_at_32_bits():
    a = np.full(4, 2 ** 30, np.int32)
    _same(jnd.sum(jnd.array(a)), tnd.sum(tnd.array(a)))


@pytest.mark.parametrize("fmt", ["tpmx", "mxnet"])
def test_save_int_array_bytes(tmp_path, fmt):
    jf, tf = tmp_path / "j.params", tmp_path / "t.params"
    jnd.save(str(jf), {"ids": jnd.array([1, 2])}, format=fmt)
    tnd.save(str(tf), {"ids": tnd.array([1, 2])}, format=fmt)
    assert jf.read_bytes() == tf.read_bytes()


@pytest.mark.parametrize("dtype", ["bfloat16", "float16"])
@pytest.mark.parametrize("shapes", [((3, 4), (4, 3)), ((2, 3, 4), (4, 5)),
                                    ((4,), (4,))],
                         ids=["2d", "3d", "vec"])
def test_half_dot_is_float32(dtype, shapes):
    rs = np.random.RandomState(0)
    a = rs.randn(*shapes[0]).astype(np.float32)
    b = rs.randn(*shapes[1]).astype(np.float32)
    want = jnd.dot(jnd.array(a).astype(dtype), jnd.array(b).astype(dtype))
    got = tnd.dot(tnd.array(a).astype(dtype), tnd.array(b).astype(dtype))
    assert str(want.asnumpy().dtype) == str(got.asnumpy().dtype) == "float32"
    # both products sum the same (exactly representable) half operands in
    # f32; only the summation order differs
    np.testing.assert_allclose(got.asnumpy(), want.asnumpy(), rtol=1e-6,
                               atol=1e-6)


def test_clip_without_bounds_and_int_softmax():
    a = np.arange(12, dtype=np.int32).reshape(3, 4)
    _same(jnd.clip(jnd.array(a)), tnd.clip(tnd.array(a)))
    for op in ("softmax", "log_softmax"):
        want = getattr(jnd, op)(jnd.array(a))
        got = getattr(tnd, op)(tnd.array(a))
        assert str(got.asnumpy().dtype) == str(want.asnumpy().dtype)
        np.testing.assert_allclose(got.asnumpy(), want.asnumpy(),
                                   rtol=1e-6, atol=1e-6)


def _sweep_inputs(dtype, n):
    rs = np.random.RandomState(0)
    out = []
    for _ in range(n):
        a = (np.abs(rs.randn(3, 4)) + 0.5).astype(np.float32)
        out.append((a * 3).astype(np.int32) if dtype == "int32" else a)
    return out


def _as_jax(a, dtype):
    x = jnp.asarray(a)
    return x.astype(jnp.bfloat16) if dtype == "bfloat16" else x


def _as_torch(a, dtype):
    t = torch.from_numpy(a)
    return t.to(torch.bfloat16) if dtype == "bfloat16" else t


# (name, dtype) pairs where the reference computes and the port raises,
# each a refusal ROADMAP.md names; none today
REFUSED_IN_PORT = []


@pytest.mark.parametrize("dtype", ["float32", "bfloat16", "int32"])
def test_registry_output_dtypes(dtype):
    """Every op name both registries share (random ops aside), with one or
    two (3, 4) inputs and default attributes: where the reference computes
    a result at the smaller arity, the port computes one too (or the name
    is in ``REFUSED_IN_PORT``), and the output dtypes agree."""
    names = sorted({op.name for op in TREG.values()} & set(JREG))
    compared, mismatched, raised = 0, [], []
    for name in names:
        jop, top = JREG[name], TREG[name]
        if jop.rng or top.rng:
            continue
        for n in (1, 2):
            xs = _sweep_inputs(dtype, n)
            try:
                want = jop.fn(*[_as_jax(a, dtype) for a in xs])
            except Exception:  # noqa: BLE001 — not this arity / dtype
                continue
            try:
                with torch.no_grad():
                    got = top.fn(*[_as_torch(a, dtype) for a in xs])
            except Exception as e:  # noqa: BLE001 — collected below
                raised.append((name, n, f"{type(e).__name__}: {e}"[:120]))
                break
            want = want if isinstance(want, (tuple, list)) else [want]
            got = got if isinstance(got, (tuple, list)) else [got]
            wd = [str(w.dtype) for w in want]
            gd = [dtype_name(g.dtype) for g in got]
            compared += 1
            if wd != gd:
                mismatched.append((name, n, wd, gd))
            break
    assert not mismatched, mismatched
    assert [(nm, dtype) for nm, _, _ in raised] == \
        [r for r in REFUSED_IN_PORT if r[1] == dtype], raised
    assert compared >= 80, compared


def _sweep_fault_inputs():
    rs = np.random.RandomState(0)
    a = (np.abs(rs.randn(3, 4)) + 0.5).astype(np.float32)
    return a, (a * 3).astype(np.int32)


@pytest.mark.parametrize("dtype", ["float32", "int32"])
def test_pooling_default_kernel(dtype):
    """``Pooling`` with its default kernel ``()`` on data of no spatial
    dim pools windows of one entry, as the reference computes it."""
    a = _sweep_fault_inputs()[dtype == "int32"]
    _same(jnd.Pooling(jnd.array(a)), tnd.Pooling(tnd.array(a)))


@pytest.mark.parametrize("dtype", ["float32", "int32"])
def test_embedding_index_out_of_range(dtype):
    """An index in [-n, 0) counts from the end; any other index out of
    the table gives a row of jnp.take's fill (NaN, or int32's least
    value), as the reference gathers it."""
    w = np.arange(12, dtype=np.float32).reshape(3, 4).astype(dtype)
    ids = np.array([[0, 3, -1], [5, -4, 2]], np.float32)
    want = jnd.Embedding(jnd.array(ids), jnd.array(w), input_dim=3,
                         output_dim=4)
    got = tnd.Embedding(tnd.array(ids), tnd.array(w), input_dim=3,
                        output_dim=4)
    assert str(want.asnumpy().dtype) == str(got.asnumpy().dtype)
    np.testing.assert_array_equal(got.asnumpy(), want.asnumpy())


def test_mod_scalar_int32_by_zero():
    a = _sweep_fault_inputs()[1]
    _same(jnd._mod_scalar(jnd.array(a)), tnd._mod_scalar(tnd.array(a)))
    b = np.array([[0, 2, 0, 3]] * 3, np.int32)
    _same(jnd.elemwise_mod(jnd.array(a), jnd.array(b)),
          tnd.elemwise_mod(tnd.array(a), tnd.array(b)))


def test_softmax_output_int32():
    a = _sweep_fault_inputs()[1]
    lab = np.array([0, 3, 1], np.float32)
    _same(jnd.SoftmaxOutput(jnd.array(a), jnd.array(lab)),
          tnd.SoftmaxOutput(tnd.array(a), tnd.array(lab)))
