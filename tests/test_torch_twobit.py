"""PyTorch port, kernels 1-2: 2-bit gradient compression against the JAX
package.

The port's ``twobit_pack`` / ``twobit_unpack`` on CPU tensors run their
plain versions; the JAX functions run the Pallas pack and unpack kernels
through the interpreter off-TPU.  Same numpy inputs from a seed, with
elements exactly at +t, -t and 0; shapes from one element to past the
kernel's 64-row block; thresholds 0.5, 0 (where the zero padding packs
to 0b11) and 1e9 (every code 0).  Tolerance: none — packed words (shape,
dtype and bits), residuals and unpacked values are bitwise equal, as
the packed layout is a wire format.  ``GradientCompression`` with both
backends (the strided "pallas" layout and the consecutive one) is held
to the same bits, and its error feedback converges as the reference's
does.  The CUDA kernels themselves are held against the plain versions
on the card by chip_smoke.py.
"""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from mxnet_tpu.ops import pallas_kernels as pk
from mxnet_tpu.parallel.compression import GradientCompression as JGC
from mxnet_tpu_torch.base import MXNetError
from mxnet_tpu_torch.ops import twobit as tb
from mxnet_tpu_torch.parallel import GradientCompression as TGC

SHAPES = [(5,), (127,), (16, 129), (3, 4, 5), (64 * 2048 + 3,),
          (65 * 2048,)]
THRESHOLDS = [0.5, 0.0, 1e9]


def _inputs(shape, t, seed):
    """grad ~ N(0, 0.6^2), residual ~ N(0, 0.2^2); the first elements of
    grad exactly +t, -t, 0 and +t with residual 0 there."""
    rs = np.random.RandomState(seed)
    g = (rs.randn(*shape) * 0.6).astype(np.float32)
    r = (rs.randn(*shape) * 0.2).astype(np.float32)
    k = min(4, g.size)
    g.reshape(-1)[:k] = np.array([t, -t, 0.0, t], np.float32)[:k]
    r.reshape(-1)[:k] = 0.0
    return g, r


def _bits(a):
    a = np.asarray(a)
    return a.view({4: np.uint32, 2: np.uint16}[a.dtype.itemsize])


@pytest.mark.parametrize("t", THRESHOLDS)
@pytest.mark.parametrize("shape", SHAPES, ids=str)
def test_pack_unpack_bitwise_equal_to_jax(shape, t):
    g, r = _inputs(shape, t, seed=len(shape) * 100 + shape[0])
    jp, jr = pk.twobit_pack(jnp.asarray(g), jnp.asarray(r), t)
    tp, tr = tb.twobit_pack(torch.from_numpy(g), torch.from_numpy(r), t)
    jp, jr = np.asarray(jp), np.asarray(jr)
    assert tp.dtype == torch.uint32 and tp.numpy().dtype == jp.dtype
    assert tuple(tp.shape) == jp.shape == (tb.packed_rows(g.size), 128)
    np.testing.assert_array_equal(tp.numpy(), jp)
    assert tuple(tr.shape) == shape
    np.testing.assert_array_equal(_bits(tr.numpy()), _bits(jr))
    for tdt, jdt in ((torch.float32, jnp.float32),
                     (torch.bfloat16, jnp.bfloat16)):
        want = np.asarray(pk.twobit_unpack(jnp.asarray(jp), shape, t,
                                           dtype=jdt))
        got = tb.twobit_unpack(tp, shape, t, dtype=tdt)
        assert tuple(got.shape) == shape and got.dtype == tdt
        if tdt == torch.bfloat16:
            np.testing.assert_array_equal(got.view(torch.int16).numpy(),
                                          want.view(np.int16))
        else:
            np.testing.assert_array_equal(_bits(got.numpy()), _bits(want))


def test_padding_rows_and_threshold_zero_words():
    """Rows: whole 2048-element rows, a multiple of 64 past 64; at t = 0
    every padded element packs to 0b11, as the reference's zero pad
    does."""
    assert [tb.packed_rows(n) for n in (1, 2048, 2049, 64 * 2048,
                                        64 * 2048 + 1, 65 * 2048)] == \
        [1, 1, 2, 64, 128, 128]
    p, _ = tb.twobit_pack(torch.ones(3), torch.zeros(3), 0.0)
    words = p.view(torch.int32).numpy().view(np.uint32)
    assert words[0, 0] == 0xFFFFFFFD   # element 0: +1 >= 0 only; pad 0b11
    assert (words[0, 3:] == 0xFFFFFFFF).all()


def test_wrappers_take_the_plain_version_on_cpu_only():
    n0, u0 = tb.twobit_pack.launches, tb.twobit_unpack.launches
    p, _ = tb.twobit_pack(torch.zeros(10), torch.zeros(10), 0.5)
    tb.twobit_unpack(p, (10,), 0.5)
    assert (tb.twobit_pack.launches, tb.twobit_unpack.launches) == (n0, u0)
    with pytest.raises(MXNetError, match="unsupported device"):
        tb.twobit_pack(torch.empty(4, device="meta"),
                       torch.empty(4, device="meta"), 0.5)
    with pytest.raises(MXNetError, match="unsupported device"):
        tb.twobit_unpack(torch.empty(1, 128, dtype=torch.int32,
                                     device="meta"), (4,), 0.5)


@pytest.mark.parametrize("backend", ["pallas", "jnp"])
@pytest.mark.parametrize("t", THRESHOLDS)
@pytest.mark.parametrize("shape", [(37,), (16, 129), (64 * 2048 + 3,)],
                         ids=str)
def test_gradient_compression_bitwise_equal_to_jax(backend, t, shape):
    g, r = _inputs(shape, t, seed=7 + shape[0])
    jgc, tgc = JGC(threshold=t, backend=backend), \
        TGC(threshold=t, backend=backend)
    for res in (r, None):
        jp, jr = jgc.quantize(jnp.asarray(g),
                              None if res is None else jnp.asarray(res))
        tp, tr = tgc.quantize(torch.from_numpy(g),
                              None if res is None else torch.from_numpy(res))
        jp = np.asarray(jp)
        assert tp.dtype == torch.uint32 and tuple(tp.shape) == jp.shape
        np.testing.assert_array_equal(tp.numpy(), jp)
        np.testing.assert_array_equal(_bits(tr.numpy()), _bits(jr))
        for tdt, jdt in ((torch.float32, jnp.float32),
                         (torch.bfloat16, jnp.bfloat16)):
            want = np.asarray(jgc.dequantize(jnp.asarray(jp), shape,
                                             dtype=jdt))
            got = tgc.dequantize(tp, shape, dtype=tdt)
            assert got.dtype == tdt and tuple(got.shape) == shape
            np.testing.assert_array_equal(
                _bits(got.float().numpy()), _bits(want.astype(np.float32)))
    jd, jr = jgc.quantize_dequantize(jnp.asarray(g), jnp.asarray(r))
    td, tr = tgc.quantize_dequantize(torch.from_numpy(g), torch.from_numpy(r))
    np.testing.assert_array_equal(_bits(td.numpy()), _bits(jd))
    np.testing.assert_array_equal(_bits(tr.numpy()), _bits(jr))


def test_backends_pack_different_layouts():
    """The backend is part of the wire format: the same codes, strided
    (rows, 128) against 16 consecutive per word."""
    g = torch.from_numpy(_inputs((4096,), 0.5, 3)[0])
    a, _ = TGC(backend="pallas").quantize(g)
    b, _ = TGC(backend="jnp").quantize(g)
    assert tuple(a.shape) == (2, 128) and tuple(b.shape) == (256,)
    assert not np.array_equal(a.numpy().reshape(-1), b.numpy())


def test_params_none_type_and_errors():
    gc = TGC(type="2bit", threshold=0.25)
    assert gc.get_params() == JGC(type="2bit", threshold=0.25).get_params() \
        == {"type": "2bit", "threshold": 0.25}
    assert gc.wire_params() == JGC(threshold=0.25).wire_params() == \
        {"type": "2bit", "threshold": 0.25, "backend": "pallas"}
    assert TGC(backend="jnp").wire_params()["backend"] == "jnp"
    with pytest.raises(ValueError, match="unsupported compression type"):
        TGC(type="1bit")
    none = TGC(type="none")
    g = torch.randn(7)
    p, r = none.quantize(g, None)
    assert p is g and r is None
    assert none.dequantize(g, (7,)) is g
    d, r = none.quantize_dequantize(g)
    assert d is g and torch.equal(r, torch.zeros(7))


@pytest.mark.parametrize("backend", ["pallas", "jnp"])
def test_error_feedback_converges(backend):
    """tests/test_parallel.py's round trip: values in {-t, 0, t},
    dequantized + residual = g, and the running mean of the dequantized
    values over 50 rounds approaches g."""
    gc = TGC(type="2bit", threshold=0.5, backend=backend)
    r = np.random.RandomState(0)
    g = torch.from_numpy((r.randn(37) * 0.15).astype(np.float32))
    packed, residual = gc.quantize(g, None)
    deq = gc.dequantize(packed, (37,))
    assert set(np.unique(deq.numpy())) <= {-0.5, 0.0, 0.5}
    np.testing.assert_allclose((deq + residual).numpy(), g.numpy(),
                               atol=1e-6)
    total = torch.zeros_like(g)
    res = None
    for _ in range(50):
        packed, res = gc.quantize(g, res)
        total = total + gc.dequantize(packed, (37,))
    np.testing.assert_allclose((total / 50).numpy(), g.numpy(), atol=0.02)
