"""PyTorch port, kernel 5: fused LayerNorm(+GELU) against the JAX package.

The port's ``layer_norm_fused`` on CPU tensors runs its plain version;
the JAX ``layer_norm_fused`` runs its Pallas kernel through the
interpreter off-TPU (M=16) or its jnp reference (odd M=7).  Same numpy
inputs, f32, rtol 1e-5 / atol 1e-6 (the two sum in different orders).
The gradient: the port's vjp against the JAX custom vjp (the vjp of its
``_ln_reference``), and the port's autograd Function, whose backward is
autograd through the plain version, against that plain version.  The
CUDA kernel itself is held against the plain version on the card by
chip_smoke.py.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from mxnet_tpu.ops import pallas_kernels as pk
from mxnet_tpu_torch.base import MXNetError
from mxnet_tpu_torch.ops import layer_norm as tln
from mxnet_tpu_torch.ops.layer_norm import (layer_norm_fused,
                                            layer_norm_reference)

C = 32


@pytest.fixture(scope="module", autouse=True)
def _torch_threads():
    old = torch.get_num_threads()
    torch.set_num_threads(2)
    yield
    torch.set_num_threads(old)


def _inputs(m, seed):
    rs = np.random.RandomState(seed)
    x = (rs.randn(m, C) * 2.0 + 0.5).astype(np.float32)
    g = (1.0 + 0.1 * rs.randn(C)).astype(np.float32)
    b = (0.1 * rs.randn(C)).astype(np.float32)
    return x, g, b


@pytest.mark.parametrize("gelu", [False, True])
@pytest.mark.parametrize("m", [16, 7])
def test_layer_norm_matches_jax(m, gelu):
    x, g, b = _inputs(m, 10 * m + int(gelu))
    j_args = (jnp.asarray(x), jnp.asarray(g), jnp.asarray(b))
    want_kernel = np.asarray(pk.layer_norm_fused(*j_args, 1e-5, gelu))
    want_ref = np.asarray(pk._ln_reference(*j_args, 1e-5, gelu))
    before = layer_norm_fused.launches
    got = layer_norm_fused(torch.from_numpy(x), torch.from_numpy(g),
                           torch.from_numpy(b), 1e-5, gelu).numpy()
    np.testing.assert_allclose(got, want_kernel, rtol=1e-5, atol=1e-6)
    np.testing.assert_allclose(got, want_ref, rtol=1e-5, atol=1e-6)
    # the CPU path is the plain version: no kernel launch counted
    assert layer_norm_fused.launches == before


def test_layer_norm_any_rank_and_bf16():
    x, g, b = _inputs(12, 3)
    x3 = x.reshape(3, 4, C)
    want = np.asarray(pk._ln_reference(jnp.asarray(x3), jnp.asarray(g),
                                       jnp.asarray(b), 1e-5, True))
    got = layer_norm_fused(torch.from_numpy(x3), torch.from_numpy(g),
                           torch.from_numpy(b), gelu=True)
    assert got.shape == (3, 4, C)
    np.testing.assert_allclose(got.numpy(), want, rtol=1e-5, atol=1e-6)
    # bf16 in, bf16 out, f32 statistics inside
    xb = torch.from_numpy(x).to(torch.bfloat16)
    out = layer_norm_reference(xb, torch.from_numpy(g).to(torch.bfloat16),
                               torch.from_numpy(b).to(torch.bfloat16))
    assert out.dtype == torch.bfloat16
    ref = layer_norm_reference(xb.float(), torch.from_numpy(g).to(
        torch.bfloat16).float(), torch.from_numpy(b).to(
        torch.bfloat16).float())
    np.testing.assert_allclose(out.float().numpy(), ref.numpy(), rtol=2e-2,
                               atol=1e-2)


@pytest.mark.parametrize("gelu", [False, True])
def test_layer_norm_vjp_matches_jax(monkeypatch, gelu):
    monkeypatch.setenv("TPUMX_PALLAS", "1")
    x, g, b = _inputs(16, 40 + int(gelu))
    dy = np.random.RandomState(41).randn(16, C).astype(np.float32)
    _, vjp = jax.vjp(lambda *a: pk.layer_norm_fused(*a, 1e-5, gelu),
                     jnp.asarray(x), jnp.asarray(g), jnp.asarray(b))
    want = vjp(jnp.asarray(dy))
    leaves = [torch.from_numpy(t).requires_grad_() for t in (x, g, b)]
    out = layer_norm_fused(*leaves, 1e-5, gelu)
    got = torch.autograd.grad(out, leaves, torch.from_numpy(dy))
    for a, w, name in zip(got, want, ("dx", "dgamma", "dbeta")):
        np.testing.assert_allclose(a.numpy(), np.asarray(w), rtol=1e-5,
                                   atol=1e-6, err_msg=name)


@pytest.mark.parametrize("gelu", [False, True])
def test_layer_norm_function_backward_is_reference_vjp(monkeypatch, gelu):
    """The Function the CUDA path runs: its backward recomputes the plain
    version from the saved inputs and differentiates it (its forward is
    the kernel, stood in for here by the plain version)."""
    monkeypatch.setattr(tln, "_launch", layer_norm_reference)
    x, g, b = _inputs(12, 50 + int(gelu))
    dy = torch.from_numpy(np.random.RandomState(51).randn(3, 4, C)
                          .astype(np.float32))
    leaves = [torch.from_numpy(t).requires_grad_()
              for t in (x.reshape(3, 4, C), g, b)]
    out = tln._LayerNormFn.apply(*leaves, 1e-5, gelu)
    assert out.grad_fn is not None
    got = torch.autograd.grad(out, leaves, dy)
    want = torch.autograd.grad(layer_norm_reference(*leaves, 1e-5, gelu),
                               leaves, dy)
    assert all(torch.equal(a, w) for a, w in zip(got, want))


def test_kernel_build_failure_raises(monkeypatch, tmp_path):
    """Without nvcc the first use of a kernel raises; nothing falls back."""
    from mxnet_tpu_torch.ops import _build

    monkeypatch.setattr(_build, "BUILD_DIR", str(tmp_path))
    monkeypatch.setenv("CUDA_HOME", str(tmp_path))
    monkeypatch.setenv("PATH", str(tmp_path))
    with pytest.raises(MXNetError, match="nvcc not found"):
        _build.kernel_function("layer_norm", "tpumx_layer_norm", [])
    assert sorted(_build._sources()) == ["batch_norm", "flash_attention",
                                         "layer_norm", "paged_attention",
                                         "twobit"]


def test_layer_norm_refuses_other_devices():
    x = torch.empty(4, C, device="meta")
    g = torch.empty(C, device="meta")
    with pytest.raises(MXNetError, match="unsupported device"):
        layer_norm_fused(x, g, g)
