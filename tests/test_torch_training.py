"""PyTorch port: the LM's training loss and SGD-momentum step against the
JAX package.

Same parameters (the JAX initializer's, carried across by
``params_from_jax``, as are the momenta), same numpy tokens, labels the
tokens rolled by one (the reference trainer's).  Two chained
``train_step``s per attention: the loss of each step and every parameter
and momentum after each at rtol 1e-4 / atol 1e-5 (XLA:CPU and torch order
their matmul sums differently).  With flash attention the JAX side runs
its Pallas forward and backward kernels through the interpreter
(``TPUMX_PALLAS=1``, which also routes its LayerNorms through the fused
kernel and its custom vjp); the port runs the plain versions of its
kernels through the same autograd Functions the CUDA kernels sit in.
"""
import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from mxnet_tpu.ops import flash_attention as jfa
from mxnet_tpu.parallel import transformer as jt
from mxnet_tpu.parallel.ring_attention import local_attention as j_local
from mxnet_tpu_torch.ops import flash_attention as tfa
from mxnet_tpu_torch.ops.layer_norm import layer_norm_fused
from mxnet_tpu_torch.parallel import transformer as tt
from mxnet_tpu_torch.parallel.ring_attention import local_attention as t_local

DIMS = dict(vocab=61, d_model=32, n_heads=2, n_layers=2, d_ff=64,
            max_len=64)
JCFG = jt.TransformerConfig(**DIMS)
TCFG = tt.TransformerConfig(**DIMS)
B, T = 2, 40
TOL = dict(rtol=1e-4, atol=1e-5)
ATTENTION = {
    "flash": (functools.partial(jfa.flash_attention, causal=True),
              functools.partial(tfa.flash_attention, causal=True)),
    "local": (functools.partial(j_local, causal=True),
              functools.partial(t_local, causal=True)),
}


@pytest.fixture(scope="module", autouse=True)
def _torch_threads():
    old = torch.get_num_threads()
    torch.set_num_threads(2)
    yield
    torch.set_num_threads(old)


@pytest.fixture(scope="module")
def params():
    pj = jt.transformer_lm_init(JCFG, jax.random.PRNGKey(0))
    return {k: np.asarray(v) for k, v in pj.items()}


@pytest.fixture(scope="module")
def batch():
    rs = np.random.RandomState(0)
    tokens = rs.randint(0, DIMS["vocab"], (B, T)).astype(np.int32)
    mask = (rs.rand(B, T) > 0.3).astype(np.float32)
    return tokens, np.roll(tokens, -1, 1), np.arange(T, dtype=np.int32), mask


def _to_torch(pn):
    return tt.params_from_jax(pn, device="cpu")


@pytest.mark.parametrize("masked", [False, True])
def test_lm_loss_matches_jax(params, batch, masked):
    tokens, labels, positions, mask = batch
    m = mask if masked else None
    want = float(jt.lm_loss({k: jnp.asarray(v) for k, v in params.items()},
                            jnp.asarray(tokens), jnp.asarray(labels),
                            jnp.asarray(positions), JCFG,
                            mask=None if m is None else jnp.asarray(m)))
    got = tt.lm_loss(_to_torch(params), torch.from_numpy(tokens),
                     torch.from_numpy(labels), torch.from_numpy(positions),
                     TCFG, mask=None if m is None else torch.from_numpy(m))
    assert got.dtype == torch.float32 and got.dim() == 0
    np.testing.assert_allclose(got.item(), want, **TOL)
    if masked:
        # an all-zero mask divides by max(sum(mask), 1): a zero loss
        zero = tt.lm_loss(_to_torch(params), tokens, labels, positions,
                          TCFG, mask=np.zeros((B, T), np.float32))
        assert zero.item() == 0.0


@pytest.mark.parametrize("attention", ["flash", "local"])
def test_train_steps_match_jax(monkeypatch, params, batch, attention):
    monkeypatch.setenv("TPUMX_PALLAS", "1")
    tokens, labels, positions, _ = batch
    j_att, t_att = ATTENTION[attention]
    pj = {k: jnp.asarray(v) for k, v in params.items()}
    mj = {k: jnp.zeros_like(v) for k, v in pj.items()}
    pt = _to_torch(params)
    mt = tt.params_from_jax({k: np.zeros_like(v) for k, v in params.items()},
                            device="cpu")
    step = jax.jit(functools.partial(jt.train_step, cfg=JCFG,
                                     attention=j_att))
    counts = (layer_norm_fused.launches, tfa.flash_attention_forward.launches)
    for i in range(2):
        lj, pj, mj = step(pj, mj, jnp.asarray(tokens), jnp.asarray(labels),
                          jnp.asarray(positions))
        before = {k: v.clone() for k, v in pt.items()}
        lt, pt, mt = tt.train_step(pt, mt, torch.from_numpy(tokens),
                                   torch.from_numpy(labels),
                                   torch.from_numpy(positions), TCFG,
                                   attention=t_att)
        assert lt.dtype == torch.float32 and not lt.requires_grad
        np.testing.assert_allclose(lt.item(), float(lj), **TOL,
                                   err_msg=f"loss, step {i}")
        for k in params:
            np.testing.assert_allclose(pt[k].numpy(), np.asarray(pj[k]),
                                       **TOL, err_msg=f"param {k}, step {i}")
            np.testing.assert_allclose(mt[k].numpy(), np.asarray(mj[k]),
                                       **TOL, err_msg=f"momentum {k}, step "
                                       f"{i}")
            # the step returns new tensors and leaves its inputs alone
            assert not pt[k].requires_grad
        assert all(not torch.equal(before[k], pt[k]) for k in ("tok_emb",
                                                               "l1_w2"))
    # CPU tensors run the plain versions: no kernel launch counted
    assert (layer_norm_fused.launches,
            tfa.flash_attention_forward.launches) == counts


def test_train_step_bf16_compute(monkeypatch, params, batch):
    """``compute_dtype=bfloat16``: params cast inside the loss, f32 masters
    and momenta.  The two packages round to bf16 at other places, so each
    step's loss agrees within 2e-3 relative (1.2e-4 seen over three steps
    on the CPU), the first lies within 2e-2 of the f32 loss, and the
    second is below the first."""
    monkeypatch.setenv("TPUMX_PALLAS", "1")
    tokens, labels, positions, _ = batch
    j_att, t_att = ATTENTION["flash"]
    pj = {k: jnp.asarray(v) for k, v in params.items()}
    mj = {k: jnp.zeros_like(v) for k, v in pj.items()}
    pt = _to_torch(params)
    mt = {k: torch.zeros_like(v) for k, v in pt.items()}
    f32 = tt.lm_loss(pt, tokens, labels, positions, TCFG,
                     attention=t_att).item()
    step = jax.jit(functools.partial(jt.train_step, cfg=JCFG,
                                     attention=j_att,
                                     compute_dtype=jnp.bfloat16))
    losses = []
    for _ in range(2):
        lj, pj, mj = step(pj, mj, jnp.asarray(tokens), jnp.asarray(labels),
                          jnp.asarray(positions))
        lt, pt, mt = tt.train_step(pt, mt, tokens, labels, positions, TCFG,
                                   attention=t_att,
                                   compute_dtype=torch.bfloat16)
        assert all(v.dtype == torch.float32 for v in pt.values())
        assert all(v.dtype == torch.float32 for v in mt.values())
        np.testing.assert_allclose(lt.item(), float(lj), rtol=2e-3)
        losses.append(lt.item())
    np.testing.assert_allclose(losses[0], f32, rtol=2e-2)
    assert np.isfinite(losses).all() and losses[1] < losses[0]
