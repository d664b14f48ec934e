"""PyTorch port: meshes, collectives, ring and Ulysses attention, the mesh
``DataParallelTrainer`` and the dp x sp sharded LM step, against the JAX
package's.

The reference runs in this process over 4 of the 8 virtual CPU devices
``tests/conftest.py`` gives it.  The port runs as it runs on cards: one
process per device.  A module-scoped fixture starts a gloo world of 4
``python -c`` processes (a ``FileStore`` under the test's temporary
directory, 120 s timeout each) that import torch and the port only, run
every scenario of ``WORKER`` on the inputs this file wrote (numpy from
seeds), and each save their results as ``.npz``; the tests compare them
with the reference's on the same inputs.  The meshes: ``dp=2 x sp=2``
(axes of size 2), ``sp=4`` and ``dp=4``.

- Collectives: each one's output and its gradient (the vjp of the
  reference's ``shard_map``, every input and output split over both axes,
  so each rank's block and cotangent are its own); ``broadcast``'s src
  check.
- Attention: ring (causal and not) at sp = 2 and 4, Ulysses dense, and
  Ulysses-flash (``TPUMX_PALLAS=1`` on the reference: its Pallas kernels
  through the interpreter; the port's flash plain version), against
  ``local_attention`` and the reference's sharded versions, outputs and
  (q, k, v) gradients, rtol 1e-5.
- ``DataParallelTrainer`` over ``dp=4`` with a BatchNorm MLP: plain (the
  whole batch's statistics on every rank) and 2-bit (each rank's codes,
  bit for bit the reference's: the reference's codes are recovered from
  its residuals and the port's compressed inputs, which agree to
  rounding far from +-t), three steps, losses, parameters and running
  statistics rtol 1e-4.
- ``make_sharded_train_step`` at dp=2 x sp=2 for ring, ulysses and
  ulysses_flash, three f32 steps: losses and parameters rtol 1e-4, and
  the first step's momenta (the gradients) against the reference's.
- ``_contrib_SyncBatchNorm`` with ``axis_name="sp"`` over sp=4, each rank
  on its block of the batch: output and input gradient against the
  reference's ``shard_map``, the moments against the whole batch's.
"""
import functools
import os
import subprocess
import sys

import jax
import jax.numpy as jnp
import numpy as np
import pytest
from jax import lax
from jax.sharding import PartitionSpec as JP

import mxnet_tpu.parallel.mesh as jmesh
from mxnet_tpu import gluon as jgluon, nd as jnd
from mxnet_tpu.parallel import collectives as JC
from mxnet_tpu.parallel.data_parallel import DataParallelTrainer as JTrainer
from mxnet_tpu.parallel.ring_attention import (local_attention as j_local,
                                               ring_attention as j_ring,
                                               ring_attention_sharded)
from mxnet_tpu.parallel.sequence_parallel import (ulysses_attention as
                                                  j_ulysses,
                                                  ulysses_attention_sharded)
from mxnet_tpu.parallel.transformer import (TransformerConfig as JConfig,
                                            make_sharded_train_step,
                                            shard_batch, transformer_lm_init)

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
WORLD = 4
ATTN_TOL = dict(rtol=1e-5, atol=1e-6)
MODEL_TOL = dict(rtol=1e-4, atol=1e-6)
CFG = dict(vocab=64, d_model=32, n_heads=4, n_layers=2, d_ff=64, max_len=32)
LM_B, LM_T, LM_STEPS, LM_LR, LM_MOMENTUM = 4, 16, 3, 0.1, 0.9
DP_BATCH, DP_STEPS, DP_LR, DP_MOMENTUM, DP_WD = 32, 3, 0.1, 0.9, 1e-3
THRESHOLD = 0.05
SP_IMPLS = ("ring", "ulysses", "ulysses_flash")

# name -> (mesh, spec of the input and of the output): every case splits
# its input and output over every axis of its mesh
COLLECTIVES = {
    "psum_dp": "m22", "psum_dpsp": "m22", "allgather_sp": "m22",
    "reduce_scatter_sp": "m22", "broadcast_sp": "m22",
    "all_to_all_sp": "m22", "ppermute_swap": "m22",
    "all_to_all_sp4": "m4", "ppermute_chain4": "m4",
}
ATTENTION = {  # name -> (mesh, impl, causal, with gradients)
    "ring2": ("m22", "ring", False, False),
    "ring2_causal": ("m22", "ring", True, True),
    "ring4": ("m4", "ring", False, False),
    "ring4_causal": ("m4", "ring", True, True),
    "ulysses2": ("m22", "dense", False, False),
    "ulysses2_causal": ("m22", "dense", True, True),
    "ulysses4_causal": ("m4", "dense", True, False),
    "flash2_causal": ("m22", "flash", True, True),
    "flash4": ("m4", "flash", False, True),
}

WORKER = r'''
import sys
from datetime import timedelta

import numpy as np
import torch
import torch.distributed as dist

rank, world, store, out = int(sys.argv[1]), int(sys.argv[2]), sys.argv[3], \
    sys.argv[4]
sys.path.insert(0, sys.argv[5])
torch.set_num_threads(1)
dist.init_process_group("gloo", store=dist.FileStore(store, world),
                        rank=rank, world_size=world,
                        timeout=timedelta(seconds=120))

import mxnet_tpu_torch as mx
from mxnet_tpu_torch import gluon
from mxnet_tpu_torch.base import MXNetError
from mxnet_tpu_torch.parallel import collectives as C
from mxnet_tpu_torch.parallel import (DataParallelTrainer, TransformerConfig,
                                      dp_mesh, make_mesh,
                                      make_sharded_train_step,
                                      params_from_jax, shard_batch)
from mxnet_tpu_torch.parallel.mesh import (NamedSharding, PartitionSpec as P,
                                           gather, shard)
from mxnet_tpu_torch.parallel.ring_attention import (
    ring_attention, ring_attention_sharded)
from mxnet_tpu_torch.parallel.sequence_parallel import (
    ulysses_attention, ulysses_attention_sharded)

inp = dict(np.load(out + "/inputs.npz"))
cfgs = eval(open(out + "/config.txt").read())
res = {}
T = torch.tensor

with mx.cpu():
    meshes = {"m22": make_mesh(dp=2, sp=2), "m4": make_mesh(sp=4,
                                                            install=False)}
    specs = {"m22": P("dp", "sp"), "m4": P("sp")}

    def local_vjp(f, mesh, ispec, ospec, xs, c):
        """f on this rank's blocks; its whole output and the whole
        gradients of sum(f * c) gathered."""
        ls = [shard(T(x), NamedSharding(mesh, ispec)).requires_grad_()
              for x in xs]
        cl = shard(T(c), NamedSharding(mesh, ospec))
        with C.spmd(mesh):
            y = f(*ls)
            gs = torch.autograd.grad((y * cl).sum(), ls)
            y = gather(y.detach(), NamedSharding(mesh, ospec))
            gs = [gather(g, NamedSharding(mesh, ispec)) for g in gs]
        return y, gs

    coll = {
        "psum_dp": lambda t: C.allreduce(t, "dp"),
        "psum_dpsp": lambda t: C.allreduce(t, ("dp", "sp")),
        "allgather_sp": lambda t: C.allgather(t, "sp", axis=1),
        "reduce_scatter_sp": lambda t: C.reduce_scatter(t, "sp", axis=1),
        "broadcast_sp": lambda t: C.broadcast(t, "sp", src=1),
        "all_to_all_sp": lambda t: C.all_to_all(t, "sp", 1, 0),
        "ppermute_swap": lambda t: C.ppermute(t, "sp", [(0, 1), (1, 0)]),
        "all_to_all_sp4": lambda t: C.all_to_all(t, "sp", 1, 0),
        "ppermute_chain4": lambda t: C.ppermute(t, "sp",
                                                [(0, 1), (1, 2), (2, 3)]),
    }
    for name, m in cfgs["collectives"].items():
        y, (g,) = local_vjp(coll[name], meshes[m], specs[m], specs[m],
                            [inp[f"x_{m}"]], inp[f"c_{name}"])
        res[f"coll_{name}"], res[f"coll_{name}_grad"] = y.numpy(), g.numpy()
    res["tree"] = C.allreduce_tree([T(inp["x_m4"][rank])],
                                   mesh=meshes["m4"], axis="sp")[0].numpy()
    with C.spmd(meshes["m22"]):
        try:
            C.broadcast(T([1.0]), "dp", src=2)
            res["broadcast_src_refused"] = np.array(False)
        except ValueError:
            res["broadcast_src_refused"] = np.array(True)
    try:
        make_mesh(dp=3)
        res["bad_mesh_refused"] = np.array(False)
    except MXNetError:
        res["bad_mesh_refused"] = np.array(True)

    q, k, v, g = (inp[n] for n in ("q", "k", "v", "g"))
    for name, (m, impl, causal, grads) in cfgs["attention"].items():
        mesh = meshes[m]
        if impl == "ring":
            o = ring_attention_sharded(T(q), T(k), T(v), mesh=mesh,
                                       causal=causal)
            f = lambda a, b, c: ring_attention(a, b, c, "sp", causal)
        else:
            o = ulysses_attention_sharded(T(q), T(k), T(v), mesh=mesh,
                                          causal=causal, impl=impl)
            f = lambda a, b, c: ulysses_attention(a, b, c, "sp", causal,
                                                  impl)
        res[f"attn_{name}"] = o.numpy()
        if grads:
            spec = P("dp", "sp") if m == "m22" else P(None, "sp")
            _, gs = local_vjp(f, mesh, spec, spec, [q, k, v], g)
            for n, t in zip("qkv", gs):
                res[f"attn_{name}_d{n}"] = t.numpy()

    # _contrib_SyncBatchNorm over sp=4: the moments all-reduced
    from mxnet_tpu_torch.ops.registry import get_op

    sbn = get_op("_contrib_SyncBatchNorm").fn
    consts = [T(inp[f"sbn_{n}"]) for n in ("gamma", "beta", "mm", "mv")]

    def sbn_f(x):
        return sbn(x, *consts, eps=1e-3, fix_gamma=False, axis_name="sp",
                   _training=True)

    y, (gx,) = local_vjp(sbn_f, meshes["m4"], P("sp"), P("sp"),
                         [inp["sbn_x"]], inp["sbn_c"])
    res["sbn_out"], res["sbn_dx"] = y.numpy(), gx.numpy()
    with C.spmd(meshes["m4"]):
        xb = shard(T(inp["sbn_x"]), NamedSharding(meshes["m4"], P("sp")))
        _, mean, var = sbn(xb, *consts, eps=1e-3, fix_gamma=False,
                           axis_name="sp", output_mean_var=True)
    res["sbn_mean"], res["sbn_var"] = mean.numpy(), var.numpy()

    # DataParallelTrainer over dp=4
    dmesh = dp_mesh(4)

    def bn_net():
        net = gluon.nn.HybridSequential()
        net.add(gluon.nn.Dense(16, in_units=8), gluon.nn.BatchNorm(),
                gluon.nn.Activation("relu"), gluon.nn.Dense(2, in_units=16))
        net.initialize(ctx=mx.cpu())
        net(T(inp["dp_x"][:4]))
        for p, w in zip(net.collect_params().values(),
                        (inp[f"dp_w{i}"] for i in range(8))):
            p.set_data(mx.nd.array(w))
        return net

    for comp in (None, {"type": "2bit", "threshold": cfgs["threshold"]}):
        tag = "dp_plain" if comp is None else "dp_2bit"
        tr = DataParallelTrainer(
            bn_net(), gluon.loss.SoftmaxCrossEntropyLoss(), lr=cfgs["lr"],
            momentum=cfgs["momentum"], weight_decay=cfgs["wd"],
            mesh=dmesh, compression_params=comp)
        if comp is not None:
            gc, seen = tr._compression, []
            real = gc.quantize

            def quantize(grad, residual=None, real=real, seen=seen):
                seen.append((grad + residual).numpy().ravel())
                packed, new_res = real(grad, residual)
                seen.append(gc.dequantize(packed, grad.shape).numpy()
                            .ravel())
                return packed, new_res

            gc.quantize = quantize
        for s in range(cfgs["dp_steps"]):
            res[f"{tag}_loss{s}"] = tr.step(inp["dp_x"], inp["dp_y"]).numpy()
            if comp is not None:
                res[f"{tag}_in{s}"] = np.concatenate(seen[0::2])
                res[f"{tag}_dq{s}"] = np.concatenate(seen[1::2])
                seen.clear()
        # parameters, then aux state, each in the net's creation order
        for i, t in enumerate([*tr.params.values(), *tr.aux.values()]):
            res[f"{tag}_p{i}"] = t.numpy()

    # the dp x sp sharded LM step
    cfg = TransformerConfig(**cfgs["lm_cfg"])
    names = sorted(k[3:] for k in inp if k.startswith("lm_"))
    params0 = params_from_jax({n: inp["lm_" + n] for n in names},
                              device="cpu")
    tokens, labels, pos = shard_batch(meshes["m22"], inp["tokens"],
                                      inp["labels"], np.arange(inp[
                                          "tokens"].shape[1]))
    for impl in cfgs["sp_impls"]:
        step = make_sharded_train_step(meshes["m22"], cfg, lr=cfgs["lm_lr"],
                                       momentum=cfgs["lm_momentum"],
                                       sp_impl=impl)
        p, m = params0, {n: torch.zeros_like(t) for n, t in params0.items()}
        for s in range(cfgs["lm_steps"]):
            loss, p, m = step(p, m, tokens, labels, pos)
            res[f"lm_{impl}_loss{s}"] = loss.numpy()
            if s == 0:
                for n in names:
                    res[f"lm_{impl}_m0_{n}"] = m[n].numpy()
        for n in names:
            res[f"lm_{impl}_p_{n}"] = p[n].numpy()

np.savez(out + f"/rank{rank}.npz", **res)
dist.barrier()
dist.destroy_process_group()
'''


def _inputs():
    """Every scenario's inputs, numpy from seeds; the LM's parameters from
    the reference's initializer."""
    r = np.random.RandomState(0)
    inp = {"x_m22": r.randn(4, 8).astype(np.float32),
           "x_m4": r.randn(4, 8).astype(np.float32)}
    out_shapes = {"psum_dp": (4, 8), "psum_dpsp": (4, 8),
                  "allgather_sp": (4, 16), "reduce_scatter_sp": (4, 4),
                  "broadcast_sp": (4, 8), "all_to_all_sp": (8, 4),
                  "ppermute_swap": (4, 8), "all_to_all_sp4": (16, 2),
                  "ppermute_chain4": (4, 8)}
    for name, shape in out_shapes.items():
        inp[f"c_{name}"] = r.randn(*shape).astype(np.float32)
    for n in "qkvg":
        inp[n] = r.randn(2, 16, 4, 8).astype(np.float32)
    inp["dp_x"] = (r.rand(DP_BATCH, 8) * 2 + 1.5).astype(np.float32)
    inp["dp_y"] = r.randint(0, 2, DP_BATCH).astype(np.float32)
    shapes = [(16, 8), (16,), (16,), (16,), (16,), (16,), (2, 16), (2,)]
    for i, s in enumerate(shapes):
        inp[f"dp_w{i}"] = (r.randn(*s) * 0.3).astype(np.float32)
    # creation order: weight, bias, gamma, beta, running mean and var,
    # weight, bias
    inp["dp_w2"] = 1 + inp["dp_w2"] * 0.3
    inp["dp_w5"] = 1 + np.abs(inp["dp_w5"])
    params = transformer_lm_init(JConfig(**CFG), jax.random.PRNGKey(0))
    for k, v in params.items():
        inp["lm_" + k] = np.asarray(v)
    inp["tokens"] = r.randint(0, CFG["vocab"], (LM_B, LM_T)).astype(np.int32)
    inp["labels"] = np.roll(inp["tokens"], -1, 1)
    r = np.random.RandomState(1)
    inp["sbn_x"] = (r.randn(8, 3, 2, 2) * 2 + 1).astype(np.float32)
    inp["sbn_c"] = r.randn(8, 3, 2, 2).astype(np.float32)
    inp["sbn_gamma"] = (1 + r.rand(3)).astype(np.float32)
    inp["sbn_beta"] = r.randn(3).astype(np.float32)
    inp["sbn_mm"] = np.zeros(3, np.float32)
    inp["sbn_mv"] = np.ones(3, np.float32)
    return inp


@pytest.fixture(scope="module")
def world(tmp_path_factory):
    """Start the port's gloo world once; every rank's results."""
    d = tmp_path_factory.mktemp("gloo_world")
    inp = _inputs()
    np.savez(d / "inputs.npz", **inp)
    (d / "config.txt").write_text(repr({
        "collectives": COLLECTIVES, "attention": ATTENTION,
        "threshold": THRESHOLD, "lr": DP_LR, "momentum": DP_MOMENTUM,
        "wd": DP_WD, "dp_steps": DP_STEPS, "lm_cfg": CFG, "lm_lr": LM_LR,
        "lm_momentum": LM_MOMENTUM, "lm_steps": LM_STEPS,
        "sp_impls": SP_IMPLS}))
    env = {k: v for k, v in os.environ.items()
           if not k.startswith(("MXTPU_", "DMLC_", "TPUMX_"))}
    procs = [subprocess.Popen(
        [sys.executable, "-c", WORKER, str(r), str(WORLD),
         str(d / "store"), str(d), REPO], env=env,
        stdout=subprocess.PIPE, stderr=subprocess.STDOUT)
        for r in range(WORLD)]
    logs = []
    try:
        for p in procs:
            logs.append(p.communicate(timeout=120)[0].decode())
    finally:
        for p in procs:
            if p.poll() is None:
                p.kill()
                p.communicate()
    assert all(p.returncode == 0 for p in procs), "\n----\n".join(logs)
    return inp, [dict(np.load(d / f"rank{r}.npz")) for r in range(WORLD)]


@pytest.fixture(autouse=True)
def _ambient_mesh():
    """The reference's meshes are built uninstalled; keep its ambient one."""
    saved = jmesh.get_mesh()
    yield
    jmesh.set_mesh(saved)


def _jmesh(name):
    return {"m22": lambda: jmesh.make_mesh(dp=2, sp=2, install=False),
            "m4": lambda: jmesh.make_mesh(sp=4, install=False),
            "d4": lambda: jmesh.make_mesh(dp=4, install=False)}[name]()


JSPECS = {"m22": JP("dp", "sp"), "m4": JP("sp")}

J_COLL = {
    "psum_dp": lambda t: lax.psum(t, "dp"),
    "psum_dpsp": lambda t: lax.psum(t, ("dp", "sp")),
    "allgather_sp": lambda t: JC.allgather(t, "sp", axis=1),
    "reduce_scatter_sp": lambda t: JC.reduce_scatter(t, "sp", axis=1),
    "broadcast_sp": lambda t: JC.broadcast(t, "sp", src=1),
    "all_to_all_sp": lambda t: JC.all_to_all(t, "sp", 1, 0),
    "ppermute_swap": lambda t: lax.ppermute(t, "sp", [(0, 1), (1, 0)]),
    "all_to_all_sp4": lambda t: JC.all_to_all(t, "sp", 1, 0),
    "ppermute_chain4": lambda t: lax.ppermute(t, "sp",
                                              [(0, 1), (1, 2), (2, 3)]),
}


def _jvjp(f, mesh, ispec, ospec, xs, c):
    """The reference's output and vjp, as one jitted program (the eager
    vjp of a ring's loop compiles each step alone)."""
    fn = JC.shard_map_compat(f, mesh=mesh, in_specs=(ispec,) * len(xs),
                             out_specs=ospec, check=False)

    def run(xs, c):
        y, vjp = jax.vjp(fn, *xs)
        return y, vjp(c)

    y, gs = jax.jit(run)([jnp.asarray(x) for x in xs], jnp.asarray(c))
    return np.asarray(y), [np.asarray(g) for g in gs]


@pytest.mark.parametrize("name", sorted(COLLECTIVES))
def test_collective_and_its_gradient(world, name):
    inp, ranks = world
    m = COLLECTIVES[name]
    y, (g,) = _jvjp(J_COLL[name], _jmesh(m), JSPECS[m], JSPECS[m],
                    [inp[f"x_{m}"]], inp[f"c_{name}"])
    for res in ranks:
        np.testing.assert_allclose(res[f"coll_{name}"], y, **ATTN_TOL)
        np.testing.assert_allclose(res[f"coll_{name}_grad"], g, **ATTN_TOL)


def test_allreduce_tree_and_refusals(world):
    inp, ranks = world
    vals = [jnp.asarray(v) for v in inp["x_m4"]]
    want = JC.allreduce_tree(vals, mesh=_jmesh("m4"), axis="sp")[0]
    for res in ranks:
        np.testing.assert_allclose(res["tree"], np.asarray(want), **ATTN_TOL)
        assert res["broadcast_src_refused"] and res["bad_mesh_refused"]
    with pytest.raises(ValueError):
        JC.shard_map_compat(lambda x: JC.broadcast(x, "dp", src=2),
                            mesh=_jmesh("m22"), in_specs=JP("dp", "sp"),
                            out_specs=JP("dp", "sp"))(jnp.zeros((4, 4)))


@pytest.mark.parametrize("name", sorted(ATTENTION))
def test_attention(world, name, monkeypatch):
    inp, ranks = world
    m, impl, causal, grads = ATTENTION[name]
    if impl == "flash":
        monkeypatch.setenv("TPUMX_PALLAS", "1")
    mesh = _jmesh(m)
    q, k, v, g = (jnp.asarray(inp[n]) for n in "qkvg")
    if impl == "ring":
        want = ring_attention_sharded(q, k, v, mesh=mesh, causal=causal)
        f = functools.partial(j_ring, axis_name="sp", causal=causal)
    else:
        want = ulysses_attention_sharded(q, k, v, mesh=mesh, causal=causal,
                                         impl=impl)
        f = functools.partial(j_ulysses, axis_name="sp", causal=causal,
                              impl=impl)
    oracle = j_local(q, k, v, causal=causal)
    np.testing.assert_allclose(np.asarray(want), np.asarray(oracle),
                               rtol=1e-4, atol=1e-5)
    for res in ranks:
        np.testing.assert_allclose(res[f"attn_{name}"], np.asarray(want),
                                   **ATTN_TOL)
    if grads:
        spec = JP("dp", "sp") if m == "m22" else JP(None, "sp")
        _, gs = _jvjp(f, mesh, spec, spec, [inp[n] for n in "qkv"],
                      inp["g"])
        for res in ranks:
            for n, want_g in zip("qkv", gs):
                np.testing.assert_allclose(res[f"attn_{name}_d{n}"], want_g,
                                           **ATTN_TOL)


def _j_bn_net(inp):
    net = jgluon.nn.HybridSequential()
    net.add(jgluon.nn.Dense(16, in_units=8), jgluon.nn.BatchNorm(),
            jgluon.nn.Activation("relu"), jgluon.nn.Dense(2, in_units=16))
    net.initialize()
    net(jnd.array(inp["dp_x"][:4]))
    for p, i in zip(net.collect_params().values(), range(8)):
        p.set_data(jnd.array(inp[f"dp_w{i}"]))
    return net


@pytest.mark.parametrize("tag", ["dp_plain", "dp_2bit"])
def test_data_parallel_trainer_over_mesh(world, tag):
    inp, ranks = world
    comp = None if tag == "dp_plain" else {"type": "2bit",
                                           "threshold": THRESHOLD}
    net = _j_bn_net(inp)
    tr = JTrainer(net, jgluon.loss.SoftmaxCrossEntropyLoss(),
                  lr=DP_LR, momentum=DP_MOMENTUM, weight_decay=DP_WD,
                  mesh=_jmesh("d4"), donate=False, compression_params=comp)
    losses, residuals = [], []
    for _ in range(DP_STEPS):
        losses.append(float(tr.step(inp["dp_x"], inp["dp_y"])))
        if comp is not None:
            residuals.append({k: np.asarray(v)
                              for k, v in tr.residuals.items()})
    # the port's order: parameters, then aux state, in creation order (the
    # reference's step returns its dicts sorted)
    created = list(net.collect_params())
    order = [k for k in created if k in tr.params]
    keys = order + [k for k in created if k in tr.aux]
    for res in ranks:
        for s in range(DP_STEPS):
            np.testing.assert_allclose(res[f"{tag}_loss{s}"], losses[s],
                                       **MODEL_TOL)
        for i, key in enumerate(keys):
            np.testing.assert_allclose(res[f"{tag}_p{i}"],
                                       np.asarray({**tr.params,
                                                   **tr.aux}[key]),
                                       **MODEL_TOL, err_msg=key)
    if comp is None:
        return
    # the codes: each rank packed its parameters in creation order; the
    # reference's code of an element is (its compressed input - its new
    # residual) / t, with the port's input standing in for its own
    coded = 0
    for r, res in enumerate(ranks):
        for s in range(DP_STEPS):
            new_res = np.concatenate([residuals[s][k][r].ravel()
                                      for k in order])
            codes = (res[f"{tag}_in{s}"] - new_res) / THRESHOLD
            want = np.rint(codes)
            assert np.abs(codes - want).max() < 0.25, "ambiguous code"
            np.testing.assert_array_equal(res[f"{tag}_dq{s}"] / THRESHOLD,
                                          want)
            coded += int(np.count_nonzero(want))
    assert coded > 0


def test_sharded_train_step(world, monkeypatch):
    inp, ranks = world
    mesh = _jmesh("m22")
    cfg = JConfig(**CFG)
    names = sorted(k[3:] for k in inp if k.startswith("lm_"))
    for impl in SP_IMPLS:
        if impl == "ulysses_flash":
            monkeypatch.setenv("TPUMX_PALLAS", "1")
        step = make_sharded_train_step(mesh, cfg, lr=LM_LR,
                                       momentum=LM_MOMENTUM, sp_impl=impl)
        p = {n: jnp.asarray(inp["lm_" + n]) for n in names}
        m = {n: jnp.zeros_like(v) for n, v in p.items()}
        batch = shard_batch(mesh, inp["tokens"], inp["labels"],
                            np.arange(LM_T, dtype=np.int32))
        losses, m0 = [], None
        for s in range(LM_STEPS):
            loss, p, m = step(p, m, *batch)
            losses.append(float(loss))
            if s == 0:
                m0 = {n: np.asarray(v) for n, v in m.items()}
        for res in ranks:
            for s in range(LM_STEPS):
                np.testing.assert_allclose(res[f"lm_{impl}_loss{s}"],
                                           losses[s], **MODEL_TOL)
            for n in names:
                np.testing.assert_allclose(res[f"lm_{impl}_m0_{n}"], m0[n],
                                           **MODEL_TOL, err_msg=impl + n)
                np.testing.assert_allclose(res[f"lm_{impl}_p_{n}"],
                                           np.asarray(p[n]), **MODEL_TOL,
                                           err_msg=impl + n)


# -- the synced BatchNorm of the plain mesh step, in this process -------------

def test_sync_batch_norm_op_over_mesh(world):
    """``_contrib_SyncBatchNorm`` with ``axis_name="sp"`` over sp=4, each
    rank on its block of the batch: output and input gradient against the
    reference's ``shard_map``, the moments against the whole batch's."""
    from mxnet_tpu.ops.registry import get_op as jget

    inp, ranks = world
    consts = [jnp.asarray(inp[f"sbn_{n}"])
              for n in ("gamma", "beta", "mm", "mv")]

    def f(x):
        return jget("_contrib_SyncBatchNorm").fn(
            x, *consts, eps=1e-3, fix_gamma=False, axis_name="sp",
            _training=True)

    y, (g,) = _jvjp(f, _jmesh("m4"), JP("sp"), JP("sp"), [inp["sbn_x"]],
                    inp["sbn_c"])
    x = inp["sbn_x"].astype(np.float64)
    mean = x.mean(axis=(0, 2, 3))
    var = (x * x).mean(axis=(0, 2, 3)) - mean * mean
    for res in ranks:
        np.testing.assert_allclose(res["sbn_out"], y, **ATTN_TOL)
        np.testing.assert_allclose(res["sbn_dx"], g, rtol=1e-4, atol=1e-5)
        np.testing.assert_allclose(res["sbn_mean"], mean, rtol=1e-5)
        np.testing.assert_allclose(res["sbn_var"], var, rtol=1e-5)


def _bn_case(shape, seed):
    import torch

    r = np.random.RandomState(seed)
    c = shape[-1]
    x = (r.randn(*shape) * 2 + 3).astype(np.float32)
    return (torch.from_numpy(x), torch.from_numpy(r.rand(c).astype(
        np.float32) + 0.5), torch.from_numpy(r.randn(c).astype(np.float32)))


def _bn(x, gamma, beta, axis, sync=None):
    """``BatchNorm``'s training output, batch mean and var, and the
    gradients of x, gamma and beta under a fixed cotangent."""
    import contextlib

    import torch

    from mxnet_tpu_torch.ops import nn as tnn

    leaves = [t.clone().requires_grad_() for t in (x, gamma, beta)]
    scope = tnn.batch_norm_sync(sync) if sync else contextlib.nullcontext()
    with scope:
        out, mean, var = tnn.batch_norm(
            leaves[0], leaves[1], leaves[2], torch.zeros_like(gamma),
            torch.ones_like(gamma), eps=1e-5, fix_gamma=False,
            output_mean_var=True, axis=axis)
        cot = torch.cos(torch.arange(out.numel(), dtype=torch.float32)
                        ).reshape(out.shape)
        grads = torch.autograd.grad((out * cot).sum() + mean.sum()
                                    + var.sum(), leaves)
    return [t.detach() for t in (out, mean, var, *grads)]


@pytest.mark.parametrize("axis", [-1, 1])
def test_batch_norm_sync_at_one_rank(axis):
    """At one rank the synced BatchNorm (Chan's combination over a gather
    of one) is the unsynced one: bit for bit channels-last; channels-first,
    which it moves to channels-last, to f32 rounding."""
    x, gamma, beta = _bn_case((4, 6, 5, 8), 60)
    if axis == 1:
        x = x.movedim(-1, 1).contiguous()
    got = _bn(x, gamma, beta, axis, sync=lambda t: t[None])
    want = _bn(x, gamma, beta, axis)
    for name, a, b in zip(("out", "mean", "var", "dx", "dgamma", "dbeta"),
                          got, want):
        if axis == -1:
            assert np.array_equal(a.numpy(), b.numpy()), name
        else:
            np.testing.assert_allclose(a.numpy(), b.numpy(), rtol=1e-5,
                                       atol=1e-5, err_msg=name)


def test_batch_norm_sync_combines_the_ranks_statistics():
    """Two ranks' blocks: a rank whose gather returns both ranks' (mean,
    var) normalizes its block with the whole batch's statistics."""
    import torch

    x, gamma, beta = _bn_case((8, 3, 5, 16), 61)
    whole = _bn(x, gamma, beta, -1)
    blocks = x.chunk(2)
    stats = [torch.stack(_bn(b, gamma, beta, -1)[1:3]) for b in blocks]
    for r, b in enumerate(blocks):
        out, mean, var = _bn(b, gamma, beta, -1, sync=lambda t, r=r: (
            torch.stack([t if i == r else stats[i] for i in range(2)])))[:3]
        np.testing.assert_allclose(mean.numpy(), whole[1].numpy(),
                                   rtol=1e-5, atol=1e-6)
        np.testing.assert_allclose(var.numpy(), whole[2].numpy(),
                                   rtol=1e-5, atol=1e-6)
        np.testing.assert_allclose(out.numpy(), whole[0].chunk(2)[r].numpy(),
                                   rtol=1e-5, atol=1e-5)
