"""PyTorch port: the symbolic API over several devices — ``Module`` over
dp/mp/pp meshes (``Executor.set_spmd``), ``symbol/staging.py``,
``group2ctx`` placement (``symbol/placement.py``), ``executor_manager.py``
and ``io.shard_data_batch`` — against the JAX package's.

The reference runs in this process over conftest's virtual CPU devices.
The port runs as on cards, one process per device: a module-scoped
fixture starts a gloo world of 4 and one of 2 of ``python -c`` processes
(a ``FileStore`` under the test's temporary directory) that import torch
and the port only, run every scenario on the inputs this file wrote
(numpy from seeds) and save ``.npz`` results; the reference's scenarios
run while they do.

- World of 2: ``Module.fit`` at dp=2 (SGD-momentum with BatchNorm, Adam,
  fp16 AMP with dynamic loss scaling),
  mp=2 storage (each rank's stored blocks equal the reference's shard on
  the same mesh coordinate), a checkpoint saved at mp=2 and resumed at
  dp=2, the indivisible-batch fallback, ``DataParallelExecutorManager``
  and ``shard_data_batch``.
- World of 4: dp=2 x mp=2 tensor-parallel compute (no weight or operand
  gathered for the column/row MLP) and dp=2 x pp=2 on a stage-stackable
  MLP.
- No world: ``plan_pipeline``'s split, ``group2ctx`` forward and backward,
  ``set_spmd``'s refusals and ``_split_input_slice``.

Tolerances: losses rtol 1e-5, parameters and optimizer states rtol 1e-4.
"""
import os
import subprocess
import sys
import time
import types

import jax
import numpy as np
import pytest

import mxnet_tpu as jmx
import mxnet_tpu.parallel.mesh as jmesh
import mxnet_tpu_torch as tmx
from mxnet_tpu.symbol.staging import PlanError as JPlanError
from mxnet_tpu.symbol.staging import plan_pipeline as j_plan
from mxnet_tpu_torch.base import MXNetError
from mxnet_tpu_torch.symbol.staging import PlanError as TPlanError
from mxnet_tpu_torch.symbol.staging import plan_pipeline as t_plan

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
LOSS_TOL = dict(rtol=1e-5, atol=1e-7)
MODEL_TOL = dict(rtol=1e-4, atol=1e-6)
ENVS = ("TPUMX_DP_DEVICES", "TPUMX_MP_DEVICES", "TPUMX_PP_DEVICES",
        "TPUMX_PP_MICROBATCHES", "TPUMX_SHARD_RULES", "TPUMX_MP_COMPUTE",
        "TPUMX_FUSED_STEP", "TPUMX_FUSED_STEP_SPMD", "TPUMX_AMP",
        "TPUMX_AMP_DTYPE", "TPUMX_AMP_LOSS_SCALE")
FP16 = {"TPUMX_AMP": "1", "TPUMX_AMP_DTYPE": "float16",
        "TPUMX_AMP_LOSS_SCALE": "dynamic"}
RULES_ENV = "fc1_weight=mp,-;fc2_weight=-,mp"
SGD = dict(learning_rate=0.5, momentum=0.9)
ADAM = dict(learning_rate=0.01)

# the symbols, built against either package (``sym``, ``name``)
NETS = r'''
def build_net(sym, name, kind):
    with name.NameManager():
        data = sym.Variable("data")
        label = sym.Variable("softmax_label")
        if kind == "deep":
            h = sym.Activation(sym.FullyConnected(data, num_hidden=32,
                                                  name="fc_in"),
                               act_type="relu")
            for i in range(4):
                h = sym.Activation(sym.FullyConnected(
                    h, num_hidden=32, name=f"body{i}"), act_type="relu")
            out = sym.FullyConnected(h, num_hidden=4, name="fc_out")
        else:
            h = sym.FullyConnected(data, num_hidden=32, name="fc1")
            if kind == "bn":
                h = sym.BatchNorm(h, name="bn1")
            h = sym.Activation(h, act_type="relu")
            out = sym.FullyConnected(h, num_hidden=4, name="fc2")
        return sym.SoftmaxOutput(out, label, name="softmax")
'''
exec(NETS)

# (tag, world, env, net, optimizer, optimizer params, batch, samples)
SCENARIOS = (
    ("dp2_sgd_bn", 2, {"TPUMX_DP_DEVICES": "2"}, "bn", "sgd", SGD, 32, 96),
    ("dp2_adam", 2, {"TPUMX_DP_DEVICES": "2"}, "mlp", "adam", ADAM, 32, 96),
    ("mp2", 2, {"TPUMX_MP_DEVICES": "2"}, "bn", "sgd", SGD, 32, 96),
    ("indivisible", 2, {"TPUMX_DP_DEVICES": "2"}, "mlp", "sgd", SGD, 7, 21),
    ("dp2_fp16", 2, dict(FP16, TPUMX_DP_DEVICES="2"), "mlp", "sgd", SGD,
     32, 96),
    ("dp2mp2_compute", 4, {"TPUMX_DP_DEVICES": "2", "TPUMX_MP_DEVICES": "2",
                           "TPUMX_SHARD_RULES": RULES_ENV},
     "mlp", "sgd", SGD, 32, 96),
    ("dp2pp2", 4, {"TPUMX_DP_DEVICES": "2", "TPUMX_PP_DEVICES": "2"},
     "deep", "sgd", SGD, 32, 96),
)
# blocks compared rank by rank: (tag, mesh axes in order)
BLOCKS = {"mp2": ("dp", "mp"), "dp2mp2_compute": ("dp", "mp")}

PRELUDE = r'''
import logging
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
                        timeout=timedelta(seconds=60))

import mxnet_tpu_torch as mx
from mxnet_tpu_torch.base import MXNetError

inp = dict(np.load(out + "/inputs.npz"))
cfg = eval(open(out + "/config.txt").read())
res = {}
warnings = []


class _Keep(logging.Handler):
    def emit(self, record):
        warnings.append(record.getMessage())


logging.getLogger().addHandler(_Keep(level=logging.INFO))
logging.getLogger().setLevel(logging.INFO)
'''

WORKER = PRELUDE + NETS + r'''
import os


def data_iter(batch, n):
    return mx.io.NDArrayIter(inp["X"][:n], inp["Y"][:n], batch_size=batch)


def record(tag, mod, probs, accs, scales=()):
    if scales:
        res[f"{tag}_scaler"] = np.array(scales)
    arg, aux = mod.get_params()
    for k, v in arg.items():
        res[f"{tag}_p_{k}"] = v.asnumpy()
    for k, v in aux.items():
        res[f"{tag}_a_{k}"] = v.asnumpy()
    res[f"{tag}_probs"] = np.stack(probs)
    res[f"{tag}_acc"] = np.array(accs)
    res[f"{tag}_fused"] = np.array(mod._fused_step_count)
    ex = mod._exec
    for k, v in ex.telemetry_snapshot().items():
        res[f"{tag}_tele_{k}"] = np.array(float(v))
    for i, n in enumerate(mod._param_names):
        st = mod._updater.states.get(i) if mod._updater else None
        st = st[0] if isinstance(st, tuple) else st
        if st is not None:
            res[f"{tag}_m_{n}"] = ex.spmd_whole(n, st._data).numpy()
            res[f"{tag}_bm_{n}"] = st._data.numpy()
        res[f"{tag}_bp_{n}"] = ex.arg_dict[n]._data.numpy()


def fit(tag, env, kind, opt, params, batch, n, **kw):
    os.environ.update(env)
    try:
        mod = kw.pop("module", None) or mx.mod.Module(
            build_net(mx.sym, mx.name, kind), context=mx.cpu())
        probs, accs, scales = [], [], []

        def keep(p):
            probs.append(p.locals["self"].get_outputs()[0].asnumpy())
            accs.append(dict(p.eval_metric.get_name_value())["accuracy"])
            sc = p.locals["self"]._loss_scaler
            if sc is not None:
                scales.append((sc.scale_value, sc.good_steps))

        init = {k[len(kind) + 1:]: v for k, v in inp.items()
                if k.startswith(kind + "_")}
        res[f"{tag}_done"] = np.array(mod.fit(
                data_iter(batch, n), num_epoch=kw.pop("num_epoch", 1),
                optimizer=opt, optimizer_params=dict(params),
                kvstore="tpu_sync", batch_end_callback=keep,
                arg_params=kw.pop("arg_params", {
                    k: v for k, v in init.items() if not k.startswith("aux:")}),
                aux_params={k[4:]: v for k, v in init.items()
                            if k.startswith("aux:")} or None, **kw))
        record(tag, mod, probs, accs, scales)
        return mod
    finally:
        for k in env:
            del os.environ[k]


with mx.cpu():
    for tag, w, env, kind, opt, params, batch, n in cfg["scenarios"]:
        if w != world:
            continue
        del warnings[:]
        mod = fit(tag, env, kind, opt, params, batch, n)
        ex = mod._exec
        mesh = ex._spmd_mesh
        res[f"{tag}_mesh"] = np.array(repr(mesh.shape if mesh else None))
        res[f"{tag}_warnings"] = np.array(" | ".join(warnings))
        if ex._spmd_tp is not None:
            res[f"{tag}_gathers"] = np.array(repr(ex.mp_gathers))
        if ex._spmd_pipeline is not None:
            res[f"{tag}_plan"] = np.array(ex._spmd_pipeline[0].describe())
        if tag == "mp2":
            prefix = f"{out}/mp2_rank{rank}"
            mod.save_checkpoint(prefix, 1, save_optimizer_states=True)
            # resumed at dp=2 from the mp=2 files
            env2 = {"TPUMX_DP_DEVICES": "2"}
            os.environ.update(env2)
            try:
                mod2 = mx.mod.Module.load(prefix, 1,
                                          load_optimizer_states=True,
                                          context=mx.cpu())
            finally:
                del os.environ["TPUMX_DP_DEVICES"]
            fit("resume", env2, kind, opt, params, batch, n, module=mod2,
                arg_params=None, begin_epoch=1, num_epoch=2)

    if world == 2:
        # a fault-tolerant fit at mp=2, preempted at step 4 of 6: every
        # rank captures (the blocks gathered), rank 0 writes
        from mxnet_tpu_torch.fault import injector

        os.environ["TPUMX_FAULT_PREEMPT_AT_STEP"] = "4"
        injector().reset()
        del os.environ["TPUMX_FAULT_PREEMPT_AT_STEP"]
        fit("ck_mp2", {"TPUMX_MP_DEVICES": "2"}, "bn", "sgd", cfg["sgd"],
            32, 96,
            num_epoch=2, checkpoint_dir=out + "/ck_mp2", checkpoint_every=2)

        from mxnet_tpu_torch.executor_manager import \
            DataParallelExecutorManager
        from mxnet_tpu_torch.io import shard_data_batch
        from mxnet_tpu_torch.parallel import dp_mesh

        net = build_net(mx.sym, mx.name, "mlp")
        it = data_iter(32, 32)
        em = DataParallelExecutorManager(
            net, [mx.cpu(0), mx.cpu(1)], it, net.list_arguments(),
            [n for n in net.list_arguments()
             if n not in ("data", "softmax_label")],
            net.list_auxiliary_states())
        em.set_params({k[4:]: mx.nd.array(v) for k, v in inp.items()
                       if k.startswith("mlp_")}, {})
        em.load_data_batch(next(iter(it)))
        em.forward(is_train=True)
        em.backward()
        res["em_out"] = em._exec.outputs[0].asnumpy()
        for n, g in zip(em.param_names, em.grad_arrays):
            res[f"em_g_{n}"] = g[0].asnumpy()
        res["em_mesh"] = np.array(repr(em._mesh.shape))
        batch = next(iter(data_iter(32, 32)))
        shard_data_batch(batch, dp_mesh(2))
        res["sdb_data"] = batch.data[0].asnumpy()
        res["sdb_label"] = batch.label[0].asnumpy()
        try:
            shard_data_batch(next(iter(data_iter(7, 7))), dp_mesh(2),
                             strict=True)
            res["sdb_strict"] = np.array("")
        except MXNetError as e:
            res["sdb_strict"] = np.array(str(e))

np.savez(out + f"/rank{rank}.npz", **res)
dist.barrier()
dist.destroy_process_group()
'''


def _start_world(d, world, cfg):
    (d / "config.txt").write_text(repr(cfg))
    env = {k: v for k, v in os.environ.items()
           if not k.startswith(("MXTPU_", "DMLC_", "TPUMX_"))}
    return [subprocess.Popen(
        [sys.executable, "-c", WORKER, str(r), str(world),
         str(d / "store"), str(d), REPO], env=env,
        stdout=subprocess.PIPE, stderr=subprocess.STDOUT)
        for r in range(world)]


def _finish_world(d, procs, timeout=240):
    logs = []
    try:
        for p in procs:
            logs.append(p.communicate(timeout=timeout)[0].decode())
    finally:
        for p in procs:
            if p.poll() is None:
                p.kill()
                p.communicate()
    assert all(p.returncode == 0 for p in procs), "\n----\n".join(logs)
    return [dict(np.load(d / f"rank{r}.npz")) for r in range(len(procs))]


def _inputs():
    r = np.random.RandomState(0)
    Y = r.randint(0, 4, 96).astype(np.float32)
    X = r.rand(96, 8).astype(np.float32) * 0.3
    for c in range(4):
        X[Y == c, c] += 1.0
    inp = {"X": X, "Y": Y}
    for kind in ("mlp", "bn", "deep"):
        net = build_net(jmx.sym, jmx.name, kind)
        shapes, _, aux_shapes = net.infer_shape(data=(32, 8),
                                                softmax_label=(32,))
        for n, s in zip(net.list_arguments(), shapes):
            if n in ("data", "softmax_label"):
                continue
            if n.endswith("gamma"):
                v = 1 + 0.1 * r.randn(*s)
            elif n.endswith(("bias", "beta")):
                v = 0.1 * r.randn(*s)
            else:
                v = r.randn(*s) / np.sqrt(s[-1])
            inp[f"{kind}_{n}"] = v.astype(np.float32)
        for n, s in zip(net.list_auxiliary_states(), aux_shapes):
            v = 0.1 * r.randn(*s) if n.endswith("mean") \
                else 1 + 0.5 * r.rand(*s)
            inp[f"{kind}_aux:{n}"] = v.astype(np.float32)
    return inp


def _ref_fit(mp, inp, tag, env, kind, opt, params, batch, n, **kw):
    for k in ENVS:
        mp.delenv(k, raising=False)
    for k, v in env.items():
        mp.setenv(k, v)
    try:
        jmx.random.seed(0)
        mod = kw.pop("module", None) or jmx.mod.Module(
            build_net(jmx.sym, jmx.name, kind), context=jmx.cpu())
        probs, accs, scales = [], [], []

        def keep(p):
            probs.append(p.locals["self"].get_outputs()[0].asnumpy())
            accs.append(dict(p.eval_metric.get_name_value())["accuracy"])
            sc = p.locals["self"]._loss_scaler
            if sc is not None:
                scales.append((sc.scale_value, sc.good_steps))

        init = {k[len(kind) + 1:]: v for k, v in inp.items()
                if k.startswith(kind + "_")}
        arg = kw.pop("arg_params", {k: jmx.nd.array(v)
                                    for k, v in init.items()
                                    if not k.startswith("aux:")})
        aux = {k[4:]: jmx.nd.array(v) for k, v in init.items()
               if k.startswith("aux:")} or None
        mod.fit(jmx.io.NDArrayIter(inp["X"][:n], inp["Y"][:n],
                                   batch_size=batch),
                num_epoch=kw.pop("num_epoch", 1), optimizer=opt,
                optimizer_params=dict(params), kvstore="tpu_sync",
                batch_end_callback=keep, arg_params=arg, aux_params=aux,
                **kw)
        out = {"fused": mod._fused_step_count, "probs": np.stack(probs),
               "acc": np.array(accs), "scaler": np.array(scales),
               "tele": {k: float(v) for k, v in
                        mod._exec.telemetry_snapshot().items()}}
        a, x = mod.get_params()
        out.update({f"p_{k}": v.asnumpy() for k, v in a.items()})
        out.update({f"a_{k}": v.asnumpy() for k, v in x.items()})
        for i, nm in enumerate(mod._param_names):
            st = mod._updater.states.get(i)
            st = st[0] if isinstance(st, tuple) else st
            if st is not None:
                out[f"m_{nm}"] = np.asarray(st._data)
                out[f"sm_{nm}"] = st._data
            out[f"sp_{nm}"] = mod._exec.arg_dict[nm]._data
        out["mesh"] = mod._exec._spmd_mesh
        return mod, out
    finally:
        for k in ENVS:
            mp.delenv(k, raising=False)


@pytest.fixture(scope="module")
def worlds(tmp_path_factory):
    """Both of the port's worlds started at once, the reference's
    scenarios run meanwhile; (inputs, {world: ranks}, reference)."""
    inp = _inputs()
    dirs = {w: tmp_path_factory.mktemp(f"module_world{w}") for w in (4, 2)}
    procs = {}
    for w, d in dirs.items():
        np.savez(d / "inputs.npz", **inp)
        procs[w] = _start_world(d, w, {"scenarios": SCENARIOS, "sgd": SGD})
    t0 = time.monotonic()
    mp = pytest.MonkeyPatch()
    saved = jmesh.get_mesh()
    ref = {}
    try:
        for tag, _, env, kind, opt, params, batch, n in SCENARIOS:
            mod, ref[tag] = _ref_fit(mp, inp, tag, env, kind, opt, params,
                                     batch, n)
            if tag == "mp2":
                prefix = str(dirs[2] / "ref_mp2")
                mod.save_checkpoint(prefix, 1, save_optimizer_states=True)
                mp.setenv("TPUMX_DP_DEVICES", "2")
                mod2 = jmx.mod.Module.load(prefix, 1,
                                           load_optimizer_states=True,
                                           context=jmx.cpu())
                _, ref["resume"] = _ref_fit(
                    mp, inp, "resume", {"TPUMX_DP_DEVICES": "2"}, kind, opt,
                    params, batch, n, module=mod2, arg_params=None,
                    begin_epoch=1, num_epoch=2)
        _, ref["single_adam"] = _ref_fit(mp, inp, "single_adam", {}, "mlp",
                                         "adam", ADAM, 32, 96)
        _, ref["single_fp16"] = _ref_fit(mp, inp, "single_fp16", FP16,
                                         "mlp", "sgd", SGD, 32, 96)
    finally:
        mp.undo()
        jmesh.set_mesh(saved)
    ranks = {w: _finish_world(dirs[w], procs[w]) for w in (4, 2)}
    ref["seconds"] = time.monotonic() - t0
    return inp, ranks, ref, dirs


def _world_of(tag):
    return next(s[1] for s in SCENARIOS if s[0] == tag)


def _check_fit(ranks, ref, tag, fused=True):
    got = ranks[0]
    np.testing.assert_allclose(got[f"{tag}_probs"], ref[tag]["probs"],
                               err_msg=f"{tag} outputs", **LOSS_TOL)
    np.testing.assert_array_equal(got[f"{tag}_acc"], ref[tag]["acc"])
    assert int(got[f"{tag}_fused"]) == ref[tag]["fused"]
    if fused:
        assert ref[tag]["fused"] == len(ref[tag]["acc"])
    for k in ref[tag]:
        if k.startswith(("p_", "a_", "m_")):
            for r in ranks:
                np.testing.assert_allclose(r[f"{tag}_{k}"], ref[tag][k],
                                           err_msg=f"{tag} {k}", **MODEL_TOL)


@pytest.mark.parametrize("tag", ["dp2_sgd_bn", "dp2_adam"])
def test_fit_dp2(worlds, tag):
    """(a) dp=2 over 3 batches: each batch's outputs (whole on every rank)
    and accuracy, the parameters, running statistics and optimizer states
    after the epoch, on both ranks."""
    _, ranks, ref, _ = worlds
    _check_fit(ranks[2], ref, tag)
    assert str(ranks[2][0][f"{tag}_mesh"]) == "{'dp': 2}"


def test_fit_mp2_storage_blocks(worlds):
    """(b) mp=2 storage: the fit matches, and each rank's stored blocks of
    every parameter and momentum equal the reference's shard on the same
    mesh coordinate."""
    _, ranks, ref, _ = worlds
    _check_fit(ranks[2], ref, "mp2")
    _check_blocks(ranks[2], ref, "mp2")
    assert str(ranks[2][0]["mp2_mesh"]) == "{'dp': 1, 'mp': 2}"


def _check_blocks(ranks, ref, tag):
    mesh = ref[tag]["mesh"]
    sizes = [int(mesh.shape[a]) for a in BLOCKS[tag]]
    for rank, got in enumerate(ranks):
        coord = np.unravel_index(rank, sizes)
        device = mesh.devices[coord]
        for k in ref[tag]:
            if not k.startswith(("sp_", "sm_")):
                continue
            shard = next(s for s in ref[tag][k].addressable_shards
                         if s.device == device)
            key = f"{tag}_b{'p' if k[1] == 'p' else 'm'}_{k[3:]}"
            np.testing.assert_allclose(got[key], np.asarray(shard.data),
                                       err_msg=f"{tag} rank {rank} {k}",
                                       **MODEL_TOL)


def test_fit_dp2_mp2_compute(worlds):
    """(c) dp=2 x mp=2 tensor-parallel compute with column/row rules: the
    fit and the stored blocks match, and no rule-sharded weight nor any
    operand was gathered whole."""
    _, ranks, ref, _ = worlds
    _check_fit(ranks[4], ref, "dp2mp2_compute")
    _check_blocks(ranks[4], ref, "dp2mp2_compute")
    for r in ranks[4]:
        assert str(r["dp2mp2_compute_gathers"]) == \
            "{'weights': {}, 'operands': {}}"


def test_fit_dp2_pp2(worlds):
    """(d) dp=2 x pp=2 on the stage-stackable MLP: the plan the reference
    makes, and the fit matches on every rank."""
    _, ranks, ref, _ = worlds
    _check_fit(ranks[4], ref, "dp2pp2")
    got = ranks[4][0]
    assert str(got["dp2pp2_mesh"]) == "{'dp': 2, 'pp': 2}"
    assert str(got["dp2pp2_plan"]) == \
        "pp plan: 1 prologue ops | 2 stages × 2 units (4 ops/stage) | " \
        "3 epilogue ops"


def test_metrics_match_single_device(worlds):
    """(g) the dp=2 fit's metric per batch equals the single-device
    reference's."""
    _, ranks, ref, _ = worlds
    np.testing.assert_array_equal(ranks[2][0]["dp2_adam_acc"],
                                  ref["single_adam"]["acc"])
    np.testing.assert_allclose(ranks[2][0]["dp2_adam_probs"],
                               ref["single_adam"]["probs"], **LOSS_TOL)


def test_telemetry_dp2_matches_single_device(worlds):
    """(l) the dp=2 fused step's telemetry (norms of the summed gradients
    and the updated parameters, the global batch's loss) equals the
    single-device reference's on both ranks (the reference's
    ``test_telemetry_spmd_matches_single_device``)."""
    _, ranks, ref, _ = worlds
    want = ref["single_adam"]["tele"]
    assert set(want) == {"grad_norm", "param_norm", "loss",
                         "nonfinite_grad_count", "skip_step"}
    for r in ranks[2]:
        for k, v in want.items():
            np.testing.assert_allclose(float(r[f"dp2_adam_tele_{k}"]), v,
                                       err_msg=k, **LOSS_TOL)


def test_checkpoint_mp2_resumes_at_mp1(worlds, tmp_path, monkeypatch):
    """(m) ``fit(checkpoint_dir=...)`` at mp=2 preempted at step 4 of 6
    returns False on both ranks; rank 0's checkpoint holds whole arrays,
    and ``fit(resume=True)`` in this process (one device, no mesh)
    finishes the run to the uninterrupted single-device run's outputs and
    parameters (the reference's ``test_mp2_save_mp1_restore``)."""
    import shutil

    inp, ranks, _, dirs = worlds
    for k in ENVS:
        monkeypatch.delenv(k, raising=False)
    for r in ranks[2]:
        assert bool(r["ck_mp2_done"]) is False
    assert str(ranks[2][0]["mp2_mesh"]) == "{'dp': 1, 'mp': 2}"
    ckdir = str(tmp_path / "ck")
    shutil.copytree(dirs[2] / "ck_mp2", ckdir)
    init = {k[3:]: v for k, v in inp.items() if k.startswith("bn_")}
    arg = {k: v for k, v in init.items() if not k.startswith("aux:")}
    aux = {k[4:]: v for k, v in init.items() if k.startswith("aux:")}
    manager = tmx.checkpoint.CheckpointManager(ckdir)
    assert manager.latest().step == 4
    info, arrays, _ = manager.restore()
    for k, v in arrays["params"].items():
        assert v.shape == arg[k].shape, k
    got = {}
    with tmx.cpu():
        for tag, kw in (("full", {}),
                        ("resumed", dict(checkpoint_dir=ckdir,
                                         resume=True))):
            probs = []
            mod = tmx.mod.Module(build_net(tmx.sym, tmx.name, "bn"),
                                 context=tmx.cpu())
            done = mod.fit(tmx.io.NDArrayIter(inp["X"], inp["Y"],
                                              batch_size=32),
                           num_epoch=2, optimizer="sgd",
                           optimizer_params=dict(SGD), kvstore="tpu_sync",
                           arg_params=arg, aux_params=aux,
                           batch_end_callback=lambda p: probs.append(
                               p.locals["self"].get_outputs()[0].asnumpy()),
                           **kw)
            assert done
            got[tag] = (probs, mod.get_params(), mod._fused_step_count)
    (fp, (fa, fx), fn), (rp, (ra, rx), rn) = got["full"], got["resumed"]
    assert (fn, rn) == (6, 2)
    np.testing.assert_allclose(np.stack(rp), np.stack(fp[4:]), **LOSS_TOL)
    for k in fa:
        np.testing.assert_allclose(ra[k].asnumpy(), fa[k].asnumpy(),
                                   err_msg=k, **MODEL_TOL)
    for k in fx:
        np.testing.assert_allclose(rx[k].asnumpy(), fx[k].asnumpy(),
                                   err_msg=k, **MODEL_TOL)


def test_fit_dp2_fp16_scaler_matches_single_device(worlds, monkeypatch):
    """(k) fp16 AMP with dynamic loss scaling at dp=2: the finite check
    summed over the mesh makes both ranks skip the same steps, so the
    scaler's ``(scale, good_steps)`` after every step equal the port's
    single-device run's and the reference's (dp=2 and single device),
    two overflows and a clean step (an fp16 gradient summed over a
    rank's half batch can stay finite where the whole batch's does not:
    this net and batch are one where it does not); the parameters equal the
    single-device run's within the fp16 tolerance of
    ``tests/test_amp.py`` (rtol 0.08)."""
    inp, ranks, ref, _ = worlds
    for k in ENVS:
        monkeypatch.delenv(k, raising=False)
    for k, v in FP16.items():
        monkeypatch.setenv(k, v)
    init = {k[4:]: v for k, v in inp.items() if k.startswith("mlp_")}
    scales = []
    with tmx.cpu():
        mod = tmx.mod.Module(build_net(tmx.sym, tmx.name, "mlp"),
                             context=tmx.cpu())
        mod.fit(tmx.io.NDArrayIter(inp["X"], inp["Y"], batch_size=32),
                num_epoch=1, optimizer="sgd", optimizer_params=dict(SGD),
                kvstore="tpu_sync", arg_params=init,
                batch_end_callback=lambda p: scales.append(
                    (mod._loss_scaler.scale_value,
                     mod._loss_scaler.good_steps)))
        single = {k: v.asnumpy() for k, v in mod.get_params()[0].items()}
    assert mod._fused_step_count == 3
    scales = [list(map(float, t)) for t in scales]
    for r in ranks[2]:
        assert r["dp2_fp16_scaler"].tolist() == scales \
            == ref["dp2_fp16"]["scaler"].tolist() \
            == ref["single_fp16"]["scaler"].tolist()
        assert int(r["dp2_fp16_fused"]) == 3
        for k, v in single.items():
            got = r[f"dp2_fp16_p_{k}"]
            assert np.isfinite(got).all()
            np.testing.assert_allclose(got, v, rtol=0.08,
                                       atol=0.08 * np.abs(v).max(),
                                       err_msg=k)
    # two overflows backed off, then a clean step
    assert scales == [[16384.0, 0.0], [8192.0, 0.0], [8192.0, 1.0]]
    assert str(ranks[2][0]["dp2_fp16_mesh"]) == "{'dp': 2}"


def test_checkpoint_across_mesh_shapes(worlds):
    """(h) the mp=2 checkpoint files are the reference's arrays, whole;
    loaded at dp=2 with its optimizer states, one more epoch matches the
    reference's same resume."""
    _, ranks, ref, dirs = worlds
    for r in range(2):
        with tmx.cpu():
            _, t_arg, t_aux = tmx.model.load_checkpoint(
                str(dirs[2] / f"mp2_rank{r}"), 1)
        _, j_arg, j_aux = jmx.model.load_checkpoint(
            str(dirs[2] / "ref_mp2"), 1)
        for k in j_arg:
            np.testing.assert_allclose(t_arg[k].asnumpy(), j_arg[k].asnumpy(),
                                       err_msg=k, **MODEL_TOL)
        for k in j_aux:
            np.testing.assert_allclose(t_aux[k].asnumpy(), j_aux[k].asnumpy(),
                                       err_msg=k, **MODEL_TOL)
    _check_fit(ranks[2], ref, "resume")


def test_indivisible_batch_falls_back(worlds):
    """(i) a batch dp=2 does not divide: the mesh is refused with the
    reference's message, logged, and fit takes the legacy route with the
    reference's numbers."""
    _, ranks, ref, _ = worlds
    assert ref["indivisible"]["fused"] == 0
    _check_fit(ranks[2], ref, "indivisible", fused=False)
    assert "not divisible by the dp mesh size 2" in \
        str(ranks[2][0]["indivisible_warnings"])


def test_executor_manager_and_shard_data_batch(worlds):
    """(j) ``DataParallelExecutorManager`` over a dp mesh of 2 gives the
    reference manager's global outputs and gradients on both ranks;
    ``shard_data_batch`` cuts each rank's block, ``strict`` refuses an
    indivisible batch."""
    inp, ranks, _, _ = worlds
    from mxnet_tpu.executor_manager import DataParallelExecutorManager

    net = build_net(jmx.sym, jmx.name, "mlp")
    it = jmx.io.NDArrayIter(inp["X"][:32], inp["Y"][:32], batch_size=32)
    saved = jmesh.get_mesh()
    try:
        em = DataParallelExecutorManager(
            net, [jmx.cpu(0), jmx.cpu(1)], it, net.list_arguments(),
            [n for n in net.list_arguments()
             if n not in ("data", "softmax_label")],
            net.list_auxiliary_states())
        em.set_params({k[4:]: jmx.nd.array(v) for k, v in inp.items()
                       if k.startswith("mlp_")}, {})
        em.load_data_batch(next(iter(it)))
        em.forward(is_train=True)
        em.backward()
    finally:
        jmesh.set_mesh(saved)
    for r, got in enumerate(ranks[2]):
        np.testing.assert_allclose(got["em_out"],
                                   em._exec.outputs[0].asnumpy(), **LOSS_TOL)
        for n, g in zip(em.param_names, em.grad_arrays):
            np.testing.assert_allclose(got[f"em_g_{n}"], g[0].asnumpy(),
                                       err_msg=n, **MODEL_TOL)
        assert str(got["em_mesh"]) == "{'dp': 2}"
        np.testing.assert_array_equal(got["sdb_data"],
                                      inp["X"][16 * r:16 * (r + 1)])
        np.testing.assert_array_equal(got["sdb_label"],
                                      inp["Y"][16 * r:16 * (r + 1)])
        assert "batch size 7 is not divisible by mesh axis 'dp' of size " \
            "2" in str(got["sdb_strict"])


# -- no world ------------------------------------------------------------------

def _struct_of(pkg, shapes):
    if pkg is tmx:
        return {k: types.SimpleNamespace(shape=v, dtype=np.float32)
                for k, v in shapes.items()}
    return {k: jax.ShapeDtypeStruct(v, np.float32) for k, v in shapes.items()}


def _hetero(pkg):
    sym = pkg.sym
    with pkg.name.NameManager():
        data = sym.Variable("data")
        h = sym.Activation(sym.FullyConnected(data, num_hidden=32, name="a"),
                           act_type="relu")
        h = sym.Activation(sym.FullyConnected(h, num_hidden=16, name="b"),
                           act_type="relu")
        out = sym.FullyConnected(h, num_hidden=4, name="c")
        return sym.SoftmaxOutput(out, sym.Variable("softmax_label"),
                                 name="softmax")


def _deep(pkg, layers):
    sym = pkg.sym
    with pkg.name.NameManager():
        data = sym.Variable("data")
        h = sym.Activation(sym.FullyConnected(data, num_hidden=32,
                                              name="fc_in"), act_type="relu")
        for i in range(layers):
            h = sym.Activation(sym.FullyConnected(h, num_hidden=32,
                                                  name=f"body{i}"),
                               act_type="relu")
        out = sym.FullyConnected(h, num_hidden=4, name="fc_out")
        return sym.SoftmaxOutput(out, sym.Variable("softmax_label"),
                                 name="softmax")


PLAN_CASES = {"deep4_s2": (lambda p: _deep(p, 4), 2),
              "deep4_s4": (lambda p: _deep(p, 4), 4),
              "deep6_s2": (lambda p: _deep(p, 6), 2),
              "deep2_s4": (lambda p: _deep(p, 2), 4),
              "hetero_s2": (_hetero, 2),
              "bn_s2": (lambda p: build_net(p.sym, p.name, "bn"), 2)}


@pytest.mark.parametrize("case", sorted(PLAN_CASES))
def test_plan_pipeline_same_split(case):
    """(e) ``plan_pipeline`` describes the same split in both packages, or
    both refuse with the same reason; stage parameters and their gradient
    combination agree."""
    build, S = PLAN_CASES[case]
    out = {}
    for pkg, plan, err in ((tmx, t_plan, TPlanError),
                           (jmx, j_plan, JPlanError)):
        net = build(pkg)
        shapes = dict(zip(net.list_arguments(), net.infer_shape(
            data=(32, 8), softmax_label=(32,))[0]))
        shapes.update(zip(net.list_auxiliary_states(), net.infer_shape(
            data=(32, 8), softmax_label=(32,))[2]))
        try:
            p = plan(net._entries, S, _struct_of(pkg, shapes),
                     input_names=["data", "softmax_label"])
            out[pkg.__name__] = (p.describe(), p.stage_param_names,
                                 sorted(p.param_group.items()),
                                 [p.pp_combine(n) for n in sorted(shapes)])
        except err as e:
            out[pkg.__name__] = ("refused", str(e))
    assert out["mxnet_tpu_torch"] == out["mxnet_tpu"]


def _two_stage(pkg):
    sym = pkg.sym
    with pkg.name.NameManager():
        data = sym.Variable("data")
        with pkg.AttrScope(ctx_group="dev1"):
            a1 = sym.Activation(sym.FullyConnected(data, num_hidden=8,
                                                   name="fc1"),
                                act_type="tanh")
        with pkg.AttrScope(ctx_group="dev2"):
            fc2 = sym.FullyConnected(a1, num_hidden=3, name="fc2")
        return fc2


def test_group2ctx_matches_ungrouped():
    """(f) ``group2ctx``: forward and backward (ones-seeded and with
    explicit head gradients) equal the ungrouped executor's and the
    reference's grouped one; a group missing from ``group2ctx`` raises
    naming it; ``fused_step`` refuses grouped placement."""
    rs = np.random.RandomState(0)
    vals = {"data": rs.rand(4, 6).astype(np.float32),
            "fc1_weight": (rs.rand(8, 6) - 0.5).astype(np.float32),
            "fc1_bias": (rs.rand(8) - 0.5).astype(np.float32),
            "fc2_weight": (rs.rand(3, 8) - 0.5).astype(np.float32),
            "fc2_bias": np.zeros(3, np.float32)}
    ct = rs.rand(4, 3).astype(np.float32)

    def run(pkg, g2c):
        args = {k: pkg.nd.array(v, ctx=pkg.cpu()) for k, v in vals.items()}
        grads = {k: pkg.nd.array(np.zeros_like(v), ctx=pkg.cpu())
                 for k, v in vals.items() if k != "data"}
        exe = _two_stage(pkg).bind(ctx=pkg.cpu(), args=args, args_grad=grads,
                                   group2ctx=g2c)
        out = exe.forward(is_train=True)[0].asnumpy()
        exe.backward()
        g1 = {k: v.asnumpy() for k, v in exe.grad_dict.items()}
        exe.forward(is_train=True)
        exe.backward(out_grads=[pkg.nd.array(ct, ctx=pkg.cpu())])
        g2 = {k: v.asnumpy() for k, v in exe.grad_dict.items()}
        return out, g1, g2, exe

    devs = jax.devices()
    want = run(jmx, {"dev1": devs[0], "dev2": devs[1]})
    plain = run(tmx, None)
    got = run(tmx, {"dev1": tmx.cpu(0), "dev2": tmx.cpu(1)})
    assert got[3]._grouped.num_segments == 2
    for a, b in ((got, plain), (got, want)):
        np.testing.assert_allclose(a[0], b[0], **LOSS_TOL)
        for i in (1, 2):
            for k in b[i]:
                np.testing.assert_allclose(a[i][k], b[i][k], err_msg=k,
                                           **MODEL_TOL)
    with pytest.raises(MXNetError, match="dev2"):
        _two_stage(tmx).simple_bind(ctx=tmx.cpu(), data=(4, 6),
                                    group2ctx={"dev1": tmx.cpu()})
    with pytest.raises(MXNetError, match="group2ctx"):
        got[3].fused_step(tmx.optimizer.create("sgd"), {}, [])


def _fake_mesh(**axes):
    return types.SimpleNamespace(axis_names=tuple(axes), shape=dict(axes),
                                 size=int(np.prod(list(axes.values()))))


SPMD_REFUSALS = {
    "unknown": (dict(batch_args=["nope"]), "unknown batch argument 'nope'"),
    "scalar": (dict(batch_args=["s"]), "batch argument 's' is scalar"),
    "disagree": (dict(batch_args=["data", "odd"]),
                 r"disagree on the leading \(batch\) dimension"),
    "indivisible": (dict(batch_args=["data"], mesh=dict(dp=3)),
                    "batch size 8 not divisible by the dp mesh size 3"),
    "spec_unknown": (dict(batch_args=["data"], param_specs={"x": ("mp",)}),
                     "partition spec for unknown argument 'x'"),
    "spec_batch": (dict(batch_args=["data"], param_specs={"data": ("mp",)}),
                   "'data' is a batch argument"),
    "pp_axis": (dict(batch_args=["data"], pipeline="plan2"),
                "pipeline requires a 'pp' mesh axis"),
    "pp_width": (dict(batch_args=["data"], pipeline="plan2",
                      mesh=dict(dp=2, pp=4)),
                 "plan has 2 stages but the pp axis is 4 wide"),
    "pp_micro": (dict(batch_args=["data"], pipeline="plan2",
                      mesh=dict(dp=2, pp=2), n_micro=3),
                 "local batch 4 not divisible by 3 microbatches"),
}


@pytest.mark.parametrize("case", sorted(SPMD_REFUSALS))
def test_set_spmd_refusals(case):
    """(i) ``set_spmd`` refuses what the reference refuses, with its
    message, in both packages."""
    kw, msg = SPMD_REFUSALS[case]
    kw = dict(kw)
    axes = kw.pop("mesh", dict(dp=2))
    n_micro = kw.pop("n_micro", 2)
    for pkg in (tmx, jmx):
        with pkg.name.NameManager():
            data = pkg.sym.Variable("data")
            net = pkg.sym.Group([
                pkg.sym.FullyConnected(data, num_hidden=4, name="fc"),
                pkg.sym.sum(pkg.sym.Variable("s")),
                pkg.sym.sum(pkg.sym.Variable("odd"))])
        exe = net.simple_bind(ctx=pkg.cpu(), data=(8, 3), s=(), odd=(5,))
        mesh = _fake_mesh(**axes)
        if kw.get("pipeline") == "plan2":
            kw["pipeline"] = (types.SimpleNamespace(n_stages=2), n_micro)
        with pytest.raises(pkg.base.MXNetError, match=msg):
            exe.set_spmd(mesh, **kw)


@pytest.mark.parametrize("loads", [[1.0, 1.0], [1.0, 3.0], [2.0, 1.0, 1.0],
                                   [0.5, 0.5, 0.5, 0.5]])
def test_split_input_slice(loads):
    """(j) ``_split_input_slice`` cuts as the reference's."""
    from mxnet_tpu.executor_manager import _split_input_slice as j_split
    from mxnet_tpu_torch.executor_manager import \
        _split_input_slice as t_split

    assert t_split(10, loads) == j_split(10, loads)
    with pytest.raises(MXNetError, match="invalid"):
        t_split(10, [0.0, 0.0])
