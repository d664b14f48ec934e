"""PyTorch port: model parallelism — partition rules, the partitioned LM
step (storage and compute routes), the GPipe pipeline, Switch MoE, the
per-head sharded paged attention and model-parallel serving — against the
JAX package's.

The reference runs in this process over conftest's virtual CPU devices.
The port runs as on cards, one process per device: module-scoped
fixtures start gloo worlds of ``python -c`` processes (a ``FileStore``
under the test's temporary directory) that import torch and the port
only, run their scenarios on the inputs this file wrote (numpy from
seeds) and save ``.npz`` results.

- Rules: the reference's own cases and the GPT-2 spec tree at mp 2, 4, 8
  give equal outputs in both packages (no world needed).
- World of 4: ``make_partitioned_train_step`` at (dp, mp) = (1, 4) and
  (2, 2), both routes, three f32 steps: losses rtol 1e-5, each rank's
  stored blocks equal the reference's addressable shard on the same mesh
  coordinate and ``gather_fn`` gives the reference's whole params and
  momenta (rtol 1e-4); ``pipeline_apply_sharded`` at pp 4 and 2 and
  ``moe_apply_sharded`` at ep 4, outputs and gradients rtol 1e-5;
  ``paged_attention_sharded`` at mp 2 and 4, float and int8, against the
  reference's (its Pallas kernels interpreted) and bitwise the port's
  unsharded call.
- World of 2: ``GenerationService(mp_devices=2)`` under the reference's
  default config (preemption, prefix cache; float and int8 pools), greedy
  tokens equal to the reference's ``mp_devices=2`` service and to the
  port's mp=1 service; a follower's ``submit`` is refused.  In the same
  world: speculative decode (n-gram and draft model) and multi-step
  decode at k=4, greedy and sampled, and a three-head model on the dense
  gather route, each against the reference's mp=2 service and the port's
  mp=1 service.  A second
  world of 2 whose follower fails mid-run: both processes end, in bounded
  time, with errors.
"""
import os
import subprocess
import sys
import threading
import time
import types

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from jax import lax
from jax.sharding import Mesh as JMesh, PartitionSpec as JP

import mxnet_tpu.parallel.mesh as jmesh
from mxnet_tpu import observability as obs
from mxnet_tpu.parallel import moe as jmoe
from mxnet_tpu.parallel import partition_rules as jpr
from mxnet_tpu.parallel import transformer as jt
from mxnet_tpu.parallel.collectives import shard_map_compat as j_shard_map
from mxnet_tpu.parallel.pipeline import (pipeline_apply as j_pipeline,
                                         pipeline_apply_sharded as j_pipe_sh,
                                         psum_bcast as j_psum_bcast)
from mxnet_tpu.ops import paged_attention as jpa
from mxnet_tpu.serving import generation as jg
from mxnet_tpu_torch.base import MXNetError
from mxnet_tpu_torch.ops import paged_attention as tpa
from mxnet_tpu_torch.parallel import moe as tmoe
from mxnet_tpu_torch.parallel import partition_rules as tpr
from mxnet_tpu_torch.parallel import transformer as tt
from mxnet_tpu_torch.serving import generation as tg

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
LOSS_TOL = dict(rtol=1e-5, atol=0)
MODEL_TOL = dict(rtol=1e-4, atol=1e-6)
OP_TOL = dict(rtol=1e-5, atol=1e-6)
CFG = dict(vocab=64, d_model=32, n_heads=4, n_layers=2, d_ff=64, max_len=32)
LM_B, LM_T, LM_STEPS, LM_LR, LM_MOMENTUM = 4, 16, 3, 0.1, 0.9
LAYOUTS = ((1, 4), (2, 2))
ROUTES = ("compute", "storage")
PIPE = dict(S4=(4, 8, 2, 8), S2=(2, 6, 3, 8))    # stages, M, b, d
MOE_B, MOE_D, MOE_CF = 32, 16, 4.0
PA_H, PA_D, PA_BS, PA_NB, PA_W = 4, 8, 4, 16, 5
DIMS = dict(vocab=61, d_model=32, n_heads=4, n_layers=2, d_ff=64,
            max_len=64)
DEFAULTS = dict(max_slots=3, block_size=4, num_blocks=14, seq_buckets=[8, 16],
                max_new_tokens=6)

PRELUDE = r'''
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
cfgs = eval(open(out + "/config.txt").read())
res = {}
T = torch.tensor
'''

WORKER = PRELUDE + r'''
from mxnet_tpu_torch.ops.paged_attention import (paged_attention,
                                                 paged_attention_sharded)
from mxnet_tpu_torch.parallel import make_mesh
from mxnet_tpu_torch.parallel.collectives import spmd
from mxnet_tpu_torch.parallel.mesh import shard, sharding_for
from mxnet_tpu_torch.parallel.moe import moe_apply_sharded
from mxnet_tpu_torch.parallel.partition_rules import max_bytes_per_device
from mxnet_tpu_torch.parallel.pipeline import (pipeline_apply,
                                               pipeline_apply_sharded,
                                               psum_bcast)
from mxnet_tpu_torch.parallel.transformer import (
    TransformerConfig, make_partitioned_train_step)

with mx.cpu():
    # the partitioned LM step
    cfg = TransformerConfig(**cfgs["lm_cfg"])
    names = sorted(k[3:] for k in inp if k.startswith("lm_"))
    whole = {n: inp["lm_" + n] for n in names}
    for dp, mp in cfgs["layouts"]:
        mesh = make_mesh(dp=dp, mp=mp, install=False)
        data = sharding_for(mesh, "dp")
        tokens, labels = (shard(inp[n], data) for n in ("tokens", "labels"))
        pos = torch.arange(inp["tokens"].shape[1])
        for route in cfgs["routes"]:
            tag = f"lm{dp}{mp}_{route}"
            step, shard_fn, gather_fn = make_partitioned_train_step(
                mesh, cfg, lr=cfgs["lr"], momentum=cfgs["momentum"],
                mp_compute=route == "compute")
            p = shard_fn(whole)
            m = shard_fn({n: np.zeros_like(v) for n, v in whole.items()})
            for s in range(cfgs["steps"]):
                loss, p, m = step(p, m, tokens, labels, pos)
                res[f"{tag}_loss{s}"] = loss.numpy()
            gp, gm = gather_fn(p), gather_fn(m)
            for n in names:
                res[f"{tag}_bp_{n}"], res[f"{tag}_bm_{n}"] = \
                    p[n].numpy(), m[n].numpy()
                res[f"{tag}_gp_{n}"], res[f"{tag}_gm_{n}"] = \
                    gp[n].numpy(), gm[n].numpy()
            res[f"{tag}_bytes"] = np.array(max_bytes_per_device([p, m]))

    # the pipeline: pp=4 alone, and pp=2 beside dp=2
    stage = lambda w, x: torch.tanh(x @ w)  # noqa: E731
    for tag, axes in (("S4", {"pp": 4}), ("S2", {"dp": 2, "pp": 2})):
        mesh = make_mesh(axes, install=False)
        W, X, C = (T(inp[f"pipe_{tag}_{n}"]) for n in "wxc")
        Wg, Xg = W.clone().requires_grad_(), X.clone().requires_grad_()
        y = pipeline_apply_sharded(stage, Wg, Xg, mesh=mesh)
        gw, gx = torch.autograd.grad((y * C).sum(), [Wg, Xg])
        res[f"pipe_{tag}_y"], res[f"pipe_{tag}_gw"], res[f"pipe_{tag}_gx"] = \
            y.detach().numpy(), gw.numpy(), gx.numpy()
        # the contract inside SPMD: this stage's params as the leaf
        with spmd(mesh):
            me = mesh.axis_index("pp")
            mine = W[me].clone().requires_grad_()
            y = psum_bcast(pipeline_apply(stage, mine, X, "pp"), "pp")
            res[f"pipe_{tag}_gmine"] = torch.autograd.grad(
                (y * C).sum(), mine)[0].numpy()

    # Switch MoE over ep=4
    mesh = make_mesh(ep=4, install=False)
    expert = lambda w, x: torch.tanh(x @ w)  # noqa: E731
    x, rw, ew = (T(inp[n]).requires_grad_() for n in ("moe_x", "moe_rw",
                                                        "moe_ew"))
    y = moe_apply_sharded(x, rw, ew, expert, mesh=mesh,
                          capacity_factor=cfgs["moe_cf"])
    res["moe_y"] = y.detach().numpy()
    for n, g in zip(("x", "rw", "ew"), torch.autograd.grad(
            (y * T(inp["moe_c"])).sum(), [x, rw, ew])):
        res[f"moe_g{n}"] = g.numpy()
    res["moe_drop_y"] = moe_apply_sharded(
        T(inp["moe_x"]), T(inp["moe_rw_biased"]), T(inp["moe_ew"]), expert,
        mesh=mesh, capacity_factor=0.5).numpy()

    # paged attention per head over mp=2 (beside dp=2) and mp=4
    for tag, axes in (("mp2", {"dp": 2, "mp": 2}), ("mp4", {"mp": 4})):
        mesh = make_mesh(axes, install=False)
        for case in ("float", "int8"):
            a = {n: T(inp[f"pa_{case}_{n}"]) for n in (
                "q", "k", "v", "tables", "pos", "max_pos")}
            sc = {}
            if case == "int8":
                sc = {"k_scale": T(inp["pa_int8_ks"]),
                      "v_scale": T(inp["pa_int8_vs"])}
            res[f"pa_{tag}_{case}"] = paged_attention_sharded(
                a["q"], a["k"], a["v"], a["tables"], a["pos"],
                a["max_pos"], mesh, **sc).numpy()
        try:
            paged_attention_sharded(
                T(np.zeros((1, 1, 6, 8), np.float32)),
                T(np.zeros((2, 4, 6, 8), np.float32)),
                T(np.zeros((2, 4, 6, 8), np.float32)),
                T(np.ones((1, 1), np.int32)), T(np.zeros((1, 1), np.int32)),
                T(np.zeros(1, np.int32)), make_mesh(mp=4, install=False))
            res["pa_indivisible_refused"] = np.array(False)
        except MXNetError:
            res["pa_indivisible_refused"] = np.array(True)

np.savez(out + f"/rank{rank}.npz", **res)
dist.barrier()
dist.destroy_process_group()
'''

SERVE = PRELUDE + r'''
import threading

from mxnet_tpu_torch.parallel.transformer import TransformerConfig
from mxnet_tpu_torch.serving import generation as tg

cfg = TransformerConfig(**cfgs["dims"])
params = {k[2:]: v for k, v in inp.items() if k.startswith("p_")}
prompts = [inp[f"prompt{i}"] for i in range(cfgs["n_prompts"])]
with mx.cpu():
    for kv in (None, "int8"):
        tag = kv or "float"
        svc = tg.GenerationService(
            params, cfg, tg.GenerationConfig(mp_devices=2, kv_dtype=kv,
                                             **cfgs["gen"]),
            start=False, device="cpu")
        res[f"{tag}_pool_bytes"] = np.array(svc._cache.nbytes())
        if rank == 0:
            # each wave admitted once it is wholly queued
            queued = threading.Event()
            admit = svc._admit_locked
            svc._admit_locked = lambda: admit() if queued.is_set() else []
            svc.start()
            outs = []
            for wave in cfgs["waves"]:
                queued.clear()
                hs = [svc.submit(prompts[i], temperature=0.0) for i in wave]
                queued.set()
                outs += [h.result(timeout=120) for h in hs]
            st = svc.stats()
            res[f"{tag}_tokens"] = np.array(outs)
            for k in cfgs["counts"]:
                res[f"{tag}_{k}"] = np.array(st["counts"][k])
            res[f"{tag}_stats_keys"] = np.array(sorted(st))
            res[f"{tag}_signatures"] = np.array(
                sorted(map(repr, svc.compile_stats())))
        else:
            try:
                svc.submit(prompts[0])
                res["follower_submit_refused"] = np.array("")
            except MXNetError as e:
                res["follower_submit_refused"] = np.array(str(e))
        svc.stop()

    # speculative (n-gram, draft model) and multi-step decode, and the
    # dense gather route: greedy then sampled waves
    for tag, pre, dims, gen, draft in cfgs["modes"]:
        mcfg = TransformerConfig(**dims)
        mp_ = {k[len(pre):]: v for k, v in inp.items() if k.startswith(pre)}
        extra = dict(draft_params=mp_, draft_cfg=mcfg) if draft else {}
        svc = tg.GenerationService(
            mp_, mcfg, tg.GenerationConfig(mp_devices=2, **gen),
            start=False, device="cpu", **extra)
        res[f"{tag}_kernel"] = np.array(svc._programs.kernel)
        res[f"{tag}_pool_bytes"] = np.array(svc._cache.nbytes())
        ms, real = [], svc._programs._multistep

        def rec(*a, _real=real, **k):
            toks = _real(*a, **k)
            ms.append(toks.numpy().copy())
            return toks

        svc._programs._multistep = rec
        if rank == 0:
            queued = threading.Event()
            admit = svc._admit_locked
            svc._admit_locked = lambda: admit() if queued.is_set() else []
            svc.start()
            outs = []
            for sampled in (False, True):
                queued.clear()
                hs = [svc.submit(inp[f"m{pre}prompt{i}"],
                                 **(dict(temperature=0.9, top_k=10,
                                         top_p=0.95, seed=100 + i)
                                    if sampled else dict(temperature=0.0)))
                      for i in range(cfgs["n_mode_prompts"])]
                queued.set()
                outs += [h.result(timeout=120) for h in hs]
            st = svc.stats()
            res[f"{tag}_tokens"] = np.array(outs)
            res[f"{tag}_counts"] = np.array(
                [st["counts"][k] for k in cfgs["mode_counts"]])
            res[f"{tag}_signatures"] = np.array(
                sorted(map(repr, svc.compile_stats())))
        svc.stop()
        res[f"{tag}_ms"] = np.concatenate(
            [m.reshape(-1) for m in ms] or [np.zeros(0, np.int64)])
        res[f"{tag}_ms_n"] = np.array(len(ms))

np.savez(out + f"/rank{rank}.npz", **res)
dist.barrier()
dist.destroy_process_group()
'''

FAIL = PRELUDE + r'''
from mxnet_tpu_torch.parallel.transformer import TransformerConfig
from mxnet_tpu_torch.serving import ServingError
from mxnet_tpu_torch.serving import generation as tg

cfg = TransformerConfig(**cfgs["dims"])
params = {k[2:]: v for k, v in inp.items() if k.startswith("p_")}
t0 = __import__("time").monotonic()
with mx.cpu():
    svc = tg.GenerationService(
        params, cfg, tg.GenerationConfig(mp_devices=2, **cfgs["gen"]),
        device="cpu")
    if rank == 1:
        real, calls = svc._programs._step, []

        def step(*a, **k):
            calls.append(1)
            if len(calls) == 3:
                raise RuntimeError("injected follower failure")
            return real(*a, **k)

        svc._programs._step = step
        try:
            svc.stop()
            res["outcome"] = np.array("stopped")
        except MXNetError as e:
            res["outcome"] = np.array("raised: " + str(e))
    else:
        hs = [svc.submit(inp[f"prompt{i}"]) for i in range(3)]
        errors = []
        for h in hs:
            try:
                h.result(timeout=90)
            except ServingError as e:
                errors.append(str(e))
        res["outcome"] = np.array(f"{len(errors)} failed: {errors[:1]}")
        svc.stop()
res["seconds"] = np.array(__import__("time").monotonic() - t0)
np.savez(out + f"/rank{rank}.npz", **res)
'''


def _run_world(d, script, world, cfg, timeout=150):
    (d / "config.txt").write_text(repr(cfg))
    env = {k: v for k, v in os.environ.items()
           if not k.startswith(("MXTPU_", "DMLC_", "TPUMX_"))}
    t0 = time.monotonic()
    procs = [subprocess.Popen(
        [sys.executable, "-c", script, str(r), str(world),
         str(d / "store"), str(d), REPO], env=env,
        stdout=subprocess.PIPE, stderr=subprocess.STDOUT)
        for r in range(world)]
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
    return [dict(np.load(d / f"rank{r}.npz")) for r in range(world)], \
        time.monotonic() - t0


def _pipe_inputs(r, tag):
    S, M, b, d = PIPE[tag]
    return {f"pipe_{tag}_w": (r.randn(S, d, d) * 0.3).astype(np.float32),
            f"pipe_{tag}_x": r.rand(M, b, d).astype(np.float32),
            f"pipe_{tag}_c": r.randn(M, b, d).astype(np.float32)}


def _pa_case(r, T, int8):
    q = r.randn(3, T, PA_H, PA_D).astype(np.float32)
    if int8:
        k = r.randint(-127, 128, (PA_NB, PA_BS, PA_H, PA_D)).astype(np.int8)
        v = r.randint(-127, 128, (PA_NB, PA_BS, PA_H, PA_D)).astype(np.int8)
    else:
        k = r.randn(PA_NB, PA_BS, PA_H, PA_D).astype(np.float32)
        v = r.randn(PA_NB, PA_BS, PA_H, PA_D).astype(np.float32)
    tables = np.array([[3, 7, 1, 0, 0], [2, 9, 0, 5, 11], [4, 6, 8, 0, 0]],
                      np.int32)
    start = np.array([9 - T + 1 if T > 1 else 9, 19 - T + 1, 0])
    lengths = np.array([T if T == 1 else T - 2, T, 0])
    pos = (start[:, None] + np.arange(T)[None, :]).astype(np.int32)
    valid = np.arange(T)[None, :] < lengths[:, None]
    max_pos = np.where(valid, pos, -1).max(axis=1).astype(np.int32)
    return dict(q=q, k=k, v=v, tables=tables, pos=pos, max_pos=max_pos,
                lengths=lengths)


def _inputs():
    r = np.random.RandomState(0)
    inp = {}
    params = jt.transformer_lm_init(jt.TransformerConfig(**CFG),
                                    jax.random.PRNGKey(0))
    for k, v in params.items():
        inp["lm_" + k] = np.asarray(v)
    inp["tokens"] = r.randint(0, CFG["vocab"], (LM_B, LM_T)).astype(np.int32)
    inp["labels"] = np.roll(inp["tokens"], -1, 1)
    for tag in PIPE:
        inp.update(_pipe_inputs(r, tag))
    inp["moe_x"] = r.randn(MOE_B, MOE_D).astype(np.float32)
    inp["moe_rw"] = r.randn(MOE_D, 4).astype(np.float32)
    inp["moe_ew"] = (r.randn(4, MOE_D, MOE_D) * 0.3).astype(np.float32)
    inp["moe_c"] = r.randn(MOE_B, MOE_D).astype(np.float32)
    biased = np.zeros((MOE_D, 4), np.float32)
    biased[:, 0] = 10.0
    inp["moe_rw_biased"] = biased
    for case, T in (("float", 8), ("int8", 1)):
        c = _pa_case(r, T, case == "int8")
        for n in ("q", "k", "v", "tables", "pos", "max_pos", "lengths"):
            inp[f"pa_{case}_{n}"] = c[n]
    inp["pa_int8_ks"] = (r.rand(PA_NB, PA_H) * 0.05 + 0.001).astype(
        np.float32)
    inp["pa_int8_vs"] = (r.rand(PA_NB, PA_H) * 0.05 + 0.001).astype(
        np.float32)
    return inp


@pytest.fixture(scope="module")
def world(tmp_path_factory):
    """The port's gloo world of 4, once; every rank's results."""
    d = tmp_path_factory.mktemp("mp_world")
    inp = _inputs()
    np.savez(d / "inputs.npz", **inp)
    ranks, _ = _run_world(d, WORKER, 4, {
        "lm_cfg": CFG, "layouts": LAYOUTS, "routes": ROUTES, "lr": LM_LR,
        "momentum": LM_MOMENTUM, "steps": LM_STEPS, "moe_cf": MOE_CF})
    return inp, ranks


@pytest.fixture(autouse=True)
def _ambient_mesh():
    """The reference's meshes are built uninstalled; keep its ambient one."""
    saved = jmesh.get_mesh()
    yield
    jmesh.set_mesh(saved)
    obs.recompile.reset()


# -- the rule functions ------------------------------------------------------------

def _fake_mesh(**axes):
    return types.SimpleNamespace(axis_names=tuple(axes), shape=dict(axes))


RULE_CASES = {
    "first_match": lambda pr, m: pr.match_partition_rules(
        ((r"fc1_weight", ("mp", None)), (r"fc1_.*", ("mp",)),
         (r".*_bias", (None,))),
        {"fc1_weight": (32, 8), "fc1_bias": (32,), "fc2_weight": (4, 32)}),
    "scalars": lambda pr, m: pr.match_partition_rules(
        ((r".*", ("mp",)),), {"s": (), "one": (1,), "v": (8,)}),
    "fallback": lambda pr, m: [
        pr.resolve_spec(s, shape, m) for s, shape in (
            (("mp",), (7,)), (("mp", None), (7, 8)), ((None, "mp"), (7, 8)),
            (("nope",), (8,)), ((("dp", "mp"),), (6,)),
            ((("dp", "mp"),), (8, 2)))],
    "fsdp": lambda pr, m: [pr.resolve_spec(pr.FSDP, s, m)
                           for s in ((4, 6), (7, 6), (7, 7))],
    "omits_trivial": lambda pr, m: pr.make_param_specs(
        ((r".*", pr.FSDP),), {"w": (8, 4), "odd": (7,)}, m),
    "spec_forms": lambda pr, m: [
        (pr.spec_tuple(s), pr.spec_str(s))
        for s in (None, pr.FSDP, ("mp", None), (("dp", "mp"), None), ())],
    "env_rules": lambda pr, m: (
        pr.rules_from_env(r".*_weight=mp,-;emb=dp+mp,-;.*=fsdp"),
        pr.rules_from_env(""), pr.rules_from_env(" a=- ; b=mp, - ")),
    "partitionable": lambda pr, m: (
        pr.rules_compute_partitionable(((r"w", ("mp",)),)),
        pr.rules_compute_partitionable(((r"w", ("mp",)), (r".*", pr.FSDP))),
        pr.rules_compute_partitionable(None)),
}


@pytest.mark.parametrize("name", sorted(RULE_CASES))
def test_rule_functions_match_reference(name):
    m = _fake_mesh(dp=2, mp=2)
    assert RULE_CASES[name](tpr, m) == RULE_CASES[name](jpr, m)


def test_rule_refusals_and_gates(monkeypatch):
    m = _fake_mesh(dp=2, mp=2)
    rules = ((r"w$", (None, "tp")),)
    for pr in (tpr, jpr):
        with pytest.raises(ValueError, match="regex=spec"):
            pr.rules_from_env("no-equals-sign-here;")
        pr.validate_rule_axes(((r"w$", ("mp",)), (r".*", pr.FSDP)), m)
    with pytest.raises(MXNetError, match="'tp'"):
        tpr.validate_rule_axes(rules, m)
    for v, want in ((None, True), ("0", False), ("1", True)):
        if v is None:
            monkeypatch.delenv("TPUMX_MP_COMPUTE", raising=False)
        else:
            monkeypatch.setenv("TPUMX_MP_COMPUTE", v)
        assert tpr.mp_compute_enabled() == jpr.mp_compute_enabled() == want
    monkeypatch.setenv("TPUMX_SHARD_RULES", "wqkv$=-,mp;.*=fsdp")
    assert tpr.rules_from_env() == jpr.rules_from_env()


@pytest.mark.parametrize("mp", [2, 4, 8])
def test_gpt2_spec_tree(mp):
    """The transformer rules over GPT-2's parameter tree (shapes only),
    and the MoE rules, resolve alike at each mp."""
    cfg = dict(vocab=50257, d_model=768, n_heads=12, n_layers=12,
               d_ff=3072, max_len=1024)
    shapes = tt.param_shapes(tt.TransformerConfig(**cfg))
    ref_shapes = jax.eval_shape(lambda: jt.transformer_lm_init(
        jt.TransformerConfig(**cfg), jax.random.PRNGKey(0)))
    assert shapes == {k: tuple(v.shape) for k, v in ref_shapes.items()}
    m = _fake_mesh(dp=1, mp=mp)
    got = tpr.make_param_specs(tt.transformer_partition_rules(), shapes, m)
    assert got == jpr.make_param_specs(jt.transformer_partition_rules(),
                                       shapes, m)
    assert got["l0_wqkv"] == (None, "mp") and got["l0_wo"] == ("mp",)
    moe_shapes = {"router_w": (768, mp), "expert_w_in": (mp, 768, 3072),
                  "expert_w_out": (mp, 3072, 768)}
    assert tpr.make_param_specs(tmoe.moe_partition_rules("mp"), moe_shapes,
                                m) == jpr.make_param_specs(
        jmoe.moe_partition_rules("mp"), moe_shapes, m)


# -- the partitioned LM step -----------------------------------------------------

@pytest.mark.parametrize("route", ROUTES)
@pytest.mark.parametrize("layout", LAYOUTS, ids=["dp1mp4", "dp2mp2"])
def test_partitioned_train_step(world, layout, route):
    inp, ranks = world
    dp, mp = layout
    mesh = jmesh.make_mesh(dp=dp, mp=mp, install=False)
    step, shard_fn, gather_fn = jt.make_partitioned_train_step(
        mesh, jt.TransformerConfig(**CFG), lr=LM_LR, momentum=LM_MOMENTUM,
        mp_compute=route == "compute")
    names = sorted(k[3:] for k in inp if k.startswith("lm_"))
    p = shard_fn({n: jnp.asarray(inp["lm_" + n]) for n in names})
    m = shard_fn({n: jnp.zeros_like(inp["lm_" + n]) for n in names})
    tokens = jax.device_put(inp["tokens"], jax.sharding.NamedSharding(
        mesh, JP("dp")))
    labels = jax.device_put(inp["labels"], jax.sharding.NamedSharding(
        mesh, JP("dp")))
    losses = []
    for _ in range(LM_STEPS):
        loss, p, m = step(p, m, tokens, labels, jnp.arange(LM_T))
        losses.append(float(loss))
    tag = f"lm{dp}{mp}_{route}"
    rank_of = {d: i for i, d in enumerate(mesh.devices.flat)}
    whole = sum(v.size * 8 for v in p.values())   # params + momenta, f32
    for r, res in enumerate(ranks):
        for s in range(LM_STEPS):
            np.testing.assert_allclose(res[f"{tag}_loss{s}"], losses[s],
                                       **LOSS_TOL)
        for n in names:
            for kind, tree in (("p", p), ("m", m)):
                np.testing.assert_allclose(
                    res[f"{tag}_g{kind}_{n}"], np.asarray(tree[n]),
                    **MODEL_TOL, err_msg=f"gathered {kind} {n}")
                shard = next(s for s in tree[n].addressable_shards
                             if rank_of[s.device] == r)
                np.testing.assert_allclose(
                    res[f"{tag}_b{kind}_{n}"], np.asarray(shard.data),
                    **MODEL_TOL, err_msg=f"rank {r}'s block of {kind} {n}")
        # every rule-sharded leaf is stored 1/mp a rank
        assert res[f"{tag}_bytes"] < whole / mp * 1.3


# -- pipeline and MoE -----------------------------------------------------------

def _stage(w, x):
    return jnp.tanh(x @ w)


@pytest.mark.parametrize("tag", sorted(PIPE))
def test_pipeline_apply_sharded(world, tag):
    """Outputs against the reference's host entry and the sequential
    stack; the in-SPMD contract (this stage's gradient with psum_bcast's
    identity backward) against the reference's inside shard_map; the host
    entry's gradients against the sequential stack's.  (The reference's
    host entry differentiated from outside gives 1/S of them: its
    replicated output's transpose under ``check=False``.)"""
    inp, ranks = world
    S, M, b, d = PIPE[tag]
    W, X, C = (jnp.asarray(inp[f"pipe_{tag}_{n}"]) for n in "wxc")
    mesh = JMesh(np.asarray(jax.devices()[:S]), ("pp",))
    want = np.asarray(j_pipe_sh(_stage, W, X, mesh=mesh))

    def oracle(W, X):
        x = X
        for s in range(S):
            x = _stage(W[s], x)
        return jnp.sum(x * C), x

    (_, seq), (gw, gx) = jax.value_and_grad(oracle, (0, 1),
                                            has_aux=True)(W, X)
    np.testing.assert_allclose(want, np.asarray(seq), **OP_TOL)

    def inner(W, X, C):
        mine = lax.dynamic_index_in_dim(W, lax.axis_index("pp"),
                                        keepdims=False)
        g = jax.grad(lambda w: jnp.sum(j_psum_bcast(
            j_pipeline(_stage, w, X, "pp"), "pp") * C))(mine)
        return lax.all_gather(g, "pp", axis=0, tiled=False)

    g_mine = np.asarray(jax.jit(j_shard_map(
        inner, mesh=mesh, in_specs=(JP(), JP(), JP()), out_specs=JP(),
        check=False))(W, X, C))
    np.testing.assert_allclose(g_mine, np.asarray(gw), **OP_TOL)
    for res in ranks:
        np.testing.assert_allclose(res[f"pipe_{tag}_y"], want, **OP_TOL)
        np.testing.assert_allclose(res[f"pipe_{tag}_gw"], np.asarray(gw),
                                   **OP_TOL)
        np.testing.assert_allclose(res[f"pipe_{tag}_gx"], np.asarray(gx),
                                   **OP_TOL)
    pp_rank = [r % S for r in range(len(ranks))] if tag == "S2" \
        else list(range(len(ranks)))
    for res, s in zip(ranks, pp_rank):
        np.testing.assert_allclose(res[f"pipe_{tag}_gmine"], g_mine[s],
                                   **OP_TOL)


def _expert(w, x):
    return jnp.tanh(x @ w)


def test_moe_apply_sharded(world):
    inp, ranks = world
    mesh = JMesh(np.asarray(jax.devices()[:4]), ("ep",))
    x, rw, ew, c = (jnp.asarray(inp[n]) for n in ("moe_x", "moe_rw",
                                                    "moe_ew", "moe_c"))

    def f(x, rw, ew):
        y = jmoe.moe_apply_sharded(x, rw, ew, _expert, mesh=mesh,
                                   capacity_factor=MOE_CF)
        return jnp.sum(y * c), y

    (_, y), grads = jax.value_and_grad(f, (0, 1, 2), has_aux=True)(x, rw, ew)
    drop = np.asarray(jmoe.moe_apply_sharded(
        x, jnp.asarray(inp["moe_rw_biased"]), ew, _expert, mesh=mesh,
        capacity_factor=0.5))
    zero_rows = (np.abs(drop).max(axis=1) == 0).sum()
    assert 0 < zero_rows < MOE_B
    for res in ranks:
        np.testing.assert_allclose(res["moe_y"], np.asarray(y), **OP_TOL)
        for n, g in zip(("x", "rw", "ew"), grads):
            np.testing.assert_allclose(res[f"moe_g{n}"], np.asarray(g),
                                       **OP_TOL, err_msg=n)
        np.testing.assert_allclose(res["moe_drop_y"], drop, **OP_TOL)
        # over-capacity tokens come out exactly zero, the same rows
        np.testing.assert_array_equal(
            np.abs(res["moe_drop_y"]).max(axis=1) == 0,
            np.abs(drop).max(axis=1) == 0)


def test_top1_routing_int32_positions():
    """Slots past 256 tokens stay distinct (an f32/bf16 cumsum would
    collide them in bf16): the dispatch against the reference's."""
    rs = np.random.RandomState(3)
    x = rs.randn(600, 8).astype(np.float32)
    rw = np.zeros((8, 2), np.float32)
    rw[:, 0] = 5.0
    got = [t.numpy() for t in tmoe.top1_routing(
        torch.from_numpy(x), torch.from_numpy(rw), 2, 400)]
    want = [np.asarray(t) for t in jmoe.top1_routing(
        jnp.asarray(x), jnp.asarray(rw), 2, 400)]
    np.testing.assert_array_equal(got[0], want[0])
    np.testing.assert_allclose(got[1], want[1], **OP_TOL)
    assert (got[0].sum(axis=2) <= 1).all()


# -- per-head paged attention ----------------------------------------------------

@pytest.mark.parametrize("tag", ["mp2", "mp4"])
@pytest.mark.parametrize("case", ["float", "int8"])
def test_paged_attention_sharded(world, tag, case):
    inp, ranks = world
    a = {n: inp[f"pa_{case}_{n}"] for n in ("q", "k", "v", "tables", "pos",
                                             "max_pos", "lengths")}
    sc = {}
    if case == "int8":
        sc = {"k_scale": inp["pa_int8_ks"], "v_scale": inp["pa_int8_vs"]}
    n = 2 if tag == "mp2" else 4
    mesh = jmesh.make_mesh(mp=n, install=False)
    want = np.asarray(jpa.paged_attention_sharded(
        *(jnp.asarray(a[k]) for k in ("q", "k", "v", "tables", "pos",
                                      "max_pos")), mesh,
        **{k: jnp.asarray(v) for k, v in sc.items()}))
    whole = tpa.paged_attention(
        *(torch.from_numpy(a[k]) for k in ("q", "k", "v", "tables", "pos",
                                           "max_pos")),
        **{k: torch.from_numpy(v) for k, v in sc.items()}).numpy()
    for res in ranks:
        got = res[f"pa_{tag}_{case}"]
        np.testing.assert_array_equal(got, whole)
        for b in range(2):
            L = a["lengths"][b]
            np.testing.assert_allclose(got[b, :L], want[b, :L], **OP_TOL)
        assert not got[2].any() and not want[2].any()
        assert res["pa_indivisible_refused"]


def test_paged_attention_sharded_indivisible_refused():
    with pytest.raises(MXNetError, match="not divisible"):
        tpa.paged_attention_sharded(
            torch.zeros(1, 1, 6, 8), torch.zeros(2, 4, 6, 8),
            torch.zeros(2, 4, 6, 8), torch.ones(1, 1, dtype=torch.int32),
            torch.zeros(1, 1, dtype=torch.int32),
            torch.zeros(1, dtype=torch.int32), _fake_mesh(mp=4))


# -- model-parallel serving -------------------------------------------------------

N_PROMPTS = 6
WAVES = [[0, 1, 2], [3, 4, 5]]
COUNTS = ("preempted", "prefix_hits", "cached_tokens", "cow_copies")
# multi-token decode: 16-position blocks and prompts of at most 9 tokens,
# so a first multi-token step after admission stays inside the block the
# reference's admission secured (its tests' failure, ROADMAP Queue 3)
SPEC_GEN = dict(max_slots=3, block_size=16, num_blocks=16,
                seq_buckets=[16, 32], max_new_tokens=8, prefix_cache=False)
MODES = {
    "ngram": dict(SPEC_GEN, speculative=True, draft_k=4),
    "model": dict(SPEC_GEN, speculative=True, draft_mode="model",
                  draft_k=3, draft_window=32),
    "multistep": dict(SPEC_GEN, multistep_k=4),
}
# three heads do not split over mp=2: the dense gather route
GATHER_DIMS = dict(vocab=61, d_model=24, n_heads=3, n_layers=2, d_ff=64,
                   max_len=64)
MODE_COUNTS = ("spec_steps", "multistep_steps", "draft_proposed",
               "draft_accepted", "preempted", "prefix_hits")
N_MODE_PROMPTS = 3


def _serve_inputs():
    pj = jt.transformer_lm_init(jt.TransformerConfig(**DIMS),
                                jax.random.PRNGKey(1))
    inp = {"p_" + k: np.asarray(v) for k, v in pj.items()}
    rs = np.random.RandomState(5)
    shared = rs.randint(0, DIMS["vocab"], 8)
    for i, n in enumerate((5, 13, 11, 16, 9, 3)):
        p = rs.randint(0, DIMS["vocab"], n)
        if i % 2:  # block-aligned shared prefixes: prefix hits
            p[:8] = shared[:min(8, n)] if n >= 8 else p[:8]
        inp[f"prompt{i}"] = p.astype(np.int64)
    # repetitive prompts, so the n-gram proposer fires
    for i, p in enumerate((([1, 2, 3, 4] * 3)[:9], [7, 8, 9] * 2 + [7],
                           [3, 1, 4, 1, 3, 1, 4])):
        inp[f"mp_prompt{i}"] = np.array(p, np.int64)
    gj = jt.transformer_lm_init(jt.TransformerConfig(**GATHER_DIMS),
                                jax.random.PRNGKey(2))
    inp.update({"g_" + k: np.asarray(v) for k, v in gj.items()})
    for i in range(N_MODE_PROMPTS):
        inp[f"mg_prompt{i}"] = inp[f"prompt{2 * i + 1}"]
    return pj, inp


def _modes():
    """(tag, parameter prefix, dims, generation config, draft) of the
    multi-token and gather-route runs."""
    out = [(tag, "p_", DIMS, gen, tag == "model")
           for tag, gen in MODES.items()]
    out.append(("gather", "g_", GATHER_DIMS, DEFAULTS, False))
    return out


@pytest.fixture(scope="module")
def serving(tmp_path_factory):
    d = tmp_path_factory.mktemp("mp_serving")
    pj, inp = _serve_inputs()
    np.savez(d / "inputs.npz", **inp)
    ranks, _ = _run_world(d, SERVE, 2, {
        "dims": DIMS, "gen": DEFAULTS, "n_prompts": N_PROMPTS,
        "waves": WAVES, "counts": COUNTS, "modes": _modes(),
        "n_mode_prompts": N_MODE_PROMPTS, "mode_counts": MODE_COUNTS})
    return pj, inp, ranks


def _serve_waves(svc, inp, monkeypatch):
    queued = threading.Event()
    admit = svc._admit_locked
    monkeypatch.setattr(svc, "_admit_locked",
                        lambda: admit() if queued.is_set() else [])
    try:
        svc.start()
        outs = []
        for wave in WAVES:
            queued.clear()
            hs = [svc.submit(inp[f"prompt{i}"], temperature=0.0)
                  for i in wave]
            queued.set()
            outs += [h.result(timeout=300) for h in hs]
        return outs, svc.stats(), svc.compile_stats()
    finally:
        svc.stop()


@pytest.mark.parametrize("kv", [None, "int8"])
def test_model_parallel_serving(serving, kv, monkeypatch):
    """Greedy tokens of the port's mp=2 service (rank 0) equal the
    reference's mp=2 service's and the port's mp=1 service's, under the
    reference's default config; the scheduling counts agree; each rank
    holds half the pool."""
    pj, inp, ranks = serving
    tag = kv or "float"
    gen = dict(DEFAULTS, kv_dtype=kv)
    want, sj, _ = _serve_waves(jg.GenerationService(
        pj, jt.TransformerConfig(**DIMS),
        jg.GenerationConfig(mp_devices=2, **gen), start=False), inp,
        monkeypatch)
    one, s1, sig1 = _serve_waves(tg.GenerationService(
        {k[2:]: v for k, v in inp.items() if k.startswith("p_")},
        tt.TransformerConfig(**DIMS), tg.GenerationConfig(**gen),
        start=False, device="cpu"), inp, monkeypatch)
    got = ranks[0][f"{tag}_tokens"].tolist()
    assert got == want == one
    for k in COUNTS:
        assert int(ranks[0][f"{tag}_{k}"]) == sj["counts"][k] \
            == s1["counts"][k], k
    assert sj["counts"]["prefix_hits"] > 0
    # rank 0's stats keys and signatures are the single-device service's
    assert ranks[0][f"{tag}_stats_keys"].tolist() == sorted(s1)
    assert ranks[0][f"{tag}_signatures"].tolist() == sorted(
        map(repr, sig1))
    # half of the mp=1 pool a rank
    whole = tg.kv_cache.PagedKVCache(
        DIMS["n_layers"], DIMS["n_heads"], DIMS["d_model"] // DIMS["n_heads"],
        DEFAULTS["num_blocks"], DEFAULTS["block_size"], kv_dtype=kv,
        device="cpu").nbytes()
    for res in ranks:
        assert int(res[f"{tag}_pool_bytes"]) * 2 == whole
    assert "rank 0" in str(ranks[1]["follower_submit_refused"])


def _serve_modes(svc, inp, pre, monkeypatch):
    """The world's mode runs in this process: a greedy wave, then a
    sampled one, each admitted once wholly queued."""
    queued = threading.Event()
    admit = svc._admit_locked
    monkeypatch.setattr(svc, "_admit_locked",
                        lambda: admit() if queued.is_set() else [])
    try:
        svc.start()
        outs = []
        for sampled in (False, True):
            queued.clear()
            hs = [svc.submit(inp[f"m{pre}prompt{i}"],
                             **(dict(temperature=0.9, top_k=10, top_p=0.95,
                                     seed=100 + i)
                                if sampled else dict(temperature=0.0)))
                  for i in range(N_MODE_PROMPTS)]
            queued.set()
            outs += [h.result(timeout=300) for h in hs]
        return outs, svc.stats(), svc.compile_stats()
    finally:
        svc.stop()


def _mode_services(tag, inp):
    _, pre, dims, gen, draft = next(m for m in _modes() if m[0] == tag)
    pj = {k[len(pre):]: v for k, v in inp.items() if k.startswith(pre)}
    jcfg, tcfg = jt.TransformerConfig(**dims), tt.TransformerConfig(**dims)
    jx = dict(draft_params=pj, draft_cfg=jcfg) if draft else {}
    tx = dict(draft_params=pj, draft_cfg=tcfg) if draft else {}
    ref = jg.GenerationService(pj, jcfg, jg.GenerationConfig(
        mp_devices=2, **gen), start=False, **jx)
    one = tg.GenerationService(pj, tcfg, tg.GenerationConfig(**gen),
                               start=False, device="cpu", **tx)
    return pre, ref, one


@pytest.mark.parametrize("tag", list(MODES))
def test_model_parallel_multi_token_decode(serving, tag, monkeypatch):
    """Speculative decode (n-gram and draft-model proposers) and
    multi-step decode at k=4 under mp=2: greedy and sampled tokens equal
    the reference's mp=2 service's and the port's mp=1 service's; the
    spec and multi-step step counts and the draft counts agree; each
    multi-step command drew the same tokens on both ranks (every rank
    samples)."""
    _, inp, ranks = serving
    pre, ref, one = _mode_services(tag, inp)
    want, sj, _ = _serve_modes(ref, inp, pre, monkeypatch)
    got1, s1, sig1 = _serve_modes(one, inp, pre, monkeypatch)
    got = ranks[0][f"{tag}_tokens"].tolist()
    assert got == want == got1
    counts = dict(zip(MODE_COUNTS, ranks[0][f"{tag}_counts"].tolist()))
    for k in MODE_COUNTS:
        assert counts[k] == s1["counts"][k], k
    assert counts["spec_steps"] == (sj["speculative"] or {}).get(
        "spec_steps", 0)
    assert counts["multistep_steps"] == sj["multistep"]["steps"]
    assert counts["draft_accepted"] == (sj["speculative"] or {}).get(
        "accepted_tokens", 0)
    if tag == "multistep":
        assert counts["multistep_steps"] >= 1
        assert int(ranks[0][f"{tag}_ms_n"]) == int(ranks[1][f"{tag}_ms_n"]) \
            == counts["multistep_steps"]
        assert ranks[0][f"{tag}_ms"].size > 0
        np.testing.assert_array_equal(ranks[0][f"{tag}_ms"],
                                      ranks[1][f"{tag}_ms"])
    else:
        assert counts["spec_steps"] >= 1 and counts["draft_proposed"] >= 1
    # the leader's signatures are the single-device service's
    assert ranks[0][f"{tag}_signatures"].tolist() == sorted(
        map(repr, sig1))
    for r in ranks:
        assert str(r[f"{tag}_kernel"]) == "paged"


def test_model_parallel_serving_gather_route(serving, monkeypatch):
    """Three heads over mp=2 (formerly refused): the dense gather route,
    under the reference's default config — greedy and sampled tokens
    equal the reference's mp=2 service's and the port's mp=1 service's,
    the leader's signatures (sites without ``_paged``, keys without a
    kernel component) are the reference's, and every rank holds the
    whole pool."""
    _, inp, ranks = serving
    pre, ref, one = _mode_services("gather", inp)
    assert ref.stats()["decode_kernel"] == "gather"
    want, _, sigj = _serve_modes(ref, inp, pre, monkeypatch)
    got1, _, _ = _serve_modes(one, inp, pre, monkeypatch)
    got = ranks[0]["gather_tokens"].tolist()
    assert got == want
    np.testing.assert_array_equal(got[:N_MODE_PROMPTS],
                                  got1[:N_MODE_PROMPTS])
    assert got == got1
    assert ranks[0]["gather_signatures"].tolist() == sorted(
        map(repr, sigj))
    whole = one._cache.nbytes()
    for r in ranks:
        assert str(r["gather_kernel"]) == "gather"
        assert int(r["gather_pool_bytes"]) == whole


def test_model_parallel_follower_failure_ends_every_rank(tmp_path):
    """A follower whose step raises: it leaves with an error from
    ``stop()``, and rank 0's requests fail (its collective ends when the
    follower's process does) — both well inside the world's timeout."""
    _, inp = _serve_inputs()
    np.savez(tmp_path / "inputs.npz", **inp)
    ranks, _ = _run_world(tmp_path, FAIL, 2, {
        "dims": DIMS, "gen": dict(DEFAULTS, prefix_cache=False)})
    assert str(ranks[1]["outcome"]).startswith("raised: "), ranks[1]
    assert "injected follower failure" in str(ranks[1]["outcome"])
    assert str(ranks[0]["outcome"]).startswith("3 failed"), ranks[0]
    assert "model-parallel group failed" in str(ranks[0]["outcome"])
    # inside the groups' 60 s timeout: no rank sat out a collective's
    assert max(float(r["seconds"]) for r in ranks) < 50
