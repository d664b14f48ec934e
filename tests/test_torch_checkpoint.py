"""PyTorch port: fault-tolerant training (``checkpoint/``, ``fit``'s
``checkpoint_dir``/``resume``, preemption, ``io.fast_forward``) against the
JAX package's.

The same numpy initial parameters and batches go through both packages'
``Module.fit``: a preemption (a real SIGTERM raised by the
``TPUMX_FAULT_PREEMPT_AT_STEP`` injection) at step 7 of 20 writes a final
synchronous checkpoint and ``fit`` returns False; a fresh module resumes
with ``resume=True``.  The port's resumed per-batch outputs and final
parameters equal its own uninterrupted run bit for bit, and the
reference's within rtol 1e-5.  A checkpoint directory either package
writes restores in the other, and the two packages write the same files
for the same state (the npz contents and key order, the optimizer-state
pickle byte for byte, the manifest apart from its timestamp).  Under fp16
AMP the reference comparison takes the fp16 tolerance of
``tests/test_torch_amp.py`` (rtol 0.08): the two packages' fp16 rounding
differs; the loss scaler's restored state is exact.  The
manager's retention, corrupt-checkpoint fallback (``truncate``, ``flip``),
atomic async commit, the ``TPUMX_FAULT_CKPT_CORRUPT`` hook, the metrics
and spans are checked as the reference's ``tests/test_fault_tolerance.py``
checks them.
"""
import json
import os
import pickle
import shutil

import numpy as np
import pytest
import torch

import mxnet_tpu as jmx
import mxnet_tpu_torch as tmx
from mxnet_tpu.checkpoint import CheckpointManager as JManager
from mxnet_tpu.fault import injector as jinjector
from mxnet_tpu_torch import observability as tobs
from mxnet_tpu_torch.checkpoint import CheckpointManager
from mxnet_tpu_torch.fault import corrupt_checkpoint
from mxnet_tpu_torch.fault import injector as tinjector

REF_TOL = dict(rtol=1e-5, atol=1e-6)
# fp16 arithmetic rounds differently under XLA:CPU and torch: the port's
# fp16 fits are held to the reference's within the tolerance of
# tests/test_torch_amp.py's fp16 cases (rtol 0.08); the port's own resumed
# run stays bitwise its uninterrupted one, and the scaler's state exact
# (and, as there, an absolute floor of rtol x the array's largest value)
FP16_TOL = dict(rtol=0.08, atol=None)
FAULT_ENVS = ("TPUMX_FAULT_PREEMPT_AT_STEP", "TPUMX_FAULT_CKPT_CORRUPT",
              "TPUMX_AMP", "TPUMX_AMP_DTYPE", "TPUMX_AMP_LOSS_SCALE")
FP16 = {"TPUMX_AMP": "1", "TPUMX_AMP_DTYPE": "float16",
        "TPUMX_AMP_LOSS_SCALE": "dynamic"}
# (optimizer, its parameters, extra env, preemption step, cadence)
CASES = {
    "sgd_momentum": ("sgd", (("learning_rate", 0.1), ("momentum", 0.9)), {},
                     7, 3),
    "adam": ("adam", (("learning_rate", 0.05),), {}, 7, 3),
    "adam_fp16": ("adam", (("learning_rate", 0.05),), FP16, 13, 4),
}


def _ref_tol(case):
    return FP16_TOL if CASES[case][2] else REF_TOL


def _close(got, want, tol, err_msg=""):
    got, want = np.asarray(got), np.asarray(want)
    atol = tol["atol"]
    if atol is None:
        atol = tol["rtol"] * max(1e-3, float(np.abs(want).max()))
    np.testing.assert_allclose(got, want, rtol=tol["rtol"], atol=atol,
                               err_msg=err_msg)


@pytest.fixture(autouse=True)
def _clean_faults(monkeypatch):
    for k in FAULT_ENVS:
        monkeypatch.delenv(k, raising=False)
    jinjector().reset()
    tinjector().reset()
    yield
    monkeypatch.undo()
    jinjector().reset()
    tinjector().reset()


def _mlp(pkg):
    sym = pkg.sym
    with pkg.name.NameManager():
        data = sym.Variable("data")
        label = sym.Variable("softmax_label")
        h = sym.Activation(sym.FullyConnected(data, num_hidden=16,
                                              name="fc1"), act_type="relu")
        out = sym.FullyConnected(h, num_hidden=4, name="fc2")
        return sym.SoftmaxOutput(out, label, name="softmax")


def _data():
    r = np.random.RandomState(0)
    Y = r.randint(0, 4, 320).astype(np.float32)
    X = r.rand(320, 8).astype(np.float32) * 0.3
    for c in range(4):
        X[Y == c, c] += 1.0
    init = {"fc1_weight": (r.randn(16, 8) * 0.3).astype(np.float32),
            "fc1_bias": (r.randn(16) * 0.1).astype(np.float32),
            "fc2_weight": (r.randn(4, 16) * 0.3).astype(np.float32),
            "fc2_bias": (r.randn(4) * 0.1).astype(np.float32)}
    return X, Y, init


def _fit(pkg, case, mp, ckdir=None, preempt=False, resume=False):
    """One ``Module.fit`` of ``case`` in ``pkg`` with its variables set
    through the MonkeyPatch ``mp``: (completed, per-batch outputs, final
    parameters, module)."""
    opt, params, env, step, cadence = CASES[case]
    for k in FAULT_ENVS:
        mp.delenv(k, raising=False)
    for k, v in env.items():
        mp.setenv(k, v)
    if preempt:
        mp.setenv("TPUMX_FAULT_PREEMPT_AT_STEP", str(step))
    try:
        (jinjector if pkg is jmx else tinjector)().reset()
        pkg.random.seed(0)
        X, Y, init = _data()
        outs = []

        def keep(p):
            outs.append(p.locals["self"].get_outputs()[0].asnumpy().copy())

        mod = pkg.mod.Module(_mlp(pkg), context=pkg.cpu())
        done = mod.fit(pkg.io.NDArrayIter(X, Y, batch_size=32),
                       num_epoch=2, optimizer=opt, optimizer_params=params,
                       arg_params={k: pkg.nd.array(v)
                                   for k, v in init.items()},
                       batch_end_callback=keep, checkpoint_dir=ckdir,
                       checkpoint_every=cadence, resume=resume)
        arg, _ = mod.get_params()
        return done, outs, {k: v.asnumpy() for k, v in arg.items()}, mod
    finally:
        for k in FAULT_ENVS:
            mp.delenv(k, raising=False)


def _port_fit(*a, **kw):
    with tmx.cpu():
        return _fit(tmx, *a, **kw)


@pytest.fixture(scope="module")
def ref_runs(tmp_path_factory):
    """Per case, the reference's uninterrupted run, its preempted run's
    checkpoint directory and its resumed run (in a copy: the directory
    stays as the preemption left it)."""
    runs = {}
    mp = pytest.MonkeyPatch()
    try:
        for case in CASES:
            d = tmp_path_factory.mktemp(f"ref_{case}")
            full = _fit(jmx, case, mp)
            pre = _fit(jmx, case, mp, str(d / "ck"), preempt=True)
            shutil.copytree(d / "ck", d / "ck_resumed")
            res = _fit(jmx, case, mp, str(d / "ck_resumed"), resume=True)
            runs[case] = {"full": full, "pre": pre, "res": res,
                          "dir": str(d / "ck")}
    finally:
        mp.undo()
        jinjector().reset()
    return runs


def _steps(ckdir):
    return sorted(int(d.rsplit("-", 1)[1]) for d in os.listdir(ckdir)
                  if d.startswith("ckpt-"))


# -- the manager --------------------------------------------------------------
def test_manager_save_latest_retention(tmp_path):
    for pkg_dir, make in (("port", CheckpointManager), ("ref", JManager)):
        m = make(str(tmp_path / pkg_dir), keep=2)
        for step in (1, 2, 3, 4):
            m.save({"params": {"w": np.full((4,), step, np.float32)}},
                   {0: (np.ones(3, np.float32),)},
                   {"epoch": 0, "nbatch": step, "global_step": step},
                   step=step, blocking=True)
    port, ref = (CheckpointManager(str(tmp_path / d)) for d in ("port",
                                                                 "ref"))
    assert _steps(port.directory) == _steps(ref.directory) == [3, 4]
    assert port.latest().step == 4
    info, arrays, opt = port.restore()
    assert info.step == 4 and info.meta["nbatch"] == 4
    np.testing.assert_array_equal(arrays["params"]["w"],
                                  np.full((4,), 4, np.float32))
    np.testing.assert_array_equal(opt[0][0], np.ones(3, np.float32))
    # the same bytes for the same content (timestamps aside)
    for name in ("opt_state.pkl",):
        a, b = (open(os.path.join(m.directory, "ckpt-0000000004", name),
                     "rb").read() for m in (port, ref))
        assert a == b
    ma, mb = (json.load(open(os.path.join(m.directory, "ckpt-0000000004",
                                          "manifest.json")))
              for m in (port, ref))
    ma.pop("saved_unix"), mb.pop("saved_unix")
    for f in ("params.npz",):
        ma["files"][f].pop("sha256"), mb["files"][f].pop("sha256")
    assert ma == mb


@pytest.mark.parametrize("mode", ["flip", "truncate"])
def test_corrupt_newest_falls_back_to_previous(tmp_path, mode):
    m = CheckpointManager(str(tmp_path), keep=3)
    for step in (1, 2):
        m.save({"params": {"w": np.full((4,), step, np.float32)}},
               None, {"global_step": step}, step=step, blocking=True)
    before = tobs.snapshot()["counters"].get(
        "checkpoint_restore_fallbacks_total", 0)
    corrupt_checkpoint(os.path.join(str(tmp_path), "ckpt-0000000002"), mode)
    info, arrays, _ = m.restore()
    assert info.step == 1
    np.testing.assert_array_equal(arrays["params"]["w"],
                                  np.full((4,), 1, np.float32))
    assert tobs.snapshot()["counters"][
        "checkpoint_restore_fallbacks_total"] == before + 1
    # the reference falls back past the same corruption
    assert JManager(str(tmp_path)).latest().step == 1


def test_async_save_commits_and_is_atomic(tmp_path):
    failures0 = tobs.snapshot()["counters"].get(
        "checkpoint_save_failures_total", 0)
    m = CheckpointManager(str(tmp_path), keep=3)
    w = torch.arange(1024, dtype=torch.float32)
    m.save({"params": {"w": w.clone()}}, None, {"global_step": 5}, step=5,
           blocking=False)
    assert m.wait(timeout=30)
    entries = os.listdir(tmp_path)
    assert "ckpt-0000000005" in entries
    assert not [e for e in entries if e.startswith(".tmp-")]
    assert m.validate(os.path.join(str(tmp_path), "ckpt-0000000005"))
    assert tobs.snapshot()["counters"].get(
        "checkpoint_save_failures_total", 0) == failures0
    assert [h[:3] for h in m.history] == [
        ("async", m.history[0][1], m.history[0][2])]
    np.testing.assert_array_equal(
        JManager(str(tmp_path)).restore()[1]["params"]["w"], w.numpy())


def test_injected_ckpt_corruption_env(tmp_path, monkeypatch):
    """``TPUMX_FAULT_CKPT_CORRUPT=truncate@2`` corrupts exactly the second
    commit."""
    monkeypatch.setenv("TPUMX_FAULT_CKPT_CORRUPT", "truncate@2")
    tinjector().reset()
    m = CheckpointManager(str(tmp_path), keep=3)
    for step in (1, 2):
        m.save({"params": {"w": np.full((8,), step, np.float32)}},
               None, {"global_step": step}, step=step, blocking=True)
    assert m.validate(os.path.join(str(tmp_path), "ckpt-0000000001"))
    assert m.validate(os.path.join(str(tmp_path), "ckpt-0000000002")) is None
    assert m.latest().step == 1


def test_checkpoint_metrics_and_spans_recorded(tmp_path):
    tobs.tracing.clear()
    trace = tobs.tracing.new_trace()
    m = CheckpointManager(str(tmp_path), keep=2)
    with tobs.use_context(trace):
        m.save({"params": {"w": np.ones((16,), np.float32)}}, None,
               {"global_step": 1}, step=1, blocking=True)
        m.save({"params": {"w": np.ones((16,), np.float32)}}, None,
               {"global_step": 2}, step=2, blocking=False)
        m.wait(30)
        m.restore()
    snap = tobs.snapshot()
    counters, hists = snap["counters"], snap["histograms"]
    assert counters.get('checkpoint_saves_total{mode="sync"}', 0) >= 1
    assert counters.get('checkpoint_saves_total{mode="async"}', 0) >= 1
    assert counters.get("checkpoint_save_bytes_total", 0) > 0
    assert counters.get("checkpoint_restores_total", 0) >= 1
    assert any(k.startswith("checkpoint_save_seconds") for k in hists)
    assert any(k.startswith("checkpoint_restore_seconds") for k in hists)
    assert snap["gauges"].get("checkpoint_last_step") == 2
    if tobs.tracing.enabled():
        names = {s["name"] for s in tobs.recent_spans(trace.trace_id)}
        # the async writer's span joins the submitting trace
        assert {"checkpoint.save_sync", "checkpoint.save_async",
                "checkpoint.restore"} <= names


# -- preempt and resume --------------------------------------------------------
@pytest.mark.parametrize("case", list(CASES))
def test_preempt_resume_parity(tmp_path, monkeypatch, ref_runs, case):
    """Preemption at step 7 (13 under fp16) of 20: a final synchronous
    checkpoint at that step, fit returns False; the resumed fit's
    per-batch outputs and final parameters equal the port's uninterrupted
    run bitwise and the reference's within rtol 1e-5; under fp16 the loss
    scaler's state is restored exactly."""
    step = CASES[case][3]
    mp = monkeypatch
    done, full_outs, full, full_mod = _port_fit(case, mp)
    assert done and len(full_outs) == 20
    ckdir = str(tmp_path / "ck")
    done, pre_outs, _, pre_mod = _port_fit(case, mp, ckdir, preempt=True)
    assert done is False
    assert max(_steps(ckdir)) == step
    final_meta = CheckpointManager(ckdir).latest().meta
    for a, b in zip(pre_outs, full_outs):
        np.testing.assert_array_equal(a, b)
    done, res_outs, res, mod = _port_fit(case, mp, ckdir, resume=True)
    assert done and mod._fused_step_count == 20 - step
    for a, b in zip(res_outs, full_outs[step:]):
        np.testing.assert_array_equal(a, b)
    for k in full:
        np.testing.assert_array_equal(res[k], full[k], err_msg=k)
    ref, tol = ref_runs[case], _ref_tol(case)
    assert ref["pre"][0] is False and ref["res"][0]
    _close(np.stack(res_outs), np.stack(ref["res"][1]), tol)
    _close(np.stack(full_outs), np.stack(ref["full"][1]), tol)
    for k in full:
        _close(res[k], ref["res"][2][k], tol, k)
    if CASES[case][2]:
        sc_full, sc_res = full_mod._loss_scaler, mod._loss_scaler
        assert sc_res is not None
        assert (sc_res.scale_value, sc_res.good_steps) == \
            (sc_full.scale_value, sc_full.good_steps)
        assert (sc_res.scale_value, sc_res.good_steps) == \
            (ref["res"][3]._loss_scaler.scale_value,
             ref["res"][3]._loss_scaler.good_steps)
        assert final_meta["scaler"] == [float(v) for v in
                                        pre_mod._loss_scaler.state()]


@pytest.mark.parametrize("case", ["sgd_momentum", "adam_fp16"])
def test_cross_package_restore(tmp_path, monkeypatch, ref_runs, case):
    """A checkpoint directory the reference wrote resumes in the port to
    the reference's own resumed outputs; one the port wrote resumes in the
    reference to the port's; the two packages' preemption checkpoints hold
    the same arrays, optimizer-state pickle bytes and metadata."""
    step = CASES[case][3]
    ref, tol = ref_runs[case], _ref_tol(case)
    ref_dir = str(tmp_path / "from_ref")
    shutil.copytree(ref["dir"], ref_dir)
    mp = monkeypatch
    done, outs, params, _ = _port_fit(case, mp, ref_dir, resume=True)
    assert done
    _close(np.stack(outs), np.stack(ref["res"][1]), tol)
    for k in params:
        _close(params[k], ref["res"][2][k], tol, k)
    port_dir = str(tmp_path / "from_port")
    _port_fit(case, mp, port_dir, preempt=True)
    name = f"ckpt-{step:010d}"
    a_dir, b_dir = os.path.join(port_dir, name), os.path.join(ref["dir"],
                                                              name)
    with open(os.path.join(a_dir, "opt_state.pkl"), "rb") as f:
        a_opt = pickle.load(f)
    with open(os.path.join(b_dir, "opt_state.pkl"), "rb") as f:
        b_opt = pickle.load(f)
    assert list(a_opt) == list(b_opt)
    for k in b_opt:
        for x, y in zip(np.atleast_1d(np.asarray(a_opt[k], dtype=object)),
                        np.atleast_1d(np.asarray(b_opt[k], dtype=object))):
            _close(np.asarray(x, np.float32), np.asarray(y, np.float32),
                   tol)
    for group in ("params", "aux"):
        with np.load(os.path.join(a_dir, f"{group}.npz")) as za, \
                np.load(os.path.join(b_dir, f"{group}.npz")) as zb:
            assert za.files == zb.files
            for k in zb.files:
                assert za[k].dtype == zb[k].dtype
                _close(za[k], zb[k], tol)
    ma, mb = (json.load(open(os.path.join(d, "manifest.json")))
              for d in (a_dir, b_dir))
    assert set(ma["files"]) == set(mb["files"])
    assert ma["keys"] == mb["keys"]
    assert {k: v for k, v in ma["meta"].items() if k not in ("rng",
                                                             "scaler")} == \
        {k: v for k, v in mb["meta"].items() if k not in ("rng", "scaler")}
    assert ("scaler" in ma["meta"]) == ("scaler" in mb["meta"])
    assert len(ma["meta"]["rng"]) == len(mb["meta"]["rng"]) == 2
    # the port's directory restores in the reference
    shutil.copytree(port_dir, str(tmp_path / "port_copy"))
    done, outs, params, _ = _fit(jmx, case, mp,
                                 str(tmp_path / "port_copy"), resume=True)
    assert done
    _close(np.stack(outs), np.stack(ref["res"][1]), tol)


def test_resume_from_corrupt_newest_checkpoint(tmp_path, monkeypatch):
    """``fit(resume=True)`` skips a corrupt newest checkpoint and resumes
    from the one before, to the uninterrupted run's parameters."""
    ckdir = str(tmp_path / "ck")
    mp = monkeypatch
    _port_fit("sgd_momentum", mp, ckdir, preempt=True)
    steps = _steps(ckdir)
    assert steps[-1] == 7
    corrupt_checkpoint(os.path.join(ckdir, "ckpt-0000000007"), "flip")
    done, _, res, mod = _port_fit("sgd_momentum", mp, ckdir, resume=True)
    assert done and mod._fused_step_count == 20 - steps[-2]
    _, _, full, _ = _port_fit("sgd_momentum", mp)
    for k in full:
        np.testing.assert_array_equal(res[k], full[k])


def test_fast_forward_seek_matches_consumption():
    X, Y, _ = _data()
    with tmx.cpu():
        it1 = tmx.io.NDArrayIter(X, Y, batch_size=32)
        it2 = tmx.io.NDArrayIter(X, Y, batch_size=32)
        assert tmx.io.fast_forward(iter(it1), 3) == 3          # seek
        for _ in range(3):
            next(iter(it2))                                    # consume
        np.testing.assert_array_equal(next(it1).data[0].asnumpy(),
                                      next(it2).data[0].asnumpy())
        assert it1.tell() == 4

        class NoSeek:
            def __init__(self, n):
                self.left = n

            def __iter__(self):
                return self

            def __next__(self):
                if not self.left:
                    raise StopIteration
                self.left -= 1
                return self.left

        plain = NoSeek(5)
        assert tmx.io.fast_forward(plain, 3) == 3 and plain.left == 2
        assert tmx.io.fast_forward(NoSeek(2), 5) == 2
    jit = jmx.io.NDArrayIter(X, Y, batch_size=32)
    assert jmx.io.fast_forward(iter(jit), 3) == 3
    np.testing.assert_array_equal(next(jit).data[0].asnumpy(), X[96:128])


def test_integrity_helpers_match_reference(tmp_path):
    """``checkpoint.integrity`` writes the reference's manifest bytes and
    refuses what the reference refuses."""
    from mxnet_tpu.checkpoint import integrity as jint
    from mxnet_tpu_torch.base import MXNetError
    from mxnet_tpu_torch.checkpoint import integrity as tint

    path = str(tmp_path / "m.params")
    with open(path, "wb") as f:
        f.write(b"x" * 1000)
    tint.write_params_manifest(path, ["arg:b", "arg:a"])
    port = open(tint.manifest_path_for(path)).read()
    jint.write_params_manifest(path, ["arg:b", "arg:a"])
    assert open(jint.manifest_path_for(path)).read() == port
    assert tint.verify_params_file(path)["keys"] == ["arg:a", "arg:b"]
    with pytest.raises(MXNetError, match="arg:b"):
        tint.verify_params_file(path, loaded_keys=["arg:a"])
    with open(path, "r+b") as f:
        f.truncate(500)
    with pytest.raises(MXNetError, match="truncated"):
        tint.verify_params_file(path)
    with pytest.raises(MXNetError, match="does not exist"):
        tint.verify_params_file(str(tmp_path / "missing.params"))
