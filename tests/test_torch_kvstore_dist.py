"""PyTorch port: the distributed kvstore (``kvstore_dist.py``,
``kvstore_server.py``, ``kvstore.create("dist_*")``) against the JAX
package's.

The wire codec's bytes both ways.  Then each package's workers run as
threads of this process over localhost sockets: every ``KVStoreDist`` is
made in the main thread under ``monkeypatch``ed ``MXTPU_*`` variables (it
reads its rank when made; rank 0's starts the server tier), and each
worker's body runs in its own thread under ``with cpu():`` (contexts are
per thread).  The port's stores are made under ``with cpu():`` too, so
their servers work on the CPU.  Values, pushed gradients and the server's
optimizer are numpy from a seed; every pulled value must equal the
reference's bit for bit (two workers: the server's merge of two pushes
does not depend on their order), and the compressed pushes' frames on the
wire must be the reference's bytes.  Last, ``tools/launch.py -n 2`` runs
a small Gluon ``Trainer(kvstore="dist_sync")`` script under the port in
two processes, held against the same steps of the reference's Trainer
over threaded workers (rtol 1e-5: the server's SGD in torch against
jnp).
"""
import os
import pickle
import socket
import subprocess
import sys
import threading
import time

import numpy as np
import pytest
import torch

import mxnet_tpu as jmx
import mxnet_tpu.kvstore_dist as jkd
import mxnet_tpu_torch as tmx
import mxnet_tpu_torch.kvstore_dist as tkd

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
JOIN_S = 60


@pytest.fixture(scope="module", autouse=True)
def _torch_threads():
    old = torch.get_num_threads()
    torch.set_num_threads(2)
    yield
    torch.set_num_threads(old)


def _free_port(n=1):
    """A port from which ``n`` consecutive ports are free: the server tier
    binds them all, on every interface, so each is checked by a bind."""
    while True:
        s = socket.socket()
        s.bind(("127.0.0.1", 0))
        port = s.getsockname()[1]
        s.close()
        held = []
        try:
            for p in range(port, port + n):
                held.append(socket.socket())
                held[-1].bind(("0.0.0.0", p))
            return port
        except OSError:
            continue
        finally:
            for t in held:
                t.close()


def _stores(pkg, monkeypatch, mode, n, extra=None):
    """``n`` stores of one job, made in rank order under the launcher's
    variables (``extra`` too)."""
    port = _free_port(int((extra or {}).get("MXTPU_NUM_SERVERS", "1")))
    kvs = []
    for rank in range(n):
        env = {"MXTPU_COORDINATOR": f"127.0.0.1:{port}",
               "MXTPU_NUM_PROCS": str(n), "MXTPU_PROC_ID": str(rank),
               **(extra or {})}
        for k, v in env.items():
            monkeypatch.setenv(k, v)
        if pkg is tmx:
            with tmx.cpu():
                kvs.append(pkg.kv.create(mode))
        else:
            kvs.append(pkg.kv.create(mode))
    return kvs


def _run(pkg, monkeypatch, mode, body, n=2, extra=None):
    """``body(pkg, kv, rank)`` on every worker, each in a thread; their
    results in rank order."""
    kvs = _stores(pkg, monkeypatch, mode, n, extra)
    out, errors = [None] * n, []

    def work(rank):
        try:
            with pkg.cpu():
                out[rank] = body(pkg, kvs[rank], rank)
        except BaseException as e:  # reported below, with the rank
            errors.append((rank, e))

    threads = [threading.Thread(target=work, args=(r,), daemon=True)
               for r in range(n)]
    try:
        for t in threads:
            t.start()
        for t in threads:
            t.join(JOIN_S)
        assert not any(t.is_alive() for t in threads), "a worker hung"
        assert not errors, errors
    finally:
        for kv in kvs:
            kv.close()
    return out


def _both(monkeypatch, mode, body, **kw):
    return (_run(tmx, monkeypatch, mode, body, **kw),
            _run(jmx, monkeypatch, mode, body, **kw))


def _same(a, b):
    """Pulled values bit for bit: nested lists of numpy arrays."""
    if isinstance(a, (list, tuple)):
        assert len(a) == len(b)
        for x, y in zip(a, b):
            _same(x, y)
    else:
        assert a.dtype == b.dtype and a.shape == b.shape
        np.testing.assert_array_equal(a, b)


# -- the wire codec ---------------------------------------------------------------

CODEC_CASES = [
    ("push", "k", 3, np.arange(12, dtype=np.float32).reshape(3, 4)),
    ("pull", "x", None),
    ("ok", np.zeros((2, 2), np.float16), 7),
    ("push_c", "w", 1, np.arange(6, dtype=np.uint32), (96,)),
    ("set_compression", {"type": "2bit", "threshold": 0.5,
                         "backend": "pallas"}),
    ("barrier", "b1"),
    (True, False, None, 1.5, -42, b"raw", np.float32(2.5), np.int64(9)),
    ("nested", (1, (2, "three")), [4.0], {"a": [np.ones(3, np.int8)]}),
]


@pytest.mark.parametrize("case", range(len(CODEC_CASES)))
def test_wire_codec_bytes_both_ways(case):
    obj = CODEC_CASES[case]
    mine, theirs = [], []
    tkd._enc(obj, mine)
    jkd._enc(obj, theirs)
    blob = b"".join(mine)
    assert blob == b"".join(theirs)
    a, pos_a = tkd._dec(memoryview(b"".join(theirs)), 0)
    b, pos_b = jkd._dec(memoryview(blob), 0)
    assert pos_a == pos_b == len(blob)
    tkd_again, jkd_again = [], []
    tkd._enc(a, tkd_again)
    jkd._enc(b, jkd_again)
    assert b"".join(tkd_again) == b"".join(jkd_again)


def test_wire_codec_refuses_arbitrary_objects():
    class Evil:
        def __reduce__(self):
            return (os.system, ("true",))

    for obj in (Evil(), torch.ones(2), {1: "int key"}):
        with pytest.raises(tmx.MXNetError):
            tkd._enc(("push", obj), [])
        with pytest.raises(jmx.base.MXNetError):
            jkd._enc(("push", obj), [])


def test_pickled_optimizer_needs_rank0_authorization(monkeypatch):
    """A peer cannot turn the server's optimizer on: only rank 0's own
    in-process servers accept the pickled blob."""
    monkeypatch.delenv("MXNET_KVSTORE_ALLOW_PICKLE", raising=False)
    replies = []
    for mod, opt in ((tkd, tmx.optimizer.SGD(learning_rate=0.1)),
                     (jkd, jmx.optimizer.SGD(learning_rate=0.1))):
        with tmx.cpu():
            srv = mod.KVStoreDistServer(host="127.0.0.1", port=0,
                                        num_workers=1)
        sock = socket.create_connection(("127.0.0.1", srv.port), timeout=10)
        try:
            mod._send_msg(sock, ("set_optimizer", pickle.dumps(opt)))
            replies.append(mod._recv_msg(sock))
            srv.allow_pickle_optimizer = True
            mod._send_msg(sock, ("set_optimizer", pickle.dumps(opt)))
            replies.append(mod._recv_msg(sock))
            mod._send_msg(sock, ("shutdown",))
            mod._recv_msg(sock)
        finally:
            sock.close()
    assert replies[0] == replies[2] and replies[0][0] == "error"
    assert replies[1] == replies[3] == ("ok",)


# -- push and pull ------------------------------------------------------------------

def test_dist_sync_push_pull(monkeypatch):
    def body(mx, kv, rank):
        nd, outs = mx.nd, []
        kv.init("a", nd.array(np.zeros((4, 2), np.float32)))
        for step in range(3):
            kv.push("a", nd.array(np.full((4, 2), rank + 1.5 * step,
                                          np.float32)))
            out = nd.zeros((4, 2))
            kv.pull("a", out=out)
            outs.append(out.asnumpy())
        kv.barrier()
        return outs, kv.rank, kv.num_workers, kv.type

    mine, ref = _both(monkeypatch, "dist_sync", body, n=3)
    for (a, ra, na, ta), (b, rb, nb, tb) in zip(mine, ref):
        assert (ra, na, ta) == (rb, nb, tb)
        _same(a, b)
    np.testing.assert_array_equal(mine[0][0][-1], 0 + 1 + 2 + 3 * 1.5 * 2)


def test_dist_async_applies_each_push(monkeypatch):
    def body(mx, kv, rank):
        nd = mx.nd
        kv.init("x", nd.array(np.zeros((2,), np.float32)))
        kv.barrier()
        kv.push("x", nd.array(np.ones((2,), np.float32)))
        kv.barrier()
        out = nd.zeros((2,))
        kv.pull("x", out=out)
        return out.asnumpy()

    mine, ref = _both(monkeypatch, "dist_async", body)
    _same(mine, ref)
    np.testing.assert_array_equal(mine[0], 1.0)


def test_dist_sync_server_optimizer(monkeypatch):
    """The server's updater: momentum SGD on the merged gradient, over
    three rounds, with a sliced and an unsliced key."""
    def body(mx, kv, rank):
        nd, outs = mx.nd, []
        r = np.random.RandomState(0)
        w0 = r.randn(40, 30).astype(np.float32)
        kv.init("w", nd.array(w0))
        kv.init("b", nd.array(np.ones((7,), np.float32)))
        if rank == 0:
            kv.set_optimizer(mx.optimizer.SGD(learning_rate=0.1,
                                              momentum=0.9, wd=1e-3))
        else:
            kv.barrier()   # set_optimizer's barrier
        g = np.random.RandomState(10 + rank)
        for _ in range(3):
            kv.push("w", nd.array(g.randn(40, 30).astype(np.float32)))
            kv.push("b", nd.array(g.randn(7).astype(np.float32)))
            ow, ob = nd.zeros((40, 30)), nd.zeros((7,))
            kv.pull("w", out=ow)
            kv.pull("b", out=ob)
            outs += [ow.asnumpy(), ob.asnumpy()]
        kv.barrier()
        return outs

    extra = {"MXTPU_NUM_SERVERS": "2", "MXNET_KVSTORE_BIGARRAY_BOUND": "1000"}
    mine, ref = _both(monkeypatch, "dist_sync", body, extra=extra)
    _same(mine[0], mine[1])
    for a, b in zip(mine[0], ref[0]):
        np.testing.assert_allclose(a, b, rtol=1e-6, atol=1e-7)


def _record_push_c(monkeypatch, mod, frames):
    """Keep every compressed push's frame bytes, by rank."""
    real = mod._send_msg

    def send(sock, obj):
        if obj and obj[0] == "push_c":
            parts = []
            mod._enc(obj, parts)
            frames.setdefault(obj[2], []).append(b"".join(parts))
        return real(sock, obj)

    monkeypatch.setattr(mod, "_send_msg", send)


def test_dist_sync_compressed_push_two_servers(monkeypatch):
    """2-bit pushes (the worker quantizes, the server dequantizes) with two
    servers: a key above the big-array bound is sliced and each slice
    packs alone against its own residual.  Pulled values bitwise, and the
    compressed frames on the wire byte for byte the reference's."""
    def body(mx, kv, rank):
        nd, outs = mx.nd, []
        kv.set_gradient_compression({"type": "2bit", "threshold": 0.5})
        kv.init("big", nd.array(np.zeros((50, 70), np.float32)))
        kv.init("small", nd.array(np.zeros((33,), np.float32)))
        assert len(kv._partition("big", 3500)) == 2
        assert len(kv._partition("small", 33)) == 1
        g = np.random.RandomState(20 + rank)
        for _ in range(3):
            kv.push("big", nd.array((g.randn(50, 70) * 0.6)
                                    .astype(np.float32)))
            kv.push("small", nd.array((g.randn(33) * 0.6)
                                      .astype(np.float32)))
            ob, os_ = nd.zeros((50, 70)), nd.zeros((33,))
            kv.pull("big", out=ob)
            kv.pull("small", out=os_)
            outs += [ob.asnumpy(), os_.asnumpy()]
        kv.barrier()
        return outs

    extra = {"MXTPU_NUM_SERVERS": "2", "MXNET_KVSTORE_BIGARRAY_BOUND": "1000"}
    frames_t, frames_j = {}, {}
    _record_push_c(monkeypatch, tkd, frames_t)
    mine = _run(tmx, monkeypatch, "dist_sync", body, extra=extra)
    _record_push_c(monkeypatch, jkd, frames_j)
    ref = _run(jmx, monkeypatch, "dist_sync", body, extra=extra)
    _same(mine, ref)
    assert {r: len(f) for r, f in frames_t.items()} == {0: 9, 1: 9}
    for rank in (0, 1):
        # slices of one push go out from one thread each: order them
        assert sorted(frames_t[rank]) == sorted(frames_j[rank])


def _first_heartbeat(kv, within=JOIN_S / 2):
    """Wait until the server has acknowledged this worker's first
    heartbeat (its thread starts with the store and beats at once; under
    a loaded host it may not have run yet); the wait in seconds."""
    t0 = time.monotonic()
    while kv._last_hb_ok is None and time.monotonic() - t0 < within:
        time.sleep(0.01)
    return time.monotonic() - t0


def test_dist_sync_row_sparse_pull_and_liveness(monkeypatch):
    """Rows pulled bitwise the reference's, and no dead node once every
    worker's first heartbeat has landed (each waits for its own, then a
    barrier): asked earlier, a worker whose heartbeat thread the host has
    not yet scheduled counts as dead in either package."""
    def body(mx, kv, rank):
        nd = mx.nd
        w = np.arange(12).reshape(4, 3).astype(np.float32)
        kv.init("emb", nd.array(w))
        out = nd.zeros((4, 3))
        kv.row_sparse_pull("emb", out=out, row_ids=nd.array([1, 3]))
        waited = _first_heartbeat(kv)
        kv.barrier()
        dead = kv.num_dead_node(timeout=30)
        kv.barrier()
        return out.asnumpy(), dead, waited

    mine, ref = _both(monkeypatch, "dist_sync", body)
    for (a, da, wa), (b, db, wb) in zip(mine, ref):
        _same(a, b)
        assert da == 0, f"the port counts {da} dead (waited {wa:.2f} s)"
        assert db == 0, f"the reference counts {db} dead (waited {wb:.2f} s)"


def test_dist_single_process(monkeypatch):
    """No launcher variables: rank 0 of one worker, its own server."""
    for var in ("MXTPU_PROC_ID", "MXTPU_NUM_PROCS", "MXTPU_NUM_SERVERS"):
        monkeypatch.delenv(var, raising=False)
    monkeypatch.setenv("MXTPU_COORDINATOR", f"127.0.0.1:{_free_port()}")
    with tmx.cpu():
        kv = tmx.kv.create("dist_sync")
        try:
            assert (kv.rank, kv.num_workers, kv.type) == (0, 1, "dist_sync")
            kv.init("k", tmx.nd.array(np.ones((2, 2), np.float32)))
            kv.push("k", tmx.nd.array(np.full((2, 2), 2.0, np.float32)))
            out = tmx.nd.zeros((2, 2))
            kv.pull("k", out=out)
            np.testing.assert_array_equal(out.asnumpy(), 2.0)
            assert kv.bytes_sent > 0 and kv.bytes_received > 0
        finally:
            kv.close()


# -- Module.fit and the Gluon Trainer over the store ------------------------------

def _fc_symbol(mx):
    data = mx.sym.Variable("data")
    h = mx.sym.Activation(mx.sym.FullyConnected(data, num_hidden=8,
                                                name="fc1"),
                          act_type="relu", name="relu1")
    return mx.sym.SoftmaxOutput(mx.sym.FullyConnected(h, num_hidden=3,
                                                      name="fc2"),
                                name="softmax")


def _fc_data(rank, n):
    r = np.random.RandomState(0)
    X = r.rand(32, 6).astype(np.float32)
    Y = (X @ r.randn(6, 3).astype(np.float32)).argmax(1).astype(np.float32)
    return X[rank::n], Y[rank::n]


def _fc_params(mx):
    r = np.random.RandomState(1)
    return {"fc1_weight": mx.nd.array(r.randn(8, 6).astype(np.float32) * .3),
            "fc1_bias": mx.nd.array(np.zeros(8, np.float32)),
            "fc2_weight": mx.nd.array(r.randn(3, 8).astype(np.float32) * .3),
            "fc2_bias": mx.nd.array(np.zeros(3, np.float32))}


def test_module_fit_over_dist_sync(monkeypatch):
    """``Module.fit(kvstore=<dist_sync>)``: the update runs on the server
    with ``rescale_grad = 1 / (batch * workers)``; both workers end on the
    same weights, the reference's."""
    def body(mx, kv, rank):
        X, Y = _fc_data(rank, kv.num_workers)
        it = mx.io.NDArrayIter(X, Y, batch_size=4,
                               label_name="softmax_label")
        mod = mx.mod.Module(_fc_symbol(mx), context=mx.cpu(),
                            label_names=["softmax_label"])
        mod.fit(it, num_epoch=2, optimizer="sgd", kvstore=kv,
                optimizer_params={"learning_rate": 0.5},
                arg_params=_fc_params(mx), eval_metric="acc")
        args, _ = mod.get_params()
        return [args[k].asnumpy() for k in sorted(args)]

    mine, ref = _both(monkeypatch, "dist_sync", body)
    _same(mine[0], mine[1])
    for a, b in zip(mine[0], ref[0]):
        np.testing.assert_allclose(a, b, rtol=1e-5, atol=1e-6)


TRAINER_STEPS, TRAINER_BATCH = 4, 8

# the Gluon loop of each worker: exec'd against either package here, and
# pasted into the launched script (which imports no JAX)
TRAINER_LOOP = """
def trainer_run(mx, gluon, autograd, kv, rank, num, steps, batch):
    import numpy as np

    r = np.random.RandomState(3)
    X = r.rand(batch * num * steps, 6).astype(np.float32)
    Y = r.randint(0, 3, len(X)).astype(np.float32)
    net = gluon.nn.HybridSequential()
    net.add(gluon.nn.Dense(8, activation="relu", in_units=6),
            gluon.nn.Dense(3, in_units=8))
    net.initialize(ctx=mx.cpu())
    w = np.random.RandomState(4)
    for p in net.collect_params().values():
        p.set_data(mx.nd.array((w.randn(*p.shape) * 0.3)
                               .astype(np.float32)))
    trainer = gluon.Trainer(
        net.collect_params(), "sgd",
        {"learning_rate": 0.2, "momentum": 0.9,
         "rescale_grad": 1.0 / (batch * num)}, kvstore=kv)
    loss_fn = gluon.loss.SoftmaxCrossEntropyLoss()
    losses = []
    for s in range(steps):
        lo = (s * num + rank) * batch
        x = mx.nd.array(X[lo:lo + batch])
        y = mx.nd.array(Y[lo:lo + batch])
        with autograd.record():
            L = loss_fn(net(x), y)
        L.backward()
        trainer.step(batch)
        losses.append(float(L.sum().asnumpy()))
    return losses, [p.data().asnumpy() for p in
                    net.collect_params().values()], trainer
"""

_TRAINER_SCRIPT = r'''
import os, sys
import numpy as np
sys.path.insert(0, {repo!r})
import torch
torch.set_num_threads(1)
import mxnet_tpu_torch as mx
from mxnet_tpu_torch import autograd, gluon
{loop}
rank = int(os.environ["MXTPU_PROC_ID"])
num = int(os.environ["MXTPU_NUM_PROCS"])
with mx.cpu():
    # the Trainer makes the store from its name
    losses, params, trainer = trainer_run(mx, gluon, autograd, "dist_sync",
                                          rank, num, {steps}, {batch})
    trainer._kvstore.close()
np.savez(os.path.join({out!r}, f"rank{{rank}}.npz"), *params,
         losses=np.asarray(losses))
'''


def test_gluon_trainer_dist_sync_through_launcher(tmp_path, monkeypatch):
    """``tools/launch.py -n 2`` over a Gluon ``Trainer(kvstore=
    "dist_sync")`` script under the port (two processes, the server in
    rank 0's), against the reference's Trainer over threaded workers."""
    script = tmp_path / "worker.py"
    script.write_text(_TRAINER_SCRIPT.format(
        repo=REPO, loop=TRAINER_LOOP, steps=TRAINER_STEPS,
        batch=TRAINER_BATCH, out=str(tmp_path)))
    env = {k: v for k, v in os.environ.items()
           if not k.startswith(("MXTPU_", "DMLC_"))}
    env["PYTHONPATH"] = REPO
    r = subprocess.run(
        [sys.executable, os.path.join(REPO, "tools", "launch.py"), "-n",
         "2", "--coordinator", f"127.0.0.1:{_free_port()}", "--",
         sys.executable, str(script)],
        capture_output=True, text=True, timeout=120, env=env, cwd=REPO)
    assert r.returncode == 0, f"{r.stdout[-2000:]}\n{r.stderr[-3000:]}"
    got = [np.load(tmp_path / f"rank{k}.npz") for k in (0, 1)]
    ns = {}
    exec(TRAINER_LOOP, ns)
    ref = _run(jmx, monkeypatch, "dist_sync",
               lambda mx, kv, rank: ns["trainer_run"](
                   mx, mx.gluon, mx.autograd, kv, rank, 2, TRAINER_STEPS,
                   TRAINER_BATCH))
    for k in range(len(ref[0][1])):
        np.testing.assert_array_equal(got[0][f"arr_{k}"],
                                      got[1][f"arr_{k}"])
        np.testing.assert_allclose(got[0][f"arr_{k}"], ref[0][1][k],
                                   rtol=1e-5, atol=1e-6)
    for rank in (0, 1):
        np.testing.assert_allclose(got[rank]["losses"], ref[rank][0],
                                   rtol=1e-5)
