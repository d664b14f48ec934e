"""Distributed KVStore: a TCP parameter server between processes.

PyTorch counterpart of ``mxnet_tpu/kvstore_dist.py`` (reference: ps-lite's
worker and server, ``src/kvstore/kvstore_dist.h``,
``kvstore_dist_server.h``): workers push and pull values by key; in BSP
sync mode the server merges exactly ``num_workers`` pushes per key per
round before answering pulls; async applies each push at once; rank 0 of
the job hosts the server tier in-process and may run the optimizer there
(``set_optimizer``).  ``dist_sync``, ``dist_async`` and the
``dist_*_device`` names (``kvstore.create``).

Bootstrap variables (``tools/launch.py``): ``MXTPU_COORDINATOR`` (host:port
of the first server), ``MXTPU_NUM_PROCS``, ``MXTPU_PROC_ID``,
``MXTPU_NUM_SERVERS`` (servers on consecutive ports from the
coordinator's, all in rank 0's process), optional ``MXTPU_SERVER_ADDRS``
for a server tier elsewhere (``kvstore_server.py``).

Wire protocol, byte for byte the reference's: a 4-byte little-endian
length, then a typed binary frame (tags for none/bool/int/float/str/
bytes/ndarray/list/dict; a tensor is a dtype and shape header and its raw
buffer).  Values cross as numpy arrays.  No pickle on the data path; the
one exception is the ``set_optimizer`` payload, a pickled optimizer that
only rank 0 may authorize on its in-process servers.

Devices: the workers' values stay on their devices until they are sent.
A compressed push quantizes on the worker's device (the 2-bit pack kernel
on a card, against a residual per key and server slice); the server
dequantizes on its device (the unpack kernel) and runs the updater there:
the server's device is the context current when rank 0 made the store
(``gpu(0)`` by default, the CPU under ``with mx.cpu():``).  Merge buffers
and stored values are numpy arrays on the host, summed in arrival order.

Big tensors are sliced across the server tier when their element count
exceeds ``MXNET_KVSTORE_BIGARRAY_BOUND`` (default 1e6); small keys go to
one server by hash.  ``bytes_sent``/``bytes_received`` count a worker's
frames, headers included.
"""
from __future__ import annotations

import errno
import hashlib
import os
import pickle
import random as _random_mod
import socket
import struct
import threading
import time
from contextlib import nullcontext as _nullcontext
from typing import Dict, List, Optional

import numpy as _np

import torch

from .base import MXNetError
from .context import current_context
from .kvstore import KVStore, _as_list
from .ndarray.ndarray import NDArray
from .observability import tracing as _tracing

__all__ = ["KVStoreDist", "KVStoreDistServer"]


# ------------------------------------------------------------------ fault knobs
# Retry/timeout/backoff for every worker round-trip (docs/fault_tolerance.md):
# a dead socket surfaces as a clear peer-naming MXNetError in bounded time
# instead of an eternal recv().  The recv timeout default (630 s) must outlast
# the longest LEGITIMATE server-side park (BSP merge / barrier deadline is
# 600 s) — tighten it only alongside those.

def _kv_timeout() -> float:
    return float(os.environ.get("TPUMX_KV_TIMEOUT", "630"))


def _kv_retries() -> int:
    return max(0, int(os.environ.get("TPUMX_KV_RETRIES", "3")))


def _kv_backoff_ms() -> float:
    return float(os.environ.get("TPUMX_KV_BACKOFF_MS", "50"))


def _kv_backoff_max_ms() -> float:
    return float(os.environ.get("TPUMX_KV_BACKOFF_MAX_MS", "2000"))


def _kv_connect_timeout() -> float:
    return float(os.environ.get("TPUMX_KV_CONNECT_TIMEOUT", "60"))


def _registry():
    from .observability import registry

    return registry()


# ------------------------------------------------------------------ wire
# typed binary frames (no pickle on the data path)

def _enc(obj, out: list) -> None:
    if obj is None:
        out.append(b"N")
    elif obj is True:
        out.append(b"T")
    elif obj is False:
        out.append(b"F")
    elif isinstance(obj, int):
        out.append(b"i" + struct.pack("<q", obj))
    elif isinstance(obj, float):
        out.append(b"f" + struct.pack("<d", obj))
    elif isinstance(obj, str):
        b = obj.encode("utf-8")
        out.append(b"s" + struct.pack("<I", len(b)) + b)
    elif isinstance(obj, (bytes, bytearray)):
        out.append(b"b" + struct.pack("<I", len(obj)) + bytes(obj))
    elif isinstance(obj, _np.ndarray):
        a = _np.ascontiguousarray(obj)
        dt = a.dtype.str.encode("ascii")
        out.append(b"a" + struct.pack("<B", len(dt)) + dt
                   + struct.pack("<B", a.ndim)
                   + struct.pack(f"<{a.ndim}q", *a.shape)
                   + struct.pack("<Q", a.nbytes))
        out.append(a.tobytes())
    elif isinstance(obj, (list, tuple)):
        out.append(b"L" + struct.pack("<I", len(obj)))
        for x in obj:
            _enc(x, out)
    elif isinstance(obj, dict):
        out.append(b"D" + struct.pack("<I", len(obj)))
        for k, v in obj.items():
            if not isinstance(k, str):
                raise MXNetError(f"wire dicts need str keys, got {type(k)}")
            _enc(k, out)
            _enc(v, out)
    elif isinstance(obj, _np.generic):  # numpy scalar
        _enc(obj.item(), out)
    else:
        raise MXNetError(f"unencodable wire type {type(obj)!r}")


def _dec(buf: memoryview, pos: int):
    tag = bytes(buf[pos:pos + 1])
    pos += 1
    if tag == b"N":
        return None, pos
    if tag == b"T":
        return True, pos
    if tag == b"F":
        return False, pos
    if tag == b"i":
        return struct.unpack_from("<q", buf, pos)[0], pos + 8
    if tag == b"f":
        return struct.unpack_from("<d", buf, pos)[0], pos + 8
    if tag == b"s":
        n = struct.unpack_from("<I", buf, pos)[0]
        pos += 4
        return bytes(buf[pos:pos + n]).decode("utf-8"), pos + n
    if tag == b"b":
        n = struct.unpack_from("<I", buf, pos)[0]
        pos += 4
        return bytes(buf[pos:pos + n]), pos + n
    if tag == b"a":
        dtl = struct.unpack_from("<B", buf, pos)[0]
        pos += 1
        dt = _np.dtype(bytes(buf[pos:pos + dtl]).decode("ascii"))
        pos += dtl
        ndim = struct.unpack_from("<B", buf, pos)[0]
        pos += 1
        shape = struct.unpack_from(f"<{ndim}q", buf, pos)
        pos += 8 * ndim
        nbytes = struct.unpack_from("<Q", buf, pos)[0]
        pos += 8
        a = _np.frombuffer(buf[pos:pos + nbytes], dtype=dt).reshape(shape)
        return a.copy(), pos + nbytes
    if tag == b"L":
        n = struct.unpack_from("<I", buf, pos)[0]
        pos += 4
        items = []
        for _ in range(n):
            v, pos = _dec(buf, pos)
            items.append(v)
        return tuple(items), pos
    if tag == b"D":
        n = struct.unpack_from("<I", buf, pos)[0]
        pos += 4
        d = {}
        for _ in range(n):
            k, pos = _dec(buf, pos)
            v, pos = _dec(buf, pos)
            d[k] = v
        return d, pos
    raise MXNetError(f"bad wire tag {tag!r}")


def _send_msg(sock: socket.socket, obj) -> int:
    """Send one frame; returns its bytes, header included."""
    parts: list = []
    _enc(obj, parts)
    payload = b"".join(parts)
    sock.sendall(struct.pack("<I", len(payload)) + payload)
    return 4 + len(payload)


def _recv_msg_sized(sock: socket.socket):
    """One frame: (object, bytes with the header)."""
    header = _recv_exact(sock, 4)
    (length,) = struct.unpack("<I", header)
    obj, _ = _dec(memoryview(_recv_exact(sock, length)), 0)
    return obj, 4 + length


def _recv_msg(sock: socket.socket):
    return _recv_msg_sized(sock)[0]


def _to_numpy(t: torch.Tensor) -> _np.ndarray:
    """A tensor as a numpy array on the host (uint32 words included)."""
    t = t.detach()
    if t.dtype == torch.uint32:
        return t.view(torch.int32).cpu().numpy().view(_np.uint32)
    return t.cpu().numpy()


def _to_tensor(a: _np.ndarray, device) -> torch.Tensor:
    a = _np.ascontiguousarray(a)
    if a.dtype == _np.uint32:
        return torch.from_numpy(a.view(_np.int32)).to(device).view(
            torch.uint32)
    return torch.from_numpy(a).to(device)


def _recv_exact(sock: socket.socket, n: int) -> bytes:
    buf = b""
    while len(buf) < n:
        chunk = sock.recv(n - len(buf))
        if not chunk:
            raise ConnectionError("peer closed")
        buf += chunk
    return buf


# number of elements above which a tensor is sliced across the server tier
def _bigarray_bound() -> int:
    return int(os.environ.get("MXNET_KVSTORE_BIGARRAY_BOUND", 1000000))


# ------------------------------------------------------------------ server


class _KeyState:
    __slots__ = ("value", "pending_sum", "pending_ranks", "version")

    def __init__(self, value):
        self.value = value           # numpy array (the stored weight)
        self.pending_sum = None      # merge buffer for the current round
        self.pending_ranks = set()   # ranks merged into the current round
        self.version = 0             # bumps once per completed BSP round


class KVStoreDistServer:
    """The server half (reference: kvstore_dist_server.h).

    BSP (`sync_mode=True`): pushes accumulate into a merge buffer; when
    exactly num_workers pushes arrived the round commits — updater applied
    (or plain replace) and version bumps; pulls for version v block until
    the commit (the reference parks pull responses the same way, :346-358).
    Async: every push applies immediately.
    """

    def __init__(self, host="0.0.0.0", port=0, num_workers=1):
        # the device of the server's tensor work: the current context's
        self._device = current_context().torch_device
        self._keys: Dict[str, _KeyState] = {}
        self._lock = threading.Condition()
        self._num_workers = num_workers
        self._updater = None
        # pickled-optimizer commands are only honored when explicitly
        # enabled: rank 0 flips this directly on its in-process servers,
        # or MXNET_KVSTORE_ALLOW_PICKLE=1 for an external server tier —
        # a remote peer cannot turn it on
        self.allow_pickle_optimizer = \
            os.environ.get("MXNET_KVSTORE_ALLOW_PICKLE") == "1"
        self._sync_mode = False
        self._grad_compression = None  # set by the workers' set_compression
        self._barrier_count = {}
        self._heartbeats: Dict[int, float] = {}
        self._stop = False
        self._sock = socket.socket(socket.AF_INET, socket.SOCK_STREAM)
        self._sock.setsockopt(socket.SOL_SOCKET, socket.SO_REUSEADDR, 1)
        # a restarted server (or a still-draining predecessor in TIME_WAIT
        # beyond what SO_REUSEADDR covers) must not crash on EADDRINUSE:
        # retry the bind with exponential backoff + jitter up to
        # TPUMX_KV_BIND_TIMEOUT seconds, then raise a clear error naming
        # the endpoint (docs/fault_tolerance.md)
        deadline = time.time() + float(
            os.environ.get("TPUMX_KV_BIND_TIMEOUT", "30"))
        delay = 0.05
        while True:
            try:
                self._sock.bind((host, port))
                break
            except OSError as e:
                if e.errno != errno.EADDRINUSE or port == 0 \
                        or time.time() >= deadline:
                    raise MXNetError(
                        f"kvstore server cannot bind {host}:{port}: "
                        f"{e}") from e
                time.sleep(delay * (0.5 + _random_mod.random() / 2))
                delay = min(delay * 2, 1.0)
        self._sock.listen(64)
        self.port = self._sock.getsockname()[1]
        self._threads: List[threading.Thread] = []
        self._accept_thread = threading.Thread(target=self._accept_loop,
                                               daemon=True)
        self._accept_thread.start()

    # -- command handlers ---------------------------------------------------------

    def _accept_loop(self):
        while not self._stop:
            try:
                conn, _ = self._sock.accept()
            except OSError:
                return
            t = threading.Thread(target=self._serve, args=(conn,), daemon=True)
            t.start()
            self._threads.append(t)

    def _serve(self, conn: socket.socket):
        from . import profiler as _prof

        try:
            while True:
                msg = _recv_msg(conn)
                # fault injection (docs/fault_tolerance.md): kill the
                # server mid-round — the request is consumed, no reply is
                # sent, the listener closes.  Workers must recover via the
                # retry path or surface a peer-naming error
                from .fault import injector as _fault_injector

                if _fault_injector().server_kill_due():
                    self._stop = True
                    try:
                        self._sock.close()
                    except OSError:
                        pass
                    return
                # server-side spans: the server's work (merge/update) is
                # not op dispatch, so the remote profiler records
                # command-handling durations — the server_* rows the
                # reference's test_server_profiling flow inspects
                with _prof.scope(f"server_{msg[0]}", cat="server"):
                    reply = self._handle(msg)
                _send_msg(conn, reply)
                if msg[0] == "shutdown":
                    return
        except (ConnectionError, EOFError, OSError):
            return
        finally:
            conn.close()

    def _handle(self, msg):
        cmd = msg[0]
        if cmd == "init":
            _, key, value = msg
            with self._lock:
                if key not in self._keys:  # first init wins (rank-0 broadcast)
                    self._keys[key] = _KeyState(value)
                self._lock.notify_all()
            return ("ok",)
        if cmd == "push":
            _, key, rank, value = msg
            return self._push(key, rank, value)
        if cmd == "push_c":
            # Compressed push: the worker quantized, the server dequantizes
            # into the merge buffer (reference kvstore_dist_server.h:636-655).
            _, key, rank, packed, shape = msg
            if self._grad_compression is None:
                return ("error", "compressed push before set_compression")
            try:
                with self._on_device():
                    value = _to_numpy(self._grad_compression.dequantize(
                        _to_tensor(packed, self._device), tuple(shape),
                        dtype=torch.float32))
            except Exception as e:  # malformed blob must not kill the thread
                return ("error", f"dequantize failed for {key!r}: {e}")
            return self._push(key, rank, value)
        if cmd == "set_compression":
            from .parallel.compression import GradientCompression

            with self._lock:
                if self._grad_compression is None:
                    self._grad_compression = GradientCompression(**msg[1])
                elif self._grad_compression.wire_params() != msg[1]:
                    return ("error",
                            f"compression params mismatch across workers: "
                            f"server has {self._grad_compression.wire_params()},"
                            f" got {msg[1]}")
            return ("ok",)
        if cmd == "pull":
            _, key, min_version = msg
            return self._pull(key, min_version)
        if cmd == "row_sparse_pull":
            _, key, row_ids, min_version = msg
            rep = self._pull(key, min_version)
            if rep[0] != "ok":
                return rep
            return ("ok", rep[1][_np.asarray(row_ids, dtype=_np.int64)],
                    rep[2])
        if cmd == "barrier":
            _, barrier_id = msg
            with self._lock:
                self._barrier_count[barrier_id] = \
                    self._barrier_count.get(barrier_id, 0) + 1
                self._lock.notify_all()
                deadline = time.time() + 600
                while self._barrier_count[barrier_id] % self._num_workers != 0:
                    if not self._lock.wait(timeout=min(1.0, deadline - time.time())):
                        if time.time() > deadline:
                            return ("error", "barrier timeout")
            return ("ok",)
        if cmd == "set_sync":
            self._sync_mode = bool(msg[1])
            return ("ok",)
        if cmd == "set_optimizer":
            if not self.allow_pickle_optimizer:
                return ("error",
                        "server-side optimizer disabled: enable via rank-0 "
                        "in-process setup or MXNET_KVSTORE_ALLOW_PICKLE=1")
            from .optimizer import Updater, Optimizer

            opt = pickle.loads(msg[1])
            self._updater = Updater(opt) if isinstance(opt, Optimizer) else opt
            return ("ok",)
        if cmd == "heartbeat":
            _, rank = msg
            with self._lock:
                self._heartbeats[rank] = time.time()
            return ("ok",)
        if cmd == "num_dead_node":
            _, timeout_s = msg
            now = time.time()
            with self._lock:
                dead = sum(1 for r in range(self._num_workers)
                           if now - self._heartbeats.get(r, 0) > timeout_s)
            return ("ok", dead)
        if cmd == "profiler":
            # remote server profiling (reference: KVStoreServerProfilerCommand,
            # include/mxnet/kvstore.h:49-51; tests/nightly/
            # test_server_profiling.py) — workers toggle the server-side
            # profiler and fetch its table or chrome-trace dump over the
            # wire.  NOTE: in the default layout rank 0 hosts the server
            # tier IN-PROCESS, so this profiler is that process's global
            # one (worker and server events share it); with a dedicated
            # server host (MXTPU_ROLE=server) it is genuinely separate,
            # matching the reference's profile_process="server".
            from . import profiler as _prof

            _, action, arg = msg
            if action == "set_config":
                _prof.set_config(filename=arg or "server_profile.json",
                                 profile_imperative=True)
                return ("ok",)
            if action == "state":
                _prof.set_state(arg)
                return ("ok",)
            if action == "dump":
                return ("ok", _prof.dumps(reset=False,
                                          format=arg or "table"))
            if action == "dump_file":
                _prof.dump()
                return ("ok",)
            return ("error", f"unknown profiler action {action!r}")
        if cmd == "shutdown":
            with self._lock:
                self._barrier_count["__shutdown__"] = \
                    self._barrier_count.get("__shutdown__", 0) + 1
                if self._barrier_count["__shutdown__"] >= self._num_workers:
                    self._stop = True
                    try:
                        self._sock.close()
                    except OSError:
                        pass
            return ("ok",)
        return ("error", f"unknown command {cmd!r}")

    def _push(self, key, rank, value):
        with self._lock:
            st = self._keys.get(key)
            if st is None:
                return ("error", f"push to uninitialized key {key!r}")
            if not self._sync_mode:
                # async: apply immediately (kvstore_dist_server.h async branch)
                self._apply(st, key, value)
                self._lock.notify_all()
                return ("ok",)
            # BSP: one contribution per rank per round — a fast worker's
            # next-round push parks until the current round commits
            # (the reference parks on per-timestamp merge buffers)
            deadline = time.time() + 600
            while rank in st.pending_ranks:
                if not self._lock.wait(timeout=min(1.0, deadline - time.time())):
                    if time.time() > deadline:
                        return ("error", f"push timeout on {key!r}")
                st = self._keys.get(key)
            if st.pending_sum is None:
                st.pending_sum = value.copy()
            else:
                st.pending_sum += value
            st.pending_ranks.add(rank)
            if len(st.pending_ranks) == self._num_workers:
                self._apply(st, key, st.pending_sum)
                st.pending_sum = None
                st.pending_ranks = set()
                st.version += 1
                self._lock.notify_all()
            return ("ok",)

    def _on_device(self):
        """This thread's current CUDA device set to the server's (its
        default stream); nothing for the CPU."""
        if self._device.type == "cuda":
            return torch.cuda.device(self._device)
        return _nullcontext()

    def _apply(self, st: _KeyState, key, merged):
        if self._updater is not None:
            # the copy back to the host waits for the update
            with self._on_device(), torch.no_grad():
                w = NDArray(_to_tensor(st.value, self._device))
                self._updater(key, NDArray(_to_tensor(merged, self._device)),
                              w)
                st.value = w.asnumpy()
        else:
            st.value = _np.asarray(merged)

    def _pull(self, key, min_version):
        with self._lock:
            deadline = time.time() + 600
            while True:
                st = self._keys.get(key)
                if st is not None and (min_version is None
                                       or st.version >= min_version):
                    return ("ok", st.value, st.version)
                if not self._lock.wait(timeout=min(1.0, deadline - time.time())):
                    if time.time() > deadline:
                        return ("error", f"pull timeout on {key!r}")

    def join(self):
        self._accept_thread.join()


# ------------------------------------------------------------------ client


class KVStoreDist(KVStore):
    """The worker half (reference: kvstore_dist.h KVStoreDist)."""

    def __init__(self, name="dist_sync"):
        super().__init__()
        self._type = name
        self.bytes_sent = 0
        self.bytes_received = 0
        self._sync = "async" not in name
        self._rank = int(os.environ.get("MXTPU_PROC_ID",
                                        os.environ.get("TPUMX_RANK", "0")))
        self._num = int(os.environ.get("MXTPU_NUM_PROCS",
                                       os.environ.get("TPUMX_NUM_WORKERS", "1")))
        coord = os.environ.get("MXTPU_COORDINATOR", "127.0.0.1:9027")
        host, port = coord.rsplit(":", 1)
        n_servers = int(os.environ.get("MXTPU_NUM_SERVERS", "1"))
        addrs_env = os.environ.get("MXTPU_SERVER_ADDRS")
        if addrs_env:
            addrs = [a.rsplit(":", 1) for a in addrs_env.split(",")]
            addrs = [(h, int(p)) for h, p in addrs]
            n_servers = len(addrs)
        else:
            # server tier on consecutive ports from the coordinator's
            # (the reference local tracker's one-host layout)
            addrs = [(host, int(port) + s) for s in range(n_servers)]
        self._servers: List[KVStoreDistServer] = []
        if self._rank == 0 and not addrs_env:
            for s in range(n_servers):
                self._servers.append(KVStoreDistServer(
                    host="0.0.0.0", port=addrs[s][1], num_workers=self._num))
        self._socks: List[socket.socket] = []
        self._sock_locks: List[threading.Lock] = []
        # effective connect endpoints, kept for peer-naming errors and
        # reconnects (rank 0 talks to its in-process tier over loopback)
        self._addrs: List[tuple] = [
            (h if self._rank or addrs_env else "127.0.0.1", p)
            for h, p in addrs]
        for h, p in self._addrs:
            self._socks.append(self._connect(h, p))
            self._sock_locks.append(threading.Lock())
        self._n_servers = n_servers
        self._last_hb_ok: Optional[float] = None
        self._pull_version: Dict[str, int] = {}
        self._barrier_seq = 0
        for s in range(n_servers):
            self._request_on(s, "set_sync", self._sync)
        self._hb_stop = threading.Event()
        self._hb_thread = threading.Thread(target=self._heartbeat_loop,
                                           daemon=True)
        self._hb_thread.start()

    # -- plumbing -----------------------------------------------------------------

    @property
    def _sock(self):  # primary (server 0) socket — barrier/heartbeat channel
        return self._socks[0]

    def _connect(self, host, port, timeout=None):
        deadline = time.time() + (timeout if timeout is not None
                                  else _kv_connect_timeout())
        while True:
            try:
                sock = socket.create_connection((host, port), timeout=10)
                # connect probes fast, but established-channel reads must
                # outlast server-side BSP parks (server deadline 600 s) —
                # TPUMX_KV_TIMEOUT defaults to 630 s so a worker waiting at
                # a barrier behind a slow peer is not killed; fault tests
                # tighten it to bound dead-peer detection
                sock.settimeout(_kv_timeout())
                sock.setsockopt(socket.IPPROTO_TCP, socket.TCP_NODELAY, 1)
                return sock
            except OSError:
                if time.time() > deadline:
                    raise MXNetError(
                        f"cannot reach kvstore server at {host}:{port}")
                time.sleep(0.1)

    def _reconnect(self, server: int) -> None:
        """Best-effort socket replacement between retries (the old channel
        is presumed dead).  A failed reconnect leaves the dead socket in
        place so the next attempt fails fast and consumes its retry."""
        host, port = self._addrs[server]
        with self._sock_locks[server]:
            try:
                self._socks[server].close()
            except OSError:
                pass
            try:
                self._socks[server] = self._connect(
                    host, port,
                    timeout=min(_kv_connect_timeout(), _kv_timeout()))
            except MXNetError:
                pass

    def _request_on(self, server: int, *msg, retries: Optional[int] = None):
        """One request/reply round-trip with retry + exponential backoff +
        jitter (``TPUMX_KV_TIMEOUT`` / ``TPUMX_KV_RETRIES`` /
        ``TPUMX_KV_BACKOFF_MS``): a timed-out or dropped message is resent
        over a fresh connection; a peer that stays silent raises a clear
        :class:`MXNetError` NAMING it in bounded time instead of an
        eternal ``recv()`` (docs/fault_tolerance.md)."""
        cmd = str(msg[0])
        retries = _kv_retries() if retries is None else retries
        base_ms, max_ms = _kv_backoff_ms(), _kv_backoff_max_ms()
        t0 = time.time()
        last_err: Optional[BaseException] = None
        from .fault import injector as _fault_injector

        for attempt in range(retries + 1):
            if attempt:
                delay = min(base_ms * (2 ** (attempt - 1)), max_ms)
                delay *= 0.5 + _random_mod.random() / 2  # jitter
                with _tracing.span("kvstore.retry", cat="kvstore",
                                   args={"op": cmd, "attempt": attempt}):
                    time.sleep(delay / 1e3)
                _registry().counter(
                    "kvstore_retries_total", labels={"op": cmd},
                    help="kvstore worker request retries after "
                         "timeout/connection loss").inc()
            try:
                if _fault_injector().kv_fault(cmd):
                    raise socket.timeout(
                        f"fault-injected drop of {cmd!r} request")
                with self._sock_locks[server]:
                    sent = _send_msg(self._socks[server], msg)
                    reply, got = _recv_msg_sized(self._socks[server])
                    self.bytes_sent += sent
                    self.bytes_received += got
            except (socket.timeout, ConnectionError, OSError) as e:
                last_err = e
                if attempt < retries:
                    self._reconnect(server)
                continue
            if reply[0] != "ok":
                raise MXNetError(f"kvstore server error: {reply[1:]}")
            return reply
        host, port = self._addrs[server]
        _registry().counter(
            "kvstore_dead_peers_total",
            help="kvstore peers declared dead after exhausting the "
                 "retry budget").inc()
        hb = ""
        if server == 0 and self._last_hb_ok is not None:
            hb = (f"; last successful heartbeat to this peer was "
                  f"{time.time() - self._last_hb_ok:.1f}s ago")
        raise MXNetError(
            f"kvstore server {host}:{port} (server {server}, worker rank "
            f"{self._rank}) did not answer a {cmd!r} request after "
            f"{retries + 1} attempts over {time.time() - t0:.1f}s "
            f"(TPUMX_KV_TIMEOUT={_kv_timeout():g}s, "
            f"TPUMX_KV_RETRIES={retries}): {last_err!r}{hb}; "
            f"the peer is presumed dead")

    def _request(self, *msg):
        return self._request_on(0, *msg)

    def _request_many(self, reqs):
        """Issue per-server requests concurrently (one thread per server,
        each on its own socket+lock) and return replies in request order —
        the ps-lite overlap of sliced ZPush/ZPull (kvstore_dist.h:532-584).
        reqs: list of (server, msg_tuple)."""
        if len(reqs) == 1:
            s0, m0 = reqs[0]
            return [self._request_on(s0, *m0)]
        results = [None] * len(reqs)
        errors = []

        def run(i, srv, msg):
            try:
                results[i] = self._request_on(srv, *msg)
            except Exception as e:  # propagate after join
                errors.append(e)

        threads = [threading.Thread(target=run, args=(i, srv, msg),
                                    daemon=True)
                   for i, (srv, msg) in enumerate(reqs)]
        for t in threads:
            t.start()
        for t in threads:
            t.join()
        if errors:
            raise errors[0]
        return results

    # -- key -> server sharding (reference kvstore_dist.h:532-584) ---------------

    def _partition(self, key: str, size: int):
        """Returns [(server, lo, hi)] flat slices covering the value, or
        [(server, None, None)] for an unsliced key."""
        if self._n_servers == 1:
            return [(0, None, None)]
        if size < _bigarray_bound():
            h = int(hashlib.md5(key.encode()).hexdigest()[:8], 16)
            return [(h % self._n_servers, None, None)]
        per = -(-size // self._n_servers)
        out = []
        for s in range(self._n_servers):
            lo, hi = s * per, min((s + 1) * per, size)
            if lo >= hi:
                break
            out.append((s, lo, hi))
        return out

    def _heartbeat_loop(self):
        sock = None
        try:
            host, port = self._sock.getpeername()
            sock = self._connect(host, port)
            while True:  # first beat immediately, then every second
                _send_msg(sock, ("heartbeat", self._rank))
                _recv_msg(sock)
                self._last_hb_ok = time.time()
                if self._hb_stop.wait(1.0):
                    break
        except (OSError, ConnectionError, MXNetError):
            # a lost heartbeat channel marks the peer suspect; the request
            # path's retry/backoff (and its peer-naming error) is the
            # authoritative detector — don't fight it from this thread
            pass
        finally:
            if sock is not None:
                sock.close()

    # -- KVStore API --------------------------------------------------------------

    def init(self, key, value):
        keys = _as_list(key)
        values = _as_list(value)
        for k, v in zip(keys, values):
            # rank-0 broadcast like the reference (kvstore_dist.h Init):
            # if every rank sent its own values, first-arrival could commit
            # a different rank's slice PER SERVER — a nondeterministic
            # patchwork no rank ever initialized
            if self._rank == 0:
                arr = _to_numpy(v._data)
                self._request_many([
                    (s, ("init", str(k),
                         arr if lo is None else arr.reshape(-1)[lo:hi]))
                    for s, lo, hi in self._partition(str(k), arr.size)])
            self._pull_version[str(k)] = 0
        self.barrier()

    def push(self, key, value, priority=0):
        keys = _as_list(key)
        values = _as_list(value)
        for k, vs in zip(keys, values):
            vs = _as_list(vs)
            local = vs[0]._data.detach()
            for v in vs[1:]:  # reduce device list locally first
                local = local + v._data.detach().to(local.device)
            gc = self._grad_compression
            if gc is not None and gc.type != "none":
                if local.dtype != torch.float32:
                    raise MXNetError(
                        "gradient compression supports fp32 only "
                        "(reference kvstore_dist_server.h:607)")
                # quantize on the worker's device; 2 bits an element cross
                # the wire.  The residual is per key and server slice, so
                # error feedback composes with slicing
                reqs = []
                for s, lo, hi in self._partition(str(k), local.numel()):
                    part = local if lo is None \
                        else local.reshape(-1)[lo:hi]
                    rkey = f"{k}@{s}"
                    packed, new_res = gc.quantize(
                        part.contiguous(), self._residuals.get(rkey))
                    self._residuals[rkey] = new_res
                    reqs.append((s, ("push_c", str(k), self._rank,
                                     _to_numpy(packed),
                                     tuple(int(d) for d in part.shape))))
                # overlap per-server pushes like the uncompressed sliced path
                self._request_many(reqs)
            else:
                local = _to_numpy(local)
                self._request_many([
                    (s, ("push", str(k), self._rank,
                         local if lo is None else local.reshape(-1)[lo:hi]))
                    for s, lo, hi in self._partition(str(k), local.size)])
            if self._sync:
                self._pull_version[str(k)] = \
                    self._pull_version.get(str(k), 0) + 1

    def pull(self, key, out=None, priority=0, ignore_sparse=True):
        keys = _as_list(key)
        outs = _as_list(out)
        results = []
        for k, o in zip(keys, outs):
            min_version = self._pull_version.get(str(k)) if self._sync else None
            dsts = _as_list(o)
            parts = self._partition(str(k), dsts[0].size)
            if parts[0][1] is None:
                arr = self._request_on(parts[0][0], "pull", str(k),
                                       min_version)[1]
            else:
                reps = self._request_many([
                    (s, ("pull", str(k), min_version)) for s, _, _ in parts])
                flat = _np.empty(dsts[0].size, dtype=reps[0][1].dtype)
                for (s, lo, hi), rep in zip(parts, reps):
                    flat[lo:hi] = rep[1]
                arr = flat.reshape(dsts[0].shape)
            for dst in dsts:
                with torch.no_grad():
                    dst._data.copy_(torch.from_numpy(arr).reshape(
                        dst._data.shape))
            results.append(o)
        return out

    def row_sparse_pull(self, key, out=None, priority=0, row_ids=None):
        keys = _as_list(key)
        outs = _as_list(out)
        ids = _as_list(row_ids)
        for k, o, rid in zip(keys, outs, ids):
            min_version = self._pull_version.get(str(k)) if self._sync else None
            rid_np = rid.asnumpy().astype(_np.int64)
            dsts = _as_list(o)
            parts = self._partition(str(k), dsts[0].size)
            if parts[0][1] is None:
                rows = self._request_on(parts[0][0], "row_sparse_pull",
                                        str(k), rid_np, min_version)[1]
            else:
                # sliced key: rows may straddle server boundaries, so
                # reassemble the flat value and gather the requested rows
                reps = self._request_many([
                    (s, ("pull", str(k), min_version)) for s, _, _ in parts])
                flat = _np.empty(dsts[0].size, dtype=reps[0][1].dtype)
                for (s, lo, hi), rep in zip(parts, reps):
                    flat[lo:hi] = rep[1]
                rows = flat.reshape(dsts[0].shape)[rid_np]
            for dst in dsts:
                # local-kvstore semantics: full-shape out, requested rows
                # filled, others zero (kvstore.h:209-223)
                full = _np.zeros(dst.shape, dtype=rows.dtype)
                full[rid_np] = rows
                with torch.no_grad():
                    dst._data.copy_(torch.from_numpy(full))
        return out

    def set_optimizer(self, optimizer):
        if self._rank == 0:
            for srv in self._servers:  # in-process tier: rank 0 authorizes
                srv.allow_pickle_optimizer = True
            blob = pickle.dumps(optimizer)
            for s in range(self._n_servers):
                self._request_on(s, "set_optimizer", blob)
        self.barrier()

    def set_gradient_compression(self, compression_params):
        super().set_gradient_compression(compression_params)
        # every worker must call this (reference requirement); the server
        # keeps the first params and needs them before any push_c arrives,
        # which the barrier guarantees
        for s in range(self._n_servers):
            self._request_on(s, "set_compression",
                             self._grad_compression.wire_params())
        self.barrier()

    @property
    def rank(self):
        return self._rank

    @property
    def num_workers(self):
        return self._num

    def barrier(self):
        self._barrier_seq += 1
        self._request("barrier", f"b{self._barrier_seq}")

    def num_dead_node(self, node_id=0, timeout=60):
        """Reference: KVStore::get_num_dead_node via ps-lite heartbeats
        (include/mxnet/kvstore.h:353)."""
        return int(self._request("num_dead_node", float(timeout))[1])

    def set_server_profiler_state(self, state, server=None):
        """Toggle the remote servers' profiler (reference:
        MXSetProcessProfilerState with profile_process='server' →
        KVStoreServerProfilerCommand, include/mxnet/kvstore.h:49-51)."""
        targets = range(self._n_servers) if server is None else [server]
        for srv in targets:
            self._request_on(srv, "profiler", "state", state)

    def set_server_profiler_config(self, filename="server_profile.json",
                                   server=None):
        targets = range(self._n_servers) if server is None else [server]
        for srv in targets:
            self._request_on(srv, "profiler", "set_config", filename)

    def dump_server_profile(self, format="table", server=0):
        """Fetch a server's profiler dump over the wire (format="json"
        returns chrome://tracing events; reference:
        tests/nightly/test_server_profiling.py flow)."""
        return self._request_on(server, "profiler", "dump", format)[1]

    def dump_server_profile_file(self, server=None):
        """Ask servers to write their configured chrome-trace file
        (reference MXDumpProfile with profile_process='server')."""
        targets = range(self._n_servers) if server is None else [server]
        for srv in targets:
            self._request_on(srv, "profiler", "dump_file", "")

    def _barrier_before_exit(self):
        self.close()

    def close(self):
        if self._hb_stop.is_set():
            return
        self._hb_stop.set()
        for s in range(self._n_servers):
            try:
                # no retries at teardown: a dead server must not stall exit
                self._request_on(s, "shutdown", retries=0)
            except (MXNetError, ConnectionError, OSError):
                pass
        for sock in self._socks:
            try:
                sock.close()
            except OSError:
                pass

    def __del__(self):
        try:
            self.close()
        except Exception:
            pass
