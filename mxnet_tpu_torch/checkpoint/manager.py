"""Async checkpointing: atomic, checksummed, retained.

PyTorch counterpart of ``mxnet_tpu/checkpoint/manager.py``; the files are
the reference's, byte for byte apart from timestamps, so a directory one
package writes restores in the other.

- a checkpoint is a DIRECTORY ``ckpt-<step:010d>/`` holding one ``.npz``
  per array group (params, aux), a pickled optimizer-state tree
  (``opt_state.pkl``, protocol 4: dicts, tuples, ``None`` and numpy
  arrays) and a ``manifest.json`` with the step, the train metadata and a
  sha256 per file;
- commit is atomic: everything is written into a ``.tmp-…`` sibling and
  ``os.rename``'d into place; a crash mid-write leaves a stale tmp dir
  (removed by a later save), never a half-valid checkpoint;
- saves are ASYNC by default: the caller hands over copies of the
  tensors (``Executor.snapshot_arrays``: clones on the step's stream) and
  one background writer thread does the device-to-host copy,
  serialization, hashing and the rename.  ``save`` records a CUDA event
  on the caller's stream after those clones; the writer's copies (into
  pinned host buffers, asynchronous) run on a stream of their own that
  waits on that event, so the caller's stream never waits for the writer
  and the writer never reads a tensor before its clone is done.  At most one save is in flight; a save arriving
  while the writer is busy is SKIPPED (counted);
- retention: after each commit the newest ``keep`` checkpoints survive;
- restore scans newest-first and VALIDATES each candidate (the manifest
  parses, every file is present, every sha256 matches) before trusting
  it: a corrupt or truncated newest checkpoint is skipped (a warning and
  ``checkpoint_restore_fallbacks_total``) for the previous one.

Registry metrics: ``checkpoint_save_seconds``,
``checkpoint_save_bytes_total``, ``checkpoint_saves_total{mode}``,
``checkpoint_save_skipped_total``, ``checkpoint_save_failures_total``,
``checkpoint_last_step``, ``checkpoint_restores_total``,
``checkpoint_restore_seconds``, ``checkpoint_restore_fallbacks_total``.
Spans: ``checkpoint.save_async`` (writer thread), ``checkpoint.save_sync``,
``checkpoint.restore``.
"""
from __future__ import annotations

import json
import logging
import os
import pickle
import queue
import re
import shutil
import tempfile
import threading
import time
from typing import Dict, List, Optional, Tuple

import numpy as _np
import torch

from ..base import MXNetError
from .integrity import file_sha256

__all__ = ["CheckpointManager", "CheckpointInfo"]

_logger = logging.getLogger("mxnet_tpu_torch.checkpoint")

_CKPT_RE = re.compile(r"^ckpt-(\d{10})$")
_OPT_FILE = "opt_state.pkl"
_MANIFEST = "manifest.json"


def _registry():
    from ..observability import registry

    return registry()


def _span(name):
    from ..observability import span

    return span(name, cat="checkpoint")


def _map_tree(fn, tree):
    """``fn`` over every leaf of a tree of dicts, tuples and lists (dicts
    keep their keys, lists become tuples as a pytree map gives them back;
    ``None`` stays ``None``)."""
    if tree is None:
        return None
    if isinstance(tree, dict):
        return {k: _map_tree(fn, v) for k, v in tree.items()}
    if isinstance(tree, (tuple, list)):
        return tuple(_map_tree(fn, v) for v in tree)
    return fn(tree)


def _leaves(tree):
    if isinstance(tree, dict):
        for v in tree.values():
            yield from _leaves(v)
    elif isinstance(tree, (tuple, list)):
        for v in tree:
            yield from _leaves(v)
    elif tree is not None:
        yield tree


def _host(x):
    """A leaf on the host: Python scalars as they are, arrays as numpy
    (bf16 widened to f32: numpy has no bfloat16)."""
    if isinstance(x, (str, bool, int, float)):
        return x
    if isinstance(x, torch.Tensor):
        x = x.detach()
        if x.dtype == torch.bfloat16:
            x = x.float()
        return x.cpu().numpy()
    if hasattr(x, "asnumpy"):
        return x.asnumpy()
    return _np.asarray(x)


def _json_safe(obj):
    """Device/numpy scalars and arrays inside the meta as plain Python —
    run on the WRITER thread, so a device scalar in the meta (the loss
    scaler's state) costs the caller no host read."""
    if isinstance(obj, dict):
        return {str(k): _json_safe(v) for k, v in obj.items()}
    if isinstance(obj, (list, tuple)):
        return [_json_safe(v) for v in obj]
    if isinstance(obj, (str, bool, int, float)) or obj is None:
        return obj
    a = _np.asarray(_host(obj))
    if a.ndim == 0:
        return a.item()
    return a.tolist()


def _ready_events(job) -> Dict[torch.device, "torch.cuda.Event"]:
    """One CUDA event per device of the job's tensors, recorded on the
    caller's current stream there (after the clones the caller made)."""
    devices = {t.device for t in _leaves(job) if isinstance(t, torch.Tensor)
               and t.is_cuda}
    events = {}
    for dev in devices:
        ev = torch.cuda.Event()
        ev.record(torch.cuda.current_stream(dev))
        events[dev] = ev
    return events


def _to_host(job, events):
    """The job with every tensor as numpy.  CUDA tensors are copied into
    pinned host buffers, asynchronously, on a side stream of their device
    that first waits on the caller's event, then the side streams are
    waited for once (a pageable copy a tensor would stall the caller's
    launches while it runs)."""
    if not events:
        return _map_tree(_host, job)
    streams = {dev: torch.cuda.Stream(dev) for dev in events}
    for dev, ev in events.items():
        streams[dev].wait_event(ev)

    def start(x):
        if not (isinstance(x, torch.Tensor) and x.is_cuda):
            return x
        with torch.cuda.stream(streams[x.device]):
            src = x.detach()
            if src.dtype == torch.bfloat16:
                src = src.float()
            dst = torch.empty(src.shape, dtype=src.dtype, pin_memory=True)
            dst.copy_(src, non_blocking=True)
        return dst

    staged = _map_tree(start, job)
    for stream in streams.values():
        stream.synchronize()
    return _map_tree(_host, staged)


class CheckpointInfo:
    """One committed checkpoint: path and parsed manifest."""

    __slots__ = ("path", "step", "manifest")

    def __init__(self, path: str, step: int, manifest: dict):
        self.path = path
        self.step = step
        self.manifest = manifest

    @property
    def meta(self) -> dict:
        return self.manifest.get("meta", {})

    def __repr__(self):
        return f"CheckpointInfo(step={self.step}, path={self.path!r})"


class CheckpointManager:
    """Atomic, checksummed, retained checkpoints under one directory.

    ``save(arrays, opt_tree, meta, step)``: ``arrays`` is ``{group_name:
    {key: array}}`` (tensors, NDArrays or numpy; made numpy on the
    writer), ``opt_tree`` a tree of arrays (the optimizer-state
    structure), ``meta`` a JSON-safe dict (device scalars allowed).
    """

    def __init__(self, directory: str, keep: int = 3):
        if keep < 1:
            raise MXNetError(f"CheckpointManager: keep must be >= 1, "
                             f"got {keep}")
        self.directory = os.path.abspath(directory)
        self.keep = int(keep)
        os.makedirs(self.directory, exist_ok=True)
        self._writer: Optional[threading.Thread] = None
        self._queue: "queue.Queue" = queue.Queue(maxsize=1)
        self._idle = threading.Event()
        self._idle.set()
        self._closed = False
        self._lock = threading.Lock()
        reg = _registry()
        self._h_save = reg.histogram(
            "checkpoint_save_seconds",
            help="wall time of one checkpoint write (capture excluded)")
        self._c_bytes = reg.counter(
            "checkpoint_save_bytes_total",
            help="bytes written across all committed checkpoints")
        self._c_skipped = reg.counter(
            "checkpoint_save_skipped_total",
            help="async saves skipped because the writer was busy")
        self._c_failures = reg.counter(
            "checkpoint_save_failures_total",
            help="checkpoint writes that raised (checkpoint not committed)")
        self._g_last = reg.gauge(
            "checkpoint_last_step",
            help="step of the most recently committed checkpoint")
        self._c_restores = reg.counter(
            "checkpoint_restores_total", help="successful checkpoint restores")
        self._h_restore = reg.histogram(
            "checkpoint_restore_seconds",
            help="wall time of checkpoint discovery + validation + load")
        self._c_fallbacks = reg.counter(
            "checkpoint_restore_fallbacks_total",
            help="corrupt/invalid checkpoints skipped during restore "
                 "in favor of an older retained one")
        #: (mode, seconds, bytes, seconds of them copying to the host) of
        #: this manager's commits, newest last
        self.history: List[Tuple[str, float, int, float]] = []

    # -- save ---------------------------------------------------------------
    def save(self, arrays: Dict[str, Dict[str, object]],
             opt_tree=None, meta: Optional[dict] = None, step: int = 0,
             blocking: bool = True) -> Optional[str]:
        """Write one checkpoint.  ``blocking=False`` hands it to the writer
        thread and returns None at once (or skips it while a save is in
        flight); ``blocking=True`` writes inline and returns the committed
        path."""
        if self._closed:
            raise MXNetError("CheckpointManager is closed")
        job = (arrays, opt_tree, dict(meta or {}), int(step))
        if blocking:
            self.wait()  # an in-flight async save must not race the commit
            with _span("checkpoint.save_sync"):
                return self._write(*job, mode="sync")
        self._ensure_writer()
        with self._lock:
            if not self._idle.is_set():
                self._c_skipped.inc()
                return None
            self._idle.clear()
        events = _ready_events(job[:3])
        # the async save span joins the submitting fit's trace across the
        # writer-thread boundary
        from ..observability import tracing as _tracing

        self._queue.put((job, events, _tracing.current_trace()))
        return None

    def wait(self, timeout: Optional[float] = None) -> bool:
        """Block until no async save is in flight."""
        return self._idle.wait(timeout)

    def close(self, timeout: Optional[float] = None) -> None:
        """Drain the writer and stop accepting saves."""
        self.wait(timeout)
        self._closed = True

    def _ensure_writer(self) -> None:
        if self._writer is not None and self._writer.is_alive():
            return
        t = threading.Thread(target=self._writer_loop,
                             name="tpumx-ckpt-writer", daemon=True)
        self._writer = t
        t.start()

    def _writer_loop(self) -> None:
        from ..observability import tracing as _tracing

        while True:
            job, events, trace_ctx = self._queue.get()
            try:
                with _tracing.use_context(trace_ctx):
                    with _span("checkpoint.save_async"):
                        self._write(*job, mode="async", events=events)
            except Exception as e:  # noqa: BLE001 — a failed save must not
                # kill the writer; the next save gets a fresh chance
                self._c_failures.inc()
                _logger.warning("async checkpoint save failed: %s", e)
            finally:
                self._idle.set()

    def _write(self, arrays, opt_tree, meta, step, mode: str,
               events=None) -> str:
        t0 = time.perf_counter()
        arrays, opt_tree, meta = _to_host((arrays, opt_tree, meta),
                                          events or {})
        t_host = time.perf_counter() - t0
        final = os.path.join(self.directory, f"ckpt-{step:010d}")
        tmp = tempfile.mkdtemp(prefix=f".tmp-ckpt-{step:010d}-",
                               dir=self.directory)
        try:
            files: Dict[str, dict] = {}
            key_lists: Dict[str, List[str]] = {}
            total_bytes = 0
            for group, kv in (arrays or {}).items():
                fname = f"{group}.npz"
                path = os.path.join(tmp, fname)
                as_np = {k: _np.asarray(v) for k, v in kv.items()}
                with open(path, "wb") as f:
                    _np.savez(f, **as_np)
                files[fname] = {"sha256": file_sha256(path),
                                "bytes": os.path.getsize(path)}
                key_lists[group] = sorted(as_np)
                total_bytes += files[fname]["bytes"]
            if opt_tree is not None:
                path = os.path.join(tmp, _OPT_FILE)
                with open(path, "wb") as f:
                    pickle.dump(opt_tree, f, protocol=4)
                files[_OPT_FILE] = {"sha256": file_sha256(path),
                                    "bytes": os.path.getsize(path)}
                total_bytes += files[_OPT_FILE]["bytes"]
            manifest = {
                "format": 1,
                "step": step,
                "saved_unix": time.time(),
                "files": files,
                "keys": key_lists,
                "meta": _json_safe(meta),
            }
            mpath = os.path.join(tmp, _MANIFEST)
            with open(mpath, "w") as f:
                json.dump(manifest, f, indent=1, sort_keys=True)
                f.flush()
                os.fsync(f.fileno())
            if os.path.exists(final):  # re-save of the same step: replace
                shutil.rmtree(final, ignore_errors=True)
            os.rename(tmp, final)
        except BaseException:
            shutil.rmtree(tmp, ignore_errors=True)
            raise
        dt = time.perf_counter() - t0
        self._h_save.observe(dt)
        self._c_bytes.inc(total_bytes)
        _registry().counter(
            "checkpoint_saves_total", labels={"mode": mode},
            help="committed checkpoints by save mode").inc()
        self._g_last.set(step)
        self.history.append((mode, dt, total_bytes, t_host))
        # fault injection: corrupt the checkpoint just committed; restore
        # must fall back to the previous one
        from ..fault import corrupt_checkpoint, injector

        cmode = injector().ckpt_corrupt_mode()
        if cmode:
            corrupt_checkpoint(final, cmode)
        self._gc()
        return final

    # -- discovery / validation ---------------------------------------------
    def list(self) -> List[Tuple[int, str]]:
        """Every committed checkpoint dir as (step, path), newest first."""
        out = []
        try:
            entries = os.listdir(self.directory)
        except OSError:
            return []
        for name in entries:
            m = _CKPT_RE.match(name)
            if m:
                out.append((int(m.group(1)),
                            os.path.join(self.directory, name)))
        return sorted(out, reverse=True)

    def validate(self, path: str) -> Optional[dict]:
        """The checkpoint's manifest when it is intact, else None."""
        mpath = os.path.join(path, _MANIFEST)
        try:
            with open(mpath) as f:
                manifest = json.load(f)
        except (OSError, json.JSONDecodeError):
            return None
        for fname, info in manifest.get("files", {}).items():
            fpath = os.path.join(path, fname)
            if not os.path.exists(fpath):
                return None
            if os.path.getsize(fpath) != info.get("bytes"):
                return None
            if file_sha256(fpath) != info.get("sha256"):
                return None
        return manifest

    def latest(self) -> Optional[CheckpointInfo]:
        """The newest VALID checkpoint; corrupt ones are skipped (warned
        and counted) for the previous one."""
        for step, path in self.list():
            manifest = self.validate(path)
            if manifest is not None:
                return CheckpointInfo(path, step, manifest)
            self._c_fallbacks.inc()
            _logger.warning(
                "checkpoint %s failed validation (corrupt/truncated); "
                "falling back to the previous retained checkpoint", path)
        return None

    # -- restore ------------------------------------------------------------
    def restore(self) -> Optional[Tuple[CheckpointInfo, Dict[str, Dict],
                                        object]]:
        """Load the newest valid checkpoint: ``(info, arrays, opt_tree)``
        with arrays as ``{group: {key: np.ndarray}}``, or None when there
        is no valid checkpoint."""
        t0 = time.perf_counter()
        with _span("checkpoint.restore"):
            info = self.latest()
            if info is None:
                return None
            arrays: Dict[str, Dict[str, _np.ndarray]] = {}
            for fname in info.manifest.get("files", {}):
                if fname == _OPT_FILE or not fname.endswith(".npz"):
                    continue
                group = fname[:-len(".npz")]
                with _np.load(os.path.join(info.path, fname),
                              allow_pickle=False) as z:
                    arrays[group] = {k: z[k] for k in z.files}
                want = set(info.manifest.get("keys", {}).get(group, ()))
                missing = sorted(want - set(arrays[group]))
                if missing:
                    raise MXNetError(
                        f"checkpoint {info.path} group {group!r} is missing "
                        f"key {missing[0]!r} despite a clean checksum")
            opt_tree = None
            opt_path = os.path.join(info.path, _OPT_FILE)
            if os.path.exists(opt_path):
                with open(opt_path, "rb") as f:
                    opt_tree = pickle.load(f)
        self._c_restores.inc()
        self._h_restore.observe(time.perf_counter() - t0)
        return info, arrays, opt_tree

    # -- retention ----------------------------------------------------------
    def _gc(self) -> None:
        for _, path in self.list()[self.keep:]:
            shutil.rmtree(path, ignore_errors=True)
        # stale tmp dirs from a crashed writer
        now = time.time()
        try:
            entries = os.listdir(self.directory)
        except OSError:
            return
        for name in entries:
            if name.startswith(".tmp-ckpt-"):
                path = os.path.join(self.directory, name)
                try:
                    if now - os.path.getmtime(path) > 300:
                        shutil.rmtree(path, ignore_errors=True)
                except OSError:
                    pass
