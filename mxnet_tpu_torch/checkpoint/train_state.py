"""TrainCheckpointer: the fused step's complete train state to disk and
back.

PyTorch counterpart of ``mxnet_tpu/checkpoint/train_state.py``.  What one
training checkpoint carries for an identical resumed loss trajectory:

- parameters and aux states (BatchNorm running statistics), cloned off
  the executor's buffers (``Executor.snapshot_arrays``), whole where a
  mesh stores blocks, so a file restores under any mesh shape;
- the optimizer state: the ``Updater``'s per-slot states, AMP's
  ``(master_f32, inner)`` masters included, cloned the same way;
- the optimizer's host counters (``num_update`` and the per-slot update
  counts: Adam's bias correction reads them);
- the AMP loss scaler's ``(scale, good_steps)``, kept as device scalars
  until the writer thread reads them;
- the random stream's key (``random.get_state()``, the reference's
  ``uint32[2]``; none inside a program);
- the data position: epoch, batches done in it, global step
  (``Module.fit(resume=True)`` fast-forwards the iterator).

Capture runs on the fit thread as clones on the step's stream (the next
step updates the originals in place); the device-to-host copy,
serialization and commit run on the manager's writer thread.  On a mesh
every rank captures (the blocks are gathered) and only rank 0 writes;
``close`` waits for rank 0's writes on every rank.  Restore reads the same
directory on every rank and each cuts its own blocks.
"""
from __future__ import annotations

import logging
from typing import Dict, Optional

import numpy as _np
import torch

from ..base import MXNetError
from .manager import CheckpointManager

__all__ = ["TrainCheckpointer", "ResumePoint", "capture_train_state",
           "restore_train_state"]

_logger = logging.getLogger("mxnet_tpu_torch.checkpoint")


class ResumePoint:
    """Where a restored run continues."""

    __slots__ = ("epoch", "nbatch", "global_step", "step")

    def __init__(self, epoch: int, nbatch: int, global_step: int):
        self.epoch = int(epoch)
        self.nbatch = int(nbatch)          # batches completed in `epoch`
        self.global_step = int(global_step)
        self.step = self.global_step

    def __repr__(self):
        return (f"ResumePoint(epoch={self.epoch}, nbatch={self.nbatch}, "
                f"global_step={self.global_step})")


def _slot_names(mod) -> Dict[int, str]:
    """Updater slot -> parameter name (the ``i * num_device`` scheme)."""
    nslot = len(mod._context)
    return {i * nslot: n for i, n in enumerate(mod._param_names)}


def _pack_states_device(mod, states: Dict) -> Dict:
    """Clone every leaf of the Updater's states, gathered whole where the
    mesh stores this slot's parameter as blocks (a collective)."""
    ex = mod._exec
    names = _slot_names(mod)

    def cp(name, s):
        if s is None:
            return None
        if isinstance(s, (tuple, list)):
            return tuple(cp(name, x) for x in s)
        t = s._data
        if t is None:
            return None
        if name is not None:
            t = ex.spmd_whole(name, t)
        return t.detach().clone()

    with torch.no_grad():
        return {int(k): cp(names.get(int(k)), v) for k, v in states.items()}


def _states_from_host(tree: Dict) -> Dict:
    """Updater states from the pickled host tree: NDArrays over the numpy
    leaves, copied into fresh states at their first use
    (``Updater._state``)."""
    from ..ndarray.ndarray import NDArray

    def un(s):
        if s is None:
            return None
        if isinstance(s, (tuple, list)):
            return tuple(un(x) for x in s)
        if isinstance(s, _np.ndarray):
            return NDArray(torch.from_numpy(_np.array(s)))
        return s
    return {int(k): un(v) for k, v in tree.items()}


def _is_writer(mod) -> bool:
    """Only rank 0 of a mesh writes the checkpoint directory."""
    mesh = getattr(mod._exec, "_spmd_mesh", None) if mod._exec else None
    return mesh is None or mesh.rank == 0


def capture_train_state(mod) -> tuple:
    """A Module's full train state as ``(arrays, opt_tree, meta)``:
    clones on the current stream, no host sync on the calling thread."""
    if mod._exec is None or not mod.params_initialized:
        raise MXNetError("capture_train_state: module is not "
                         "bound/initialized")
    args, aux = mod._exec.snapshot_arrays()
    param_names = set(mod._param_names)
    arrays = {"params": {k: v for k, v in args.items() if k in param_names},
              "aux": aux}
    opt_tree = None
    meta: Dict[str, object] = {}
    if getattr(mod, "_updater", None) is not None:
        opt_tree = _pack_states_device(mod, mod._updater.states)
    if getattr(mod, "_optimizer", None) is not None:
        meta["optimizer"] = {
            "num_update": int(mod._optimizer.num_update),
            "index_update_count": {
                str(k): int(v) for k, v in
                mod._optimizer._index_update_count.items()},
        }
    if getattr(mod, "_loss_scaler", None) is not None:
        # device scalars: the writer thread reads them into the manifest
        s = mod._loss_scaler.state()
        meta["scaler"] = [s[0].clone(), s[1].clone()]
    from .. import random as _random

    rng = _random.get_state()
    if rng is not None:
        meta["rng"] = [int(x) for x in _np.asarray(rng).ravel()]
    return arrays, opt_tree, meta


def restore_train_state(mod, info, arrays, opt_tree) -> ResumePoint:
    """Install a checkpoint loaded by ``CheckpointManager.restore`` into a
    bound Module: parameters, aux states, optimizer state and counters,
    the loss scaler, the random key.  Returns the resume point."""
    ex = mod._exec
    params = arrays.get("params", {})
    missing = sorted(n for n in mod._param_names
                     if n not in params and n in (ex.arg_dict or {}))
    if missing:
        raise MXNetError(
            f"checkpoint {info.path} is missing parameter {missing[0]!r} "
            f"required by the bound symbol ({len(missing)} missing in "
            "total)")
    with torch.no_grad():
        for group, bound in ((params, ex.arg_dict),
                             (arrays.get("aux", {}), ex.aux_dict)):
            for n, v in group.items():
                dst = bound.get(n)
                if dst is None:
                    continue
                whole = ex._spmd_blocks.get(n, tuple(dst.shape))
                if tuple(whole) != tuple(v.shape):
                    raise MXNetError(
                        f"checkpoint {info.path}: parameter {n!r} has shape "
                        f"{tuple(v.shape)}, bound symbol expects "
                        f"{tuple(whole)}")
                dst._data.copy_(ex.spmd_block(n, torch.from_numpy(
                    _np.ascontiguousarray(v)).to(dst._data.device)))
    if getattr(mod, "_sync_params_from_exec", None) is not None:
        mod._sync_params_from_exec()
    if opt_tree is not None and getattr(mod, "_updater", None) is not None:
        mod._updater.states = _states_from_host(opt_tree)
        mod._updater._loaded = set(mod._updater.states)
    meta = info.meta
    opt_meta = meta.get("optimizer")
    if opt_meta and getattr(mod, "_optimizer", None) is not None:
        mod._optimizer.num_update = int(opt_meta["num_update"])
        mod._optimizer._index_update_count = {
            int(k): int(v)
            for k, v in opt_meta["index_update_count"].items()}
    if meta.get("scaler") is not None \
            and getattr(mod, "_loss_scaler", None) is not None:
        s = meta["scaler"]
        mod._loss_scaler.set_state(
            (torch.tensor(float(s[0]), dtype=torch.float32),
             torch.tensor(float(s[1]), dtype=torch.float32)))
    if meta.get("rng") is not None:
        from .. import random as _random

        _random.set_state(_np.asarray(meta["rng"], dtype=_np.uint32))
    return ResumePoint(meta.get("epoch", 0), meta.get("nbatch", 0),
                       meta.get("global_step", info.step))


class TrainCheckpointer:
    """Periodic async and final synchronous checkpoints for
    ``Module.fit``.

    ``every``: the global-step cadence of async saves (0: preemption saves
    only).  ``keep``: checkpoints retained.  The module must be bound with
    initialized parameters and optimizer before ``capture``/``restore``
    (``fit`` sees to it).
    """

    def __init__(self, module, directory: str, every: int = 0,
                 keep: int = 3):
        if not (hasattr(module, "_exec") and hasattr(module, "_updater")):
            raise MXNetError(
                "TrainCheckpointer needs a Module-like with a bound "
                f"executor and updater; got {type(module).__name__}")
        self.module = module
        self.manager = CheckpointManager(directory, keep=keep)
        self.every = int(every or 0)
        self._preempt = None

    # -- preemption wiring --------------------------------------------------
    def attach_preemption(self, handler) -> None:
        self._preempt = handler

    # -- capture ------------------------------------------------------------
    def capture(self) -> tuple:
        return capture_train_state(self.module)

    # -- save ---------------------------------------------------------------
    def save(self, epoch: int, nbatch: int, global_step: int,
             blocking: bool = False) -> None:
        arrays, opt_tree, meta = self.capture()
        if not _is_writer(self.module):
            return
        meta.update({"epoch": int(epoch), "nbatch": int(nbatch),
                     "global_step": int(global_step)})
        self.manager.save(arrays, opt_tree, meta, step=int(global_step),
                          blocking=blocking)

    def after_batch(self, epoch: int, nbatch: int,
                    global_step: int) -> bool:
        """``fit``'s per-batch hook.  True when a preemption fired: the
        final checkpoint has been written SYNCHRONOUSLY and fit must
        return."""
        if self._preempt is not None and self._preempt.poll(global_step):
            _logger.info(
                "preemption signal at epoch %d batch %d (step %d): writing "
                "final synchronous checkpoint", epoch, nbatch, global_step)
            self.save(epoch, nbatch, global_step, blocking=True)
            return True
        if self.every and global_step % self.every == 0:
            self.save(epoch, nbatch, global_step, blocking=False)
        return False

    def close(self) -> None:
        """Wait for the writer; on a mesh every rank then waits for rank
        0, so a restore that follows sees every committed checkpoint."""
        self.manager.close()
        mesh = getattr(self.module._exec, "_spmd_mesh", None)
        if mesh is not None and mesh.size > 1:
            import torch.distributed as dist

            dist.barrier()

    # -- restore ------------------------------------------------------------
    def restore(self) -> Optional[ResumePoint]:
        """Load the newest VALID checkpoint into the module and return the
        resume point, or None when the directory holds none."""
        res = self.manager.restore()
        if res is None:
            return None
        info, arrays, opt_tree = res
        return restore_train_state(self.module, info, arrays, opt_tree)
