"""mxnet_tpu_torch.checkpoint — async checkpointing for fault-tolerant
training (PyTorch counterpart of ``mxnet_tpu.checkpoint``).

- :class:`CheckpointManager` — atomic write-to-temp-then-rename checkpoint
  directories with a sha256 per file, one background writer thread (the
  train step never waits for the device-to-host copy or the disk),
  retention of the last K checkpoints, and a restore that skips corrupt or
  truncated checkpoints for the previous one.
- :class:`TrainCheckpointer` — the ``Module.fit`` bridge: captures the
  COMPLETE train state (parameters, optimizer state with AMP masters, the
  loss scaler, the random key, the iterator position, the step counters)
  as clones on the step's stream, and restores it under any mesh shape.
- :mod:`.integrity` — the checksum and manifest checks shared with the
  classic ``save_checkpoint``/``load_checkpoint`` prefix-epoch files.

``Module.fit(checkpoint_dir=..., checkpoint_every=N, resume=True)`` is the
one-line spelling; SIGTERM/SIGINT during ``fit`` writes a final
synchronous checkpoint and returns (``fault.preemption``).
"""
from __future__ import annotations

from .integrity import (file_sha256, manifest_path_for, verify_params_file,
                        write_params_manifest)
from .manager import CheckpointInfo, CheckpointManager
from .train_state import (ResumePoint, TrainCheckpointer,
                          capture_train_state, restore_train_state)
from . import integrity
from . import manager
from . import train_state

__all__ = ["CheckpointManager", "CheckpointInfo", "TrainCheckpointer",
           "ResumePoint", "capture_train_state", "restore_train_state",
           "file_sha256", "write_params_manifest", "verify_params_file",
           "manifest_path_for", "integrity", "manager", "train_state"]
