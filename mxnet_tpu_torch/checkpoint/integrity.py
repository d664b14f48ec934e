"""Checkpoint file integrity: checksums and manifest validation.

PyTorch-port copy of ``mxnet_tpu/checkpoint/integrity.py``.  Shared by the
async checkpoint manager (a sha256 per file in every checkpoint manifest)
and the classic ``save_checkpoint``/``load_checkpoint`` prefix-epoch
format (a sidecar ``<file>.manifest.json``, the reference's bytes), so a
truncated or bit-flipped checkpoint is caught BEFORE deserialization and
raises an :class:`MXNetError` naming the file and the failing key.
"""
from __future__ import annotations

import hashlib
import json
import os
from typing import Dict, List, Optional

from ..base import MXNetError

__all__ = ["file_sha256", "write_params_manifest", "verify_params_file",
           "manifest_path_for"]

_CHUNK = 1 << 20


def file_sha256(path: str) -> str:
    h = hashlib.sha256()
    with open(path, "rb") as f:
        while True:
            chunk = f.read(_CHUNK)
            if not chunk:
                break
            h.update(chunk)
    return h.hexdigest()


def manifest_path_for(params_path: str) -> str:
    return params_path + ".manifest.json"


def write_params_manifest(params_path: str, keys: List[str]) -> str:
    """Write the sidecar manifest of a params file: its size, sha256 and
    sorted key list (the completeness check on load)."""
    manifest = {
        "format": 1,
        "file": os.path.basename(params_path),
        "bytes": os.path.getsize(params_path),
        "sha256": file_sha256(params_path),
        "keys": sorted(keys),
    }
    path = manifest_path_for(params_path)
    tmp = path + ".tmp"
    with open(tmp, "w") as f:
        json.dump(manifest, f, indent=1, sort_keys=True)
    os.replace(tmp, path)
    return path


def verify_params_file(params_path: str,
                       loaded_keys: Optional[List[str]] = None
                       ) -> Optional[Dict]:
    """Check a params file against its sidecar manifest, when there is one.

    Called once before the load (``loaded_keys=None``: existence, size and
    checksum) and once after it (``loaded_keys=[...]``: every manifest key
    was loaded).  Raises :class:`MXNetError` naming the file or the missing
    key; returns the manifest, or None when there is none (files written
    without one stay loadable)."""
    if not os.path.exists(params_path):
        raise MXNetError(f"checkpoint file {params_path!r} does not exist")
    mpath = manifest_path_for(params_path)
    if not os.path.exists(mpath):
        return None
    try:
        with open(mpath) as f:
            manifest = json.load(f)
    except (json.JSONDecodeError, OSError) as e:
        raise MXNetError(
            f"checkpoint manifest {mpath!r} is unreadable/corrupt: {e}")
    if loaded_keys is None:
        size = os.path.getsize(params_path)
        if "bytes" in manifest and size != manifest["bytes"]:
            raise MXNetError(
                f"checkpoint file {params_path!r} is truncated/corrupt: "
                f"{size} bytes on disk, manifest expects "
                f"{manifest['bytes']}")
        if "sha256" in manifest:
            digest = file_sha256(params_path)
            if digest != manifest["sha256"]:
                raise MXNetError(
                    f"checkpoint file {params_path!r} failed its checksum "
                    f"(sha256 {digest[:12]}… != manifest "
                    f"{manifest['sha256'][:12]}…): the file is corrupt")
    else:
        missing = sorted(set(manifest.get("keys", ())) - set(loaded_keys))
        if missing:
            raise MXNetError(
                f"checkpoint file {params_path!r} is incomplete: manifest "
                f"key {missing[0]!r} is missing from the loaded parameters "
                f"({len(missing)} missing in total)")
    return manifest
