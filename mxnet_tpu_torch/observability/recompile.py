"""Recompile explainer and freeze watchdog.

PyTorch counterpart of ``mxnet_tpu/observability/recompile.py``.  The
port compiles no programs at run time, but it keeps a finite set of
program keys (the generation engine's step signatures, one CUDA graph
capture per multi-step key): a new key after warm-up means new set-up
work on the serving path (a capture, a first launch at a new shape).  This
module makes every such miss *explainable* and, optionally, *fatal*:

- each miss is recorded per **call-site** (program kind + the symbol's
  output names — stable across rebinds of the same model, which is exactly
  when recompile bugs bite), diffed against the nearest previously-seen key
  at that site, and turned into a human-readable cause: ``"batch dim
  32→48 (data)"``, ``"dtype float32→bfloat16 (fc1_weight)"``,
  ``"mesh 1→8"``;
- ``TPUMX_EXPLAIN_RECOMPILES=1`` logs each explanation as it happens;
  :func:`last_explanations` exposes the recent ring to code either way;
- ``TPUMX_FREEZE_COMPILES=1`` + :func:`mark_warm` turns the discipline
  into a runtime invariant: any later miss raises
  :class:`FreezeCompilesError` before the step runs.
  ``GenerationService.warmup()`` calls ``mark_warm()``.
"""
from __future__ import annotations

import logging
import os
import threading
from collections import deque
from typing import Dict, List, Optional, Tuple

from ..base import MXNetError

__all__ = ["FreezeCompilesError", "note_hit", "note_miss", "note_cache",
           "mark_warm",
           "is_warm", "explain_key_diff", "last_explanations", "reset"]

logger = logging.getLogger("mxnet_tpu_torch.observability")

_SITE_KEY_HISTORY = 16   # recent keys kept per call-site for diffing
_EXPLANATION_RING = 64

_lock = threading.Lock()
_site_keys: Dict[tuple, "deque"] = {}
_explanations: "deque" = deque(maxlen=_EXPLANATION_RING)
_warm = False


class FreezeCompilesError(MXNetError):
    """A post-warmup compile-cache miss under ``TPUMX_FREEZE_COMPILES=1``."""


def _registry():
    from . import registry

    return registry()


def mark_warm(flag: bool = True) -> None:
    """Declare warmup over: with ``TPUMX_FREEZE_COMPILES=1``, every later
    compile-cache miss raises :class:`FreezeCompilesError`."""
    global _warm
    _warm = bool(flag)


def is_warm() -> bool:
    return _warm


def _explain_enabled() -> bool:
    return os.environ.get("TPUMX_EXPLAIN_RECOMPILES", "0") == "1"


def _freeze_enabled() -> bool:
    return os.environ.get("TPUMX_FREEZE_COMPILES", "0") == "1"


def reset() -> None:
    """Clear warm flag, per-site history and the explanation ring (tests)."""
    global _warm
    with _lock:
        _site_keys.clear()
        _explanations.clear()
    _warm = False


# -- signature diffing --------------------------------------------------------------
def _components(key: tuple) -> Dict[tuple, object]:
    """Flatten an executor cache key into addressable components.

    Keys look like ``(kind, signature, *statics)`` where ``signature`` is
    ``Executor._signature``'s tuple: ``is_train``, per-arg ``(name, shape,
    dtype)``, per-aux ``("aux", name, shape, dtype)``, and an optional
    ``("mesh", axis, ndev, size, batch_args)`` entry.
    """
    out: Dict[tuple, object] = {}
    if not isinstance(key, tuple) or not key:
        return {("key",): key}
    sig = key[1] if len(key) > 1 and isinstance(key[1], tuple) else ()
    for item in sig:
        if isinstance(item, bool):
            out[("is_train",)] = item
        elif isinstance(item, tuple) and len(item) == 3 \
                and isinstance(item[0], str) and isinstance(item[1], tuple):
            out[("arg", item[0])] = (item[1], item[2])
        elif isinstance(item, tuple) and item and item[0] == "aux":
            out[("aux", item[1])] = (item[2], item[3])
        elif isinstance(item, tuple) and item and item[0] == "mesh":
            out[("mesh",)] = item[1:]
        elif isinstance(item, tuple) and item and item[0] == "meshshape":
            out[("meshshape",)] = item[1]
        elif isinstance(item, tuple) and item and item[0] == "spec":
            out[("spec", item[1])] = item[2]
        elif isinstance(item, tuple) and item and item[0] == "pp":
            out[("pp",)] = item[1:]
        elif isinstance(item, tuple) and item and item[0] == "mp_compute":
            out[("mp_compute",)] = item[1]
        else:
            out[("sig", repr(item))] = item
    for i, item in enumerate(key[2:]):
        out[("static", i)] = item
    return out


def _describe(slot: tuple, old, new) -> str:
    if slot[0] in ("arg", "aux"):
        name = slot[1]
        old_shape, old_dt = old if old is not None else (None, None)
        new_shape, new_dt = new if new is not None else (None, None)
        if old is None:
            return f"new input {name!r} {new_shape} {new_dt}"
        if new is None:
            return f"input {name!r} dropped"
        parts = []
        if old_shape != new_shape:
            if (len(old_shape) == len(new_shape) and len(old_shape) > 0
                    and old_shape[1:] == new_shape[1:]):
                parts.append(f"batch dim {old_shape[0]}→{new_shape[0]}")
            else:
                parts.append(f"shape {old_shape}→{new_shape}")
        if old_dt != new_dt:
            parts.append(f"dtype {old_dt}→{new_dt}")
        return f"{', '.join(parts) or 'changed'} ({name})"
    if slot[0] == "mesh":
        old_n = old[1] if old else 1
        new_n = new[1] if new else 1
        return f"mesh {old_n}→{new_n}"
    if slot[0] == "spec":
        # partition-rule layout drift
        return f"spec {old!r}→{new!r} ({slot[1]})"
    if slot[0] == "meshshape":
        def _fmt(ms):
            if not ms:
                return "none"
            return "×".join(f"{a}={n}" for a, n in ms)

        return f"mesh shape {_fmt(old)}→{_fmt(new)}"
    if slot[0] == "pp":
        # 3-axis pipeline drift:
        # "pipeline off→pp=2×mb=8", "pipeline pp=2×mb=8→pp=4×mb=16"
        def _fmt(v):
            return "off" if not v else f"pp={v[0]}×mb={v[1]}"

        return f"pipeline {_fmt(old)}→{_fmt(new)}"
    if slot[0] == "mp_compute":
        def _fmt(v):
            return "on" if v else "off"

        return f"tensor-parallel compute {_fmt(old)}→{_fmt(new)}"
    if slot[0] == "is_train":
        return f"is_train {old}→{new}"
    if slot[0] == "static":
        return f"static component {old!r}→{new!r}"
    return f"{slot}: {old!r}→{new!r}"


def explain_key_diff(old_key: tuple, new_key: tuple) -> List[str]:
    """Human-readable causes for why ``new_key`` missed where ``old_key``
    was cached."""
    old_c, new_c = _components(old_key), _components(new_key)
    causes = []
    for slot in sorted(set(old_c) | set(new_c), key=repr):
        o, n = old_c.get(slot), new_c.get(slot)
        if o != n:
            causes.append(_describe(slot, o, n))
    return causes


def _nearest(keys, new_key: tuple) -> Tuple[Optional[tuple], List[str]]:
    best, best_causes = None, []
    for k in keys:
        causes = explain_key_diff(k, new_key)
        if best is None or len(causes) < len(best_causes):
            best, best_causes = k, causes
    return best, best_causes


def _site_label(site: tuple) -> str:
    if isinstance(site, tuple) and site:
        kind = site[0]
        rest = "/".join(str(s) for s in site[1:3])
        return f"{kind}[{rest}]" if rest else str(kind)
    return str(site)


# -- the hooks the program caches call -----------------------------------------------
def note_hit(site: tuple) -> None:
    kind = site[0] if isinstance(site, tuple) and site else str(site)
    _registry().counter(
        "compile_cache_hits_total", labels={"site": str(kind)},
        help="Executor program-cache hits by call-site kind").inc()


def note_miss(site: tuple, key: tuple) -> None:
    """Record a compile (cache miss), log its cause, and — frozen + warm —
    refuse it.  Raises :class:`FreezeCompilesError` BEFORE the compile."""
    kind = site[0] if isinstance(site, tuple) and site else str(site)
    _registry().counter(
        "compile_cache_misses_total", labels={"site": str(kind)},
        help="Executor program compiles (cache misses) by call-site kind").inc()
    with _lock:
        hist = _site_keys.get(site)
        if hist is None:
            hist = _site_keys[site] = deque(maxlen=_SITE_KEY_HISTORY)
        nearest, causes = _nearest(hist, key)
        hist.append(key)
        if nearest is None:
            causes = ["first compile at this site"]
        record = {"site": _site_label(site), "causes": list(causes),
                  "post_warmup": _warm}
        _explanations.append(record)
    if _explain_enabled():
        logger.warning("recompile at %s: %s", record["site"],
                       "; ".join(causes))
    if _warm and _freeze_enabled():
        raise FreezeCompilesError(
            f"TPUMX_FREEZE_COMPILES=1: post-warmup compile at "
            f"{record['site']}: {'; '.join(causes)} — warm the missing "
            f"shape/dtype/mesh signature before taking traffic, or unset "
            f"the freeze")


def last_explanations(n: Optional[int] = None) -> List[dict]:
    """The most recent miss explanations, oldest first."""
    with _lock:
        out = list(_explanations)
    return out if n is None else out[-n:]


def note_cache(hit: bool, site: tuple, key: tuple) -> None:
    """One program-cache lookup at ``site``: a hit counts, a miss is
    explained and — frozen and warm — refused with
    :class:`FreezeCompilesError` before any set-up work runs."""
    if hit:
        note_hit(site)
    else:
        note_miss(site, key)
