"""Partition rules: regex -> PartitionSpec sharding of named param trees.

PyTorch counterpart of ``mxnet_tpu/parallel/partition_rules.py``.  An
ORDERED list of ``(regex, spec)`` rules is matched against flattened
parameter names; the resolved spec of each leaf says which mesh axes its
weight, gradient and optimizer state are stored split over.

Semantics (the reference's, unchanged):

- first match wins; later rules never override an earlier match;
- scalars and single-element leaves are never partitioned;
- unmatched params REPLICATE;
- divisibility fallback: when a matched spec names a mesh axis whose size
  does not divide the corresponding dim, axes are DROPPED from the right
  of that dim's entry until the rest divides (never an error);
- the ``FSDP`` sentinel spec shards the first divisible dim on the model
  axis (ZeRO-style fully-sharded storage).

The port runs one process per device, so a "placed" parameter is this
rank's block of it: :func:`shard_params` cuts each rank's block of a whole
array over the port's :class:`~.mesh.Mesh` (:func:`.mesh.shard`),
:func:`gather_params` all-gathers the blocks back into the whole array on
every rank (:func:`.mesh.gather`), and :func:`bytes_per_device` reports
this rank's stored bytes keyed by its device.
"""
from __future__ import annotations

import os
import re
from typing import Dict, List, Optional, Tuple

import numpy as _np
import torch

from ..base import MXNetError
from .mesh import NamedSharding, PartitionSpec, gather, shard

__all__ = ["FSDP", "DEFAULT_FSDP_RULES", "match_partition_rules",
           "resolve_spec", "make_param_specs", "spec_tuple", "spec_str",
           "shard_params", "gather_params", "make_shard_and_gather_fns",
           "rules_from_env", "bytes_per_device", "max_bytes_per_device",
           "rules_compute_partitionable", "validate_rule_axes",
           "mp_compute_enabled", "sharding_for_spec"]

#: sentinel spec: shard the first divisible dim on the model axis
#: (ZeRO/FSDP-style fully-sharded storage)
FSDP = "fsdp"

#: the catch-all rule set used when model parallelism is requested without
#: an explicit rules dict: every non-scalar param fully-shards its first
#: divisible dim on ``mp``
DEFAULT_FSDP_RULES = ((r".*", FSDP),)


def spec_tuple(spec) -> tuple:
    """A PartitionSpec (or tuple/list form, or the ``FSDP`` sentinel) as a
    hashable tuple of per-dim entries (``None``, axis name, or tuple of
    axis names)."""
    if spec is None:
        return ()
    if isinstance(spec, str):
        return (spec,)
    out = []
    for entry in tuple(spec):
        if entry is None:
            out.append(None)
        elif isinstance(entry, (tuple, list)):
            out.append(tuple(str(a) for a in entry))
        else:
            out.append(str(entry))
    return tuple(out)


def spec_str(spec) -> str:
    """Human-readable ``p('dp',None)`` rendering."""
    parts = []
    for entry in spec_tuple(spec):
        if entry is None:
            parts.append("None")
        elif isinstance(entry, tuple):
            parts.append("(" + "+".join(f"'{a}'" for a in entry) + ")")
        else:
            parts.append(f"'{entry}'")
    return "p(" + ",".join(parts) + ")"


def _shape_of(leaf) -> tuple:
    if hasattr(leaf, "shape"):
        return tuple(leaf.shape)
    return tuple(leaf)


def _is_fsdp(spec) -> bool:
    return spec == FSDP or spec == (FSDP,)


def match_partition_rules(rules, params: Dict[str, object]):
    """Match ordered ``(regex, spec)`` rules against a flat name->leaf dict.

    ``params`` maps names to arrays (anything with ``.shape``) or shape
    tuples.  Returns ``{name: raw spec}``: whatever the first matching rule
    carried; unmatched and scalar/size-1 leaves map to ``()``.
    ``re.search`` semantics."""
    compiled = [(re.compile(pat), spec) for pat, spec in rules]
    out = {}
    for name, leaf in params.items():
        shape = _shape_of(leaf)
        if len(shape) == 0 or int(_np.prod(shape)) <= 1:
            out[name] = ()
            continue
        for pat, spec in compiled:
            if pat.search(name) is not None:
                out[name] = spec
                break
        else:
            out[name] = ()
    return out


def resolve_spec(spec, shape: Tuple[int, ...], mesh, mp_axis: str = "mp"):
    """Resolve one raw spec against a concrete shape and mesh (anything
    with ``axis_names`` and an axis -> size ``shape``).

    - the ``FSDP`` sentinel becomes ``mp_axis`` on the first dim the axis
      size divides (replicated when none divides);
    - axes absent from the mesh are dropped;
    - a dim whose size the named axes do not divide drops axes from the
      right until it does;
    - entries beyond ``len(shape)`` and trailing ``None`` are trimmed.

    Returns the resolved spec as a plain tuple."""
    sizes = {str(a): int(mesh.shape[a]) for a in mesh.axis_names}
    if _is_fsdp(spec):
        n = sizes.get(mp_axis, 1)
        if n > 1:
            for dim, d in enumerate(shape):
                if d % n == 0 and d >= n:
                    return tuple(mp_axis if i == dim else None
                                 for i in range(len(shape)))
        return ()
    out: List[object] = []
    for dim, entry in enumerate(spec_tuple(spec)[:len(shape)]):
        if entry is None:
            out.append(None)
            continue
        axes = list(entry) if isinstance(entry, tuple) else [entry]
        axes = [a for a in axes if a in sizes]
        while axes:
            prod = int(_np.prod([sizes[a] for a in axes]))
            if prod <= shape[dim] and shape[dim] % prod == 0:
                break
            axes.pop()  # the minor-most axis goes first
        if not axes:
            out.append(None)
        elif len(axes) == 1:
            out.append(axes[0])
        else:
            out.append(tuple(axes))
    while out and out[-1] is None:
        out.pop()
    return tuple(out)


def make_param_specs(rules, params: Dict[str, object], mesh,
                     mp_axis: str = "mp") -> Dict[str, tuple]:
    """rules + name->leaf/shape dict + mesh -> ``{name: resolved spec}``
    holding ONLY the params that actually shard."""
    raw = match_partition_rules(rules, params)
    out = {}
    for name, spec in raw.items():
        resolved = resolve_spec(spec, _shape_of(params[name]), mesh,
                                mp_axis=mp_axis)
        if any(e is not None for e in resolved):
            out[name] = resolved
    return out


def sharding_for_spec(mesh, spec) -> NamedSharding:
    return NamedSharding(mesh, PartitionSpec(*spec_tuple(spec)))


def shard_params(params: Dict[str, object], specs: Dict[str, object], mesh):
    """This rank's block of each whole array (numpy or tensor) per
    ``specs`` (names without a spec: the whole array), on the mesh's
    device."""
    return {name: shard(v, sharding_for_spec(mesh, specs.get(name, ())))
            for name, v in params.items()}


def gather_params(params: Dict[str, torch.Tensor], mesh=None, specs=None):
    """The whole arrays from this rank's blocks, on every rank (an
    all-gather along each split dim; the checkpoint boundary).  Without a
    mesh or a spec a leaf is already whole and is returned as is."""
    specs = specs or {}
    out = {}
    for name, v in params.items():
        spec = specs.get(name, ())
        out[name] = v if mesh is None or not spec \
            else gather(v, sharding_for_spec(mesh, spec))
    return out


def make_shard_and_gather_fns(specs: Dict[str, object], mesh):
    """``(shard_fn, gather_fn)`` closures over a spec dict and mesh:
    ``shard_fn(whole) -> this rank's blocks``, ``gather_fn(blocks) ->
    whole`` (every rank)."""
    def shard_fn(params):
        return shard_params(params, specs, mesh)

    def gather_fn(params):
        with torch.no_grad():
            return gather_params(params, mesh, specs)

    return shard_fn, gather_fn


def mp_compute_enabled() -> bool:
    """``TPUMX_MP_COMPUTE`` gate (default ON): whether compute-partitionable
    rule sets run the tensor-parallel-compute step; ``=0`` keeps the FSDP
    gather-compute-slice step."""
    return os.environ.get("TPUMX_MP_COMPUTE", "1") != "0"


def rules_compute_partitionable(rules) -> bool:
    """Whether every spec of a rule set is an explicit per-dim placement
    (Megatron column/row style).  A rule carrying the ``FSDP`` sentinel
    makes the whole set storage-only."""
    return not any(_is_fsdp(spec) for _pat, spec in rules or ())


def validate_rule_axes(rules, axis_names, source: str = "shard_rules"):
    """Raise :class:`MXNetError` when a rule names a mesh axis that does
    not exist, naming the rule, the bad axis and the mesh's axes.
    ``axis_names``: the mesh's axis names (a mesh is accepted too)."""
    if not rules:
        return
    if hasattr(axis_names, "axis_names"):
        axis_names = axis_names.axis_names
    known = {str(a) for a in axis_names}
    for pat, spec in rules:
        if _is_fsdp(spec):
            continue
        for entry in spec_tuple(spec):
            if entry is None:
                continue
            for a in entry if isinstance(entry, tuple) else (entry,):
                if str(a) not in known:
                    raise MXNetError(
                        f"{source}: rule {pat!r} names mesh axis {a!r}, "
                        f"which is not in the bound mesh "
                        f"(axes: {sorted(known)})")


def rules_from_env(env: Optional[str] = None):
    """Parse ``TPUMX_SHARD_RULES`` into a rules list, or None when unset.

    Format: semicolon-separated ``regex=spec`` entries, matched in order.
    A spec is comma-separated per-dim entries: an axis name, ``+``-joined
    axis names, or ``-``/``None`` for replicated on that dim; the bare word
    ``fsdp`` is the FSDP sentinel.
    Example: ``TPUMX_SHARD_RULES='.*_weight=mp,-;.*=fsdp'``."""
    if env is None:
        env = os.environ.get("TPUMX_SHARD_RULES", "")
    env = env.strip()
    if not env:
        return None
    rules = []
    for item in env.split(";"):
        item = item.strip()
        if not item:
            continue
        if "=" not in item:
            raise ValueError(
                f"TPUMX_SHARD_RULES entry {item!r} is not 'regex=spec'")
        pat, spec_s = item.rsplit("=", 1)
        spec_s = spec_s.strip()
        if spec_s.lower() == FSDP:
            rules.append((pat, FSDP))
            continue
        entries: List[object] = []
        for dim in spec_s.split(","):
            dim = dim.strip()
            if dim in ("-", "", "None", "none"):
                entries.append(None)
            elif "+" in dim:
                entries.append(tuple(a.strip() for a in dim.split("+")))
            else:
                entries.append(dim)
        while entries and entries[-1] is None:
            entries.pop()
        rules.append((pat, tuple(entries)))
    return rules


# -- live-memory accounting -------------------------------------------------------
def _leaves(arrays):
    if isinstance(arrays, dict):
        for v in arrays.values():
            yield from _leaves(v)
    elif isinstance(arrays, (list, tuple)):
        for v in arrays:
            yield from _leaves(v)
    elif arrays is not None:
        yield getattr(arrays, "_data", arrays)


def bytes_per_device(arrays) -> Dict[torch.device, int]:
    """This rank's stored bytes of a collection (dict / list / tuple,
    nested) of tensors or NDArrays, keyed by device: each process holds
    only its own blocks, so the dict has this rank's device(s)."""
    out: Dict[torch.device, int] = {}
    for t in _leaves(arrays):
        if isinstance(t, torch.Tensor):
            out[t.device] = out.get(t.device, 0) \
                + t.numel() * t.element_size()
    return out


def max_bytes_per_device(arrays) -> int:
    per = bytes_per_device(arrays)
    return max(per.values()) if per else 0
