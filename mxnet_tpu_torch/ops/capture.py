"""CUDA-graph capture that keeps the kernel wrappers' launch counts true.

Each hand-written kernel's wrapper adds one to its ``.launches`` counter
where it launches its kernel.  Under capture a wrapper only records its
kernel, so :func:`capture_graph` takes back what was counted while
capturing and returns it as the launches one replay makes; the caller
adds them on each replay with :func:`add_counts`.  Used by hybridized
blocks (:mod:`mxnet_tpu_torch.gluon.cached_op`) and the generation
engine's multi-step program
(:mod:`mxnet_tpu_torch.serving.generation.programs`).
"""
from __future__ import annotations

from typing import Callable, List

import torch


def _launch_counters():
    """The kernel wrappers' launch counters, as (wrapper, attribute)."""
    from . import batch_norm, flash_attention, layer_norm, paged_attention, \
        twobit

    return [(twobit.twobit_pack, "launches"),
            (twobit.twobit_unpack, "launches"),
            (batch_norm.bn_stats, "launches"),
            (batch_norm.bn_normalize, "launches"),
            (layer_norm.layer_norm_fused, "launches"),
            (paged_attention.paged_attention, "launches"),
            (paged_attention.paged_attention, "launches_int8"),
            (flash_attention.flash_attention_forward, "launches"),
            (flash_attention.flash_attention_dq, "launches"),
            (flash_attention.flash_attention_dkv, "launches")]


def counts() -> List[int]:
    return [getattr(f, a) for f, a in _launch_counters()]


def add_counts(delta) -> None:
    for (f, a), d in zip(_launch_counters(), delta):
        if d:
            setattr(f, a, getattr(f, a) + d)


def warm_up(fn: Callable[[], object], device=None) -> None:
    """Run ``fn()`` eagerly on a side stream and wait for it: every kernel
    it launches is built and every library's state set up before a
    capture of the same work."""
    side = torch.cuda.Stream(device)
    side.wait_stream(torch.cuda.current_stream(device))
    with torch.cuda.stream(side):
        fn()
    torch.cuda.current_stream(device).wait_stream(side)
    torch.cuda.synchronize(device)


def capture_graph(graph: torch.cuda.CUDAGraph, fn: Callable[[], object],
                  **graph_kw):
    """Capture ``fn()`` into ``graph`` (``torch.cuda.graph`` with
    ``graph_kw``; :func:`warm_up` the same work first).  Returns ``fn``'s
    output and the launches one replay makes, by counter; what was
    counted while capturing is taken back, also when the capture fails
    (the exception propagates)."""
    start = counts()
    try:
        with torch.cuda.graph(graph, **graph_kw):
            out = fn()
    finally:
        launches = [b - a for a, b in zip(start, counts())]
        add_counts([-d for d in launches])  # recorded, not launched
    return out, launches
