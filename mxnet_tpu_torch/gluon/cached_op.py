"""A hybridized block's program (the reference's CachedOp).

PyTorch counterpart of ``mxnet_tpu/gluon/block.py`` ``_call_cached`` /
``_build_cached_op``.  A :class:`CachedProgram` is one input signature's
program: a pure function of (parameters, aux state, inputs, key) that runs
the block's forward with

- the stream swapped for a :class:`random.LazyKey` rooted at the call's key
  (drawn from the stream by the caller, one draw a call), so each active
  child block's call splits it and each random op consumes a split, as in
  the reference's trace;
- the layers' state writes (BatchNorm's running statistics) captured
  (``parameter.capture_writes``) and committed in place after the call;
- ``autograd`` in training mode ``is_train`` and recording off.

On a CPU tensor the function runs as it is on every call.  On a CUDA
tensor it is captured: after two warm-up runs on a side stream, its
forward (and, when gradients are needed, its backward through
``torch.autograd.grad``) become ``torch.cuda.CUDAGraph``s over static
input buffers and the parameters' own storage, replayed on every call.
The inputs are copied into the static buffers, the random ops' keys are
computed on the host from the call's key and copied into the capture's
own key table, the outputs are cloned, and the backward's gradients come
back through a ``torch.autograd.Function``.  A capture whose forward
still waits for its backward (a block called twice before one backward:
shared weights, a siamese pair) is busy, and the call replays another
capture of the same signature, captured anew when none is free; a
capture is free again after its backward or once its outputs' graph is
dropped.  A program whose parameters moved (a cast,
``initialize(force_reinit=True)``, a rebinding ``set_data``) is stale and
is built again.  A forward that syncs with the host (a ``Custom`` op:
its Python body reads its inputs) cannot be captured: the warm-up sees it
(:func:`note_host_sync`), and the program runs uncaptured on every call,
logged once and counted in :data:`UNCAPTURED`.

The kernel wrappers' ``.launches`` counters count launches: the warm-ups
launch and count; a capture only records, so what it counted is taken
back and added again on each replay of the graph that holds it.
"""
from __future__ import annotations

import contextlib
import logging
import threading
import weakref

import numpy as np
import torch

from .. import autograd
from .. import random as _random
from ..base import MXNetError
from ..ops.capture import add_counts, capture_graph, warm_up
from .parameter import capture_writes

__all__ = ["CachedProgram", "in_program", "program_scope", "flatten",
           "unflatten", "note_host_sync", "UNCAPTURED"]

_tls = threading.local()
_WARMUP = 2

#: programs that run uncaptured on the card because their forward syncs
#: with the host, and the calls they ran so
UNCAPTURED = {"programs": 0, "calls": 0}


def in_program() -> bool:
    """True inside a program's forward (or ``block_train_fn``'s functional
    call): an active block called there runs its forward under a split
    key instead of a program of its own."""
    return getattr(_tls, "depth", 0) > 0


def note_host_sync(what: str) -> None:
    """Called by an op whose body syncs with the host (``Custom``): inside
    a program's forward it marks the program as one that cannot be
    captured."""
    if in_program():
        _tls.host_sync = what


@contextlib.contextmanager
def program_scope():
    _tls.depth = getattr(_tls, "depth", 0) + 1
    try:
        yield
    finally:
        _tls.depth -= 1


def flatten(obj, acc):
    """Replace every tensor of a nested list/tuple by a placeholder,
    appending the tensors to ``acc`` in order."""
    if isinstance(obj, torch.Tensor):
        acc.append(obj)
        return "__t__"
    if isinstance(obj, (list, tuple)):
        return type(obj)(flatten(o, acc) for o in obj)
    return obj


def unflatten(struct, it):
    if isinstance(struct, str) and struct == "__t__":
        return next(it)
    if isinstance(struct, (list, tuple)):
        return type(struct)(unflatten(o, it) for o in struct)
    return struct


class _Pending:
    """Held by a replayed forward's autograd node until its backward."""

    __slots__ = ("__weakref__",)


class _Capture:
    """One captured forward (and backward) of a program, with its own
    static inputs, outputs and key table."""

    def __init__(self):
        self.fwd = None
        self.bwd = None
        self.paths = {}             # key path -> row of the key table
        self.table = None
        self.fwd_launches = []      # each counter's launches a replay
        self.bwd_launches = []
        self.pending = None         # weakref to the forward's _Pending
        self.static_args = []
        self.outs = []
        self.aux = []
        self.out_struct = None
        self.grad_out_idx = []      # outputs that take a gradient
        self.static_gouts = []
        self.static_grads = []
        self.gen = 0

    def busy(self) -> bool:
        """Its forward's activations wait for their backward."""
        return self.pending is not None and self.pending() is not None


class _Replay(torch.autograd.Function):
    """Forward: replay the captured forward; backward: the captured
    backward."""

    @staticmethod
    def forward(ctx, prog, cap, args, *grad_inputs):
        outs = prog._replay(cap, args)
        ctx.prog, ctx.cap, ctx.gen = prog, cap, cap.gen
        ctx.pending = _Pending()
        cap.pending = weakref.ref(ctx.pending)
        ctx.mark_non_differentiable(*[o for i, o in enumerate(outs)
                                      if i not in cap.grad_out_idx])
        return tuple(outs)

    @staticmethod
    @torch.autograd.function.once_differentiable
    def backward(ctx, *gouts):
        cap = ctx.cap
        if ctx.gen != cap.gen:
            raise MXNetError(
                f"{ctx.prog.block.name}: a second backward through a "
                f"retained graph of a captured program, whose capture has "
                f"replayed another forward since; hybridize(False) for it")
        for dst, i in zip(cap.static_gouts, cap.grad_out_idx):
            g = gouts[i]
            if g is None:
                dst.zero_()
            else:
                dst.copy_(g)
        cap.bwd.replay()
        add_counts(cap.bwd_launches)
        cap.pending = None
        grads = [None if g is None else g.clone() for g in cap.static_grads]
        return (None, None, None) + tuple(grads)


class CachedProgram:
    """One input signature's program of ``block`` (see the module doc)."""

    def __init__(self, block, arg_struct, is_train: bool):
        self.block = block
        self.arg_struct = arg_struct
        self.is_train = is_train
        pd = block.collect_params()
        self.params = list(pd.values())
        self._ptrs = self._pointers()
        self._root = None            # this call's key (host uint32[2])
        self._mode = "host"
        self._cap = None             # the capture being warmed up/captured
        self._captures = {}          # signature -> [_Capture]
        self._host_only = None       # what kept the program uncaptured

    # -- staleness ------------------------------------------------------------
    def _pointers(self):
        return tuple((p._tensor().data_ptr(), p._tensor().dtype,
                      p._tensor().requires_grad) for p in self.params)

    def stale(self) -> bool:
        """The parameters' storage moved since the program was built."""
        return self._pointers() != self._ptrs

    # -- keys -------------------------------------------------------------------
    def key_tensor(self, key, device) -> torch.Tensor:
        """A random op's key inside the program: computed from this call's
        key on the host, or (captured) a row of the key table."""
        if self._mode == "capture":
            row = self._cap.paths.get(key.path)
            if row is None:
                raise MXNetError(f"{self.block.name}: a random op drew a key "
                                 f"the warm-up did not (the forward is not "
                                 f"static)")
            return self._cap.table[row]
        if self._mode == "warmup":
            self._cap.paths.setdefault(key.path, len(self._cap.paths))
        return _random.key_tensor(key.value(self._root), device)

    def _fill_table(self, cap):
        """``cap``'s key table from this call's key."""
        if not cap.paths:
            return
        rows = sorted(cap.paths.items(), key=lambda kv: kv[1])
        host = np.empty((len(rows), 2), dtype=np.int64)
        for (path, row) in rows:
            host[row] = _random.LazyKey(self, path).value(self._root)
        cap.table.copy_(torch.from_numpy(host))

    # -- the pure function ----------------------------------------------------
    def _forward(self, args):
        """(flat outputs, output structure, {param: new aux value})."""
        from .block import Block

        slots = [(blk, attr, blk._parameters[attr])
                 for p in self.params for blk, attr in p._owners]
        old_key = _random.swap_key(_random.LazyKey(self))
        try:
            with program_scope(), capture_writes() as cap, \
                    autograd.pause(train_mode=self.is_train):
                call_args = unflatten(self.arg_struct, iter(args))
                out = Block.__call__(self.block, *call_args)
        finally:
            _random.swap_key(old_key)
            for blk, attr, t in slots:
                blk._parameters[attr] = t
        flat = []
        struct = flatten(out, flat)
        by_name = {p.name: p for p in self.params}
        aux = [(by_name[n], v) for n, v in cap.writes.items()]
        return flat, struct, aux

    @staticmethod
    def _commit(aux):
        with torch.no_grad():
            for p, v in aux:
                p._tensor().copy_(v)

    # -- calls ------------------------------------------------------------------
    def __call__(self, args, key, need_grad: bool, capture=None):
        """Run the program on the flat input tensors ``args`` with the
        host key ``key``; returns the block's output structure.
        ``capture`` (default: the inputs are on a CUDA device) replays the
        captured graphs; ``capture=False`` runs the same function
        uncaptured."""
        self._root = key
        if capture is None:
            capture = bool(args) and args[0].device.type == "cuda"
        cap = None
        if capture and self._host_only is None:
            sig = (need_grad, tuple(a.requires_grad for a in args))
            caps = self._captures.setdefault(sig, [])
            cap = next((c for c in caps if not c.busy()), None)
            if cap is None:
                cap = self._capture(args, need_grad)
                if cap is not None:
                    caps.append(cap)
        if cap is None:
            if capture:
                UNCAPTURED["calls"] += 1
            self._mode = "host"
            with torch.set_grad_enabled(need_grad):
                flat, struct, aux = self._forward(args)
            self._commit(aux)
            return unflatten(struct, iter(flat))
        if not need_grad:
            outs = self._replay(cap, args)
        else:
            grad_inputs = [p._tensor() for p in self.params
                           if p._tensor().requires_grad]
            grad_inputs += [a for a in args if a.requires_grad]
            outs = _Replay.apply(self, cap, args, *grad_inputs)
        return unflatten(cap.out_struct, iter(outs))

    def _replay(self, cap, args):
        for dst, src in zip(cap.static_args, args):
            if dst.data_ptr() != src.data_ptr():
                dst.detach().copy_(src)
        self._fill_table(cap)
        cap.fwd.replay()
        add_counts(cap.fwd_launches)
        cap.gen += 1
        self._commit(cap.aux)
        return [o.detach().clone() for o in cap.outs]

    def _capture(self, args, need_grad: bool):
        """A new capture of the program, or None when its warm-up synced
        with the host (the program then stays uncaptured)."""
        cap = _Capture()
        cap.static_args = [a.detach().clone().requires_grad_(a.requires_grad)
                           for a in args]
        grad_inputs = [p._tensor() for p in self.params
                       if p._tensor().requires_grad] if need_grad else []
        grad_inputs += [a for a in cap.static_args if a.requires_grad]
        saved = [(p, p._tensor().detach().clone()) for p in self.params
                 if not p._tensor().requires_grad]
        self._mode, self._cap = "warmup", cap

        def warmup():
            _tls.host_sync = None
            for _ in range(_WARMUP):
                with torch.set_grad_enabled(need_grad):
                    flat, _, _ = self._forward(cap.static_args)
                diff = [o for o in flat if o.requires_grad]
                if need_grad and diff and grad_inputs:
                    torch.autograd.grad(
                        diff, grad_inputs,
                        grad_outputs=[torch.empty_like(o) for o in diff],
                        allow_unused=True)
                del flat, diff

        def forward():
            with torch.set_grad_enabled(need_grad):
                return self._forward(cap.static_args)

        warm_up(warmup)
        # the warm-ups commit nothing, but restore what a forward may touch
        with torch.no_grad():
            for p, v in saved:
                p._tensor().copy_(v)
        if _tls.host_sync is not None:
            self._host_only, self._mode, self._cap = _tls.host_sync, \
                "host", None
            UNCAPTURED["programs"] += 1
            logging.getLogger(__name__).warning(
                "%s: the forward runs a %s op, which syncs with the host; "
                "the program runs uncaptured (no CUDA graph)",
                self.block.name, self._host_only)
            return None
        cap.table = torch.zeros((max(1, len(cap.paths)), 2),
                                dtype=torch.int64, device=args[0].device)
        self._fill_table(cap)
        self._mode = "capture"
        pool = torch.cuda.graph_pool_handle()
        cap.fwd = torch.cuda.CUDAGraph()
        try:
            (flat, struct, aux), cap.fwd_launches = capture_graph(
                cap.fwd, forward, pool=pool)
            cap.outs, cap.out_struct, cap.aux = flat, struct, aux
            cap.grad_out_idx = [i for i, o in enumerate(flat)
                                if o.requires_grad]
            if need_grad and cap.grad_out_idx and grad_inputs:
                cap.static_gouts = [torch.empty_like(flat[i])
                                    for i in cap.grad_out_idx]
                cap.bwd = torch.cuda.CUDAGraph()
                grads, cap.bwd_launches = capture_graph(
                    cap.bwd, lambda: torch.autograd.grad(
                        [flat[i] for i in cap.grad_out_idx], grad_inputs,
                        grad_outputs=cap.static_gouts, allow_unused=True),
                    pool=pool)
                cap.static_grads = list(grads)
            else:
                cap.grad_out_idx = []
        except MXNetError:
            raise
        except Exception as e:
            raise MXNetError(f"{self.block.name}: the forward cannot be "
                             f"captured as a CUDA graph: {e}") from e
        finally:
            self._mode, self._cap = "host", None
        torch.cuda.synchronize()
        return cap
