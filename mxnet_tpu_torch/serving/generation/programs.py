"""The generation engine's model steps and block copy.

PyTorch counterpart of ``mxnet_tpu/serving/generation/programs.py``.  ONE
step function serves prefill (B=1, T=seq bucket) and decode
(B=max_slots, T=1) — built from
:func:`~mxnet_tpu_torch.parallel.transformer.transformer_lm_decode` with
the paged-attention kernel (over the float or the int8 pool), plus the
per-row sampler of :mod:`mxnet_tpu_torch.ops.sampling`.  Two multi-token
steps sit beside it:

- **verify** (:meth:`GenerationPrograms.run_verify`): one step over
  ``[pending, d_1..d_s]`` per row (T = Tk, the paged kernels' multi-query
  shapes) followed by :func:`~mxnet_tpu_torch.ops.sampling.
  speculative_verify`;
- **multi-step** (:meth:`GenerationPrograms.run_multistep`): k iterations
  of exactly the T=1 decode math, tokens, positions and counters advanced
  on the device, one host copy of the (S, k) tokens at the end.  On the
  card it is captured once per (S, W, k, kv_dtype) key as a
  ``torch.cuda.CUDAGraph`` over static input buffers (after one eager
  warm-up that launches every kernel, so each is built and initialized
  before capture) and replayed; a capture that fails raises.

:func:`block_copy_pools` is the copy-on-write primitive of prefix caching.

**Model-parallel serving** (``mp_devices > 1``): one process per device,
every rank of a ``{"mp": mp_devices}`` mesh (the whole world) building the
same service.  The parameters are cut per the partition rules
(``shard_rules``, else ``transformer_partition_rules()``).  Two routes,
as in the reference (:attr:`GenerationPrograms.kernel`):

- ``"paged"`` (``n_heads`` and ``d_ff`` divide mp): the blocks are moved
  into the tensor-parallel compute layout once
  (``parallel.transformer.tp_params``); each rank holds its head slice of
  the KV pool, and the model step is
  ``parallel.transformer.transformer_lm_decode_tp``: the paged kernels
  on this rank's heads, one all-reduce after attention-out and one after
  MLP-out, the LM head's partial logits summed, so the logits are whole
  (and the same bytes) on every rank.
- ``"gather"`` (either does not divide): every rank holds the whole pool,
  its parameters stay stored as its blocks and are all-gathered whole
  where a layer reads them (:class:`_GatheredParams`, the storage route's
  ``parallel.mesh.gather``), and attention is the gather+dense path of
  ``transformer_lm_decode``; every rank computes the whole step.

Rank 0 (the leader) schedules and samples; before each device step it
broadcasts the step's host operands over a gloo control group
(:class:`_ModelParallel`), and the other ranks (followers) run the same
step from a thread of their own (:meth:`GenerationPrograms.follow`).
Speculative verify: the followers run the multi-query step and join its
collectives, only the leader runs ``speculative_verify`` (the drafts are
the leader's host work, a draft model whole on the leader's device).
Multi-step decode: every rank samples each iteration's token from the
whole logits with the same keys, so every rank feeds the same token to
the next iteration with no collective of its own.  Under mp the k
iterations run eagerly, as one command: captured as a CUDA graph with
their NCCL all-reduces inside, they ended in an illegal memory access on
the followers on four H100s (PERF.md §6).  Any failure
after a command went out marks the group broken on that rank: the leader
then fails every step, its peers' pending collectives end when its
process exits or at the groups' timeout.

Steps run eagerly (or as graph replays); the KV pools (and the int8
pool's scales) are written in place.  Each distinct ``(kind, batch,
chunk, table width[, k])`` is a signature with hit/miss counts, the int8
pool's keys carrying ``("kv_dtype", "int8")``, and every lookup is noted
at its site (``gen_prefill``, ``gen_decode``, ``gen_verify``,
``gen_multistep``, ``gen_block_copy``) in
:mod:`mxnet_tpu_torch.observability.recompile` before the step runs: under
``TPUMX_FREEZE_COMPILES=1`` after ``mark_warm()`` a new signature (and so
a new graph capture) raises.
"""
from __future__ import annotations

import threading
import time
from collections.abc import Mapping
from datetime import timedelta
from typing import Dict, Optional

import numpy as _np
import torch

from ...base import MXNetError, dtype_name
from ...context import resolve_device
from ...observability import recompile as _recompile
from ...ops.capture import add_counts, capture_graph, warm_up
from ...ops.sampling import sample_logits, speculative_verify
from ...parallel.transformer import (transformer_lm_decode,
                                      transformer_lm_decode_tp)

__all__ = ["GenerationPrograms", "block_copy_pools"]

#: the decode-attention implementation of a single-device service and of
#: the model-parallel route whose heads divide: the CUDA kernel walking
#: the block table (its plain version on CPU tensors)
KERNEL = "paged"


def block_copy_pools(k_pool, v_pool, src: int, dst: int, k_scale=None,
                     v_scale=None) -> None:
    """Copy physical block ``src`` onto ``dst`` across every layer of the
    paged pool, in place — the copy-on-write primitive of prefix caching:
    a writer whose target block is shared gets a private copy before its
    first scatter.  The int8 pool's per-(layer, block, head) scales travel
    with their block (its bits mean nothing without them)."""
    pools = [k_pool, v_pool]
    if k_scale is not None:
        pools += [k_scale, v_scale]
    for t in pools:
        t[:, dst] = t[:, src]


def _last_valid(logits, lengths, T):
    """Logits at the LAST VALID position of each row, which feed the
    sampler (prefill: position len-1 predicts token len; decode: T=1 row
    0)."""
    last_idx = (lengths.long() - 1).clamp(0, T - 1)
    return logits[torch.arange(logits.shape[0], device=logits.device),
                  last_idx]


def _decode(params, cache, tokens, positions, lengths, block_tables, cfg):
    """``transformer_lm_decode`` over ``cache`` (its scales too, for the
    int8 pool); the per-position logits."""
    scales = ({"k_scale": cache.k_scale, "v_scale": cache.v_scale}
              if cache.quantized else {})
    return transformer_lm_decode(
        params, tokens, positions, lengths, cache.k, cache.v, block_tables,
        cfg, attention_kernel=KERNEL, **scales)[0]


def _model_step(params, cache, tokens, positions, lengths, block_tables,
                seeds, counters, temperature, top_k, top_p, *, cfg):
    """One prefill or decode step: the token sampled at each row's last
    valid position, and those logits."""
    logits = _decode(params, cache, tokens, positions, lengths,
                     block_tables, cfg)
    last = _last_valid(logits, lengths, tokens.shape[1])
    next_tokens = sample_logits(last, seeds, counters, temperature, top_k,
                                top_p)
    return next_tokens, last


def _verify_step(params, cache, tokens, positions, lengths, block_tables,
                 seeds, counters, temperature, top_k, top_p, *, cfg):
    """Speculative verify: ONE cache-aware multi-query step over
    ``[pending, d_1..d_s]`` per row, every valid position feeding the
    sampler through ``speculative_verify``.  Returns per-position target
    tokens and the leading accepted-draft count per row."""
    logits = _decode(params, cache, tokens, positions, lengths,
                     block_tables, cfg)
    return speculative_verify(logits, tokens, seeds, counters, temperature,
                              top_k, top_p, lengths)


def _multistep(params, cache, tokens, positions, lengths, block_tables,
               seeds, counters, temperature, top_k, top_p, *, k, cfg):
    """``k`` decode iterations, each exactly the single-step decode math
    (the same (S, 1) model call, the same ``(seed, position)`` sampler
    keying, the same one-position scatter, so tokens and the int8 pool's
    write pattern match the step-at-a-time path).  ``tokens`` /
    ``positions`` / ``counters`` are the first iteration's (S,) values,
    advanced here on the device; rows with ``lengths == 0`` stay inactive
    throughout (null-block writes).  Returns (S, k) int64 tokens."""
    tok, pos, ctr = tokens, positions, counters
    out = []
    for _ in range(k):
        logits = _decode(params, cache, tok[:, None], pos[:, None], lengths,
                         block_tables, cfg)
        tok = sample_logits(logits[:, 0, :], seeds, ctr, temperature,
                            top_k, top_p)
        out.append(tok)
        pos = pos + 1
        ctr = ctr + 1
    return torch.stack(out, dim=1)


class _GatheredParams(Mapping):
    """The whole parameters of the dense gather route, read from this
    rank's stored blocks: each one all-gathered (``parallel.mesh.gather``,
    the storage route's) when a layer reads it and dropped after, so a
    rank holds its blocks and the layer in use.  Every rank runs the same
    step code, so every rank reads them, and gathers, in the same
    order."""

    def __init__(self, blocks, specs, mesh):
        self._blocks, self._specs, self._mesh = blocks, specs, mesh

    def __getitem__(self, name):
        from ...parallel.mesh import gather, sharding_for

        v = self._blocks[name]
        spec = self._specs.get(name)
        return gather(v, sharding_for(self._mesh, *spec)) if spec else v

    def __iter__(self):
        return iter(self._blocks)

    def __len__(self):
        return len(self._blocks)


def _mp_logits(params, cache, tokens, positions, lengths, block_tables, *,
               cfg, mesh, kernel, rows):
    """One model-parallel rank's logits, whole and the same on every
    rank: (B, vocab) at ``rows`` (B,), or (B, T, vocab) with ``rows``
    None.  ``kernel`` is the route (module doc)."""
    scales = ({"k_scale": cache.k_scale, "v_scale": cache.v_scale}
              if cache.quantized else {})
    if kernel == "paged":
        return transformer_lm_decode_tp(
            params, tokens, positions, lengths, cache.k, cache.v,
            block_tables, cfg, mesh, rows, **scales)
    logits = transformer_lm_decode(
        params, tokens, positions, lengths, cache.k, cache.v, block_tables,
        cfg, attention_kernel="gather", **scales)[0]
    if rows is None:
        return logits
    return logits[torch.arange(logits.shape[0], device=logits.device),
                  rows.long()]


def _model_step_mp(params, cache, tokens, positions, lengths, block_tables,
                   seeds, counters, temperature, top_k, top_p, *, cfg, mesh,
                   kernel, sample):
    """:func:`_model_step` of one model-parallel rank: the logits of each
    row's last valid position; only the leader samples (``sample``)."""
    T = tokens.shape[1]
    rows = (lengths.long() - 1).clamp(0, T - 1)
    last = _mp_logits(params, cache, tokens, positions, lengths,
                      block_tables, cfg=cfg, mesh=mesh, kernel=kernel,
                      rows=rows)
    if not sample:
        return None, last
    return sample_logits(last, seeds, counters, temperature, top_k,
                         top_p), last


def _verify_step_mp(params, cache, tokens, positions, lengths, block_tables,
                    seeds, counters, temperature, top_k, top_p, *, cfg, mesh,
                    kernel, leader):
    """:func:`_verify_step` of one model-parallel rank: every rank runs
    the multi-query step (its pool writes, the collectives); the leader
    alone runs the sampler and the acceptance (None elsewhere)."""
    logits = _mp_logits(params, cache, tokens, positions, lengths,
                        block_tables, cfg=cfg, mesh=mesh, kernel=kernel,
                        rows=None)
    if not leader:
        return None
    return speculative_verify(logits, tokens, seeds, counters, temperature,
                              top_k, top_p, lengths)


def _multistep_mp(params, cache, tokens, positions, lengths, block_tables,
                  seeds, counters, temperature, top_k, top_p, *, k, cfg,
                  mesh, kernel):
    """:func:`_multistep` of one model-parallel rank: every rank samples
    each iteration's token from the whole logits with the same keys, so
    the next iteration's input is the same on every rank."""
    tok, pos, ctr = tokens, positions, counters
    rows = torch.zeros_like(lengths)
    out = []
    for _ in range(k):
        logits = _mp_logits(params, cache, tok[:, None], pos[:, None],
                            lengths, block_tables, cfg=cfg, mesh=mesh,
                            kernel=kernel, rows=rows)
        tok = sample_logits(logits, seeds, ctr, temperature, top_k, top_p)
        out.append(tok)
        pos = pos + 1
        ctr = ctr + 1
    return torch.stack(out, dim=1)


#: seconds a control-group operation may wait: a follower idles in one
#: between the leader's commands (the heartbeat keeps it short of this)
_MP_TIMEOUT_S = 120.0


class _ModelParallel:
    """The control plane of a model-parallel service: its mesh, this
    rank's place in it, and the gloo group (timeout ``_MP_TIMEOUT_S``)
    that carries the leader's commands — ``("run", kind, operands)``,
    ``("copy", src, dst)``, ``("noop",)`` and ``("stop",)``.  The leader sends a no-op
    when no command went out for ``heartbeat`` seconds (a fifth of the
    timeout, at most 5), so idle followers never time out and a dead
    follower is seen within that time.  Every command and the step it
    starts run under one lock; a failure after the send marks the group
    :attr:`broken`."""

    def __init__(self, mesh):
        import torch.distributed as dist

        self.mesh = mesh
        self.rank = mesh.axis_index("mp")
        self.leader = self.rank == 0
        ranks = dist.get_process_group_ranks(mesh.group("mp"))
        self.group = dist.new_group(
            ranks, backend="gloo", timeout=timedelta(seconds=_MP_TIMEOUT_S))
        self.src = ranks[0]
        self.heartbeat = min(5.0, _MP_TIMEOUT_S / 5)
        self.lock = threading.Lock()
        self.broken: Optional[BaseException] = None
        self.closed = False
        self._last = time.monotonic()
        self._beat: Optional[threading.Thread] = None
        if self.leader:
            self._beat = threading.Thread(target=self._beat_loop,
                                          name="tpumx-torch-mp-heartbeat",
                                          daemon=True)
            self._beat.start()

    def _send(self, cmd) -> None:
        import torch.distributed as dist

        dist.broadcast_object_list([cmd], src=self.src, group=self.group)
        self._last = time.monotonic()

    def receive(self):
        import torch.distributed as dist

        box = [None]
        dist.broadcast_object_list(box, src=self.src, group=self.group)
        return box[0]

    def command(self, cmd, fn):
        """Send ``cmd`` to the followers, then run ``fn`` (this rank's part
        of the step); returns ``fn()``."""
        with self.lock:
            if self.broken is not None:
                raise MXNetError(
                    f"model-parallel serving: the mp group is broken "
                    f"({self.broken!r})") from self.broken
            if self.closed:
                raise MXNetError("model-parallel serving: the service "
                                 "has stopped")
            try:
                self._send(cmd)
                return fn()
            except BaseException as e:
                self.broken = e
                raise

    def _beat_loop(self) -> None:
        while True:
            time.sleep(self.heartbeat / 2)
            with self.lock:
                if self.closed or self.broken is not None:
                    return
                if time.monotonic() - self._last < self.heartbeat:
                    continue
                try:
                    self._send(("noop",))
                except BaseException as e:  # a follower is gone
                    self.broken = e
                    return

    def close(self) -> None:
        """Leader: tell the followers to stop (once)."""
        with self.lock:
            if self.closed:
                return
            self.closed = True
            if self.leader and self.broken is None:
                try:
                    self._send(("stop",))
                except BaseException as e:
                    self.broken = e
        if self._beat is not None:
            self._beat.join(self.heartbeat)


class _Capture:
    """One captured multi-step program: its graph, the static input
    buffers it reads, the output it writes, and the kernel launches one
    replay makes (by wrapper counter)."""

    __slots__ = ("graph", "inputs", "out", "launches")


class GenerationPrograms:
    """Owns the device-resident parameters, the step functions, the
    multi-step CUDA graphs and the per-signature accounting.
    ``kv_dtype="int8"`` keys every signature with ``("kv_dtype",
    "int8")`` (the steps read the cache's scales with its pools)."""

    #: host dtypes of the step operands, in call order (tokens, positions,
    #: lengths, block_tables, seeds, counters, temperature, top_k, top_p)
    _OPERAND_DTYPES = (_np.int64, _np.int32, _np.int32, _np.int32,
                       _np.int64, _np.int64, _np.float32, _np.int64,
                       _np.float32)
    _TORCH_DTYPES = {_np.int64: torch.int64, _np.int32: torch.int32,
                     _np.float32: torch.float32}

    def __init__(self, params, cfg, compute_dtype=None, device=None,
                 kv_dtype=None, mp_devices: int = 1, shard_rules=None):
        self._cfg = cfg
        self._kv_dtype = kv_dtype
        self._kernel = KERNEL
        self._mp: Optional[_ModelParallel] = None
        if int(mp_devices) > 1:
            self._params = self._place_mp(params, cfg, compute_dtype,
                                          device, int(mp_devices),
                                          shard_rules)
        else:
            self._device = resolve_device(device)
            self._params = {k: torch.as_tensor(v, dtype=compute_dtype,
                                               device=self._device)
                            for k, v in params.items()}
        self._lock = threading.Lock()
        self._stats: Dict[tuple, Dict[str, int]] = {}
        self._graphs: Dict[tuple, _Capture] = {}
        self.captures = 0

    def _place_mp(self, params, cfg, compute_dtype, device, mp, rules):
        """The model-parallel set-up: the ``{"mp": mp}`` mesh over the
        world (started from the launcher's variables if need be), the
        whole params cut per the rules, the route (module doc: the
        tensor-parallel compute layout when ``n_heads`` and ``d_ff``
        divide mp, else the stored blocks behind
        :class:`_GatheredParams`), the control group."""
        from ...parallel.mesh import make_mesh
        from ...parallel.partition_rules import (make_param_specs,
                                                 shard_params,
                                                 validate_rule_axes)
        from ...parallel.transformer import (_live_spec, tp_params,
                                             transformer_partition_rules)

        mesh = make_mesh({"mp": mp}, install=False,
                         device=resolve_device(device))
        self._device = mesh.device
        rules = rules or transformer_partition_rules()
        validate_rule_axes(rules, mesh)
        specs = make_param_specs(
            rules, {k: tuple(_np.shape(v)) for k, v in params.items()},
            mesh, mp_axis="mp")
        blocks = {k: v.to(compute_dtype) if compute_dtype else v
                  for k, v in shard_params(params, specs, mesh).items()}
        self._mp = _ModelParallel(mesh)
        if cfg.n_heads % mp or cfg.d_ff % mp:
            self._kernel = "gather"
            live = {k: _live_spec(sp, mesh) for k, sp in specs.items()}
            return _GatheredParams(blocks, {k: sp for k, sp in live.items()
                                            if sp}, mesh)
        return tp_params(blocks, cfg, mesh, specs)

    @property
    def mp_rank(self) -> int:
        """This process's rank on the mp axis (0 without model
        parallelism)."""
        return 0 if self._mp is None else self._mp.rank

    @property
    def broken(self) -> Optional[BaseException]:
        """The failure that broke the model-parallel group, if any."""
        return None if self._mp is None else self._mp.broken

    @property
    def device(self) -> torch.device:
        return self._device

    @property
    def kernel(self) -> str:
        """The decode-attention implementation: ``"paged"`` (the CUDA
        kernel over the block table), or ``"gather"`` (the dense gather
        route of model parallelism over heads or ``d_ff`` that mp does not
        divide)."""
        return self._kernel

    @property
    def pool_mp(self) -> int:
        """The number of head slices the KV pool is cut into: mp on the
        paged model-parallel route (each rank its heads), else 1."""
        if self._mp is None or self._kernel != "paged":
            return 1
        return int(self._mp.mesh.shape["mp"])

    def _family(self) -> tuple:
        """Key components every signature of this service shares: the
        paged kernel (the gather route's keys carry none, as the
        reference's), and the int8 pool's own program family."""
        fam = (("kernel", KERNEL),) if self._kernel == KERNEL else ()
        if self._kv_dtype == "int8":
            fam += (("kv_dtype", "int8"),)
        return fam

    def _key(self, kind: str, cache, tokens, block_tables) -> tuple:
        sig = (("tokens", tuple(_np.shape(tokens)), "int32"),
               ("block_tables", tuple(_np.shape(block_tables)), "int32"),
               ("kv_pool", cache.shape, dtype_name(cache.k.dtype)))
        return (kind, sig + self._family())

    def _lookup(self, kind: str, key: tuple) -> None:
        """Count the lookup and note it at its site (the reference's site
        names: the kind, ``_paged`` for the paged kernel's model steps,
        ``_int8`` for the int8 pool) — before the step runs, so a frozen
        service raises before any set-up work."""
        with self._lock:
            per = self._stats.get(key)
            hit = per is not None
            if per is None:
                per = self._stats[key] = {"hits": 0, "misses": 0,
                                          "seconds": 0.0}
        site = kind if kind == "gen_block_copy" or self._kernel != KERNEL \
            else f"{kind}_{KERNEL}"
        if self._kv_dtype == "int8":
            site = f"{site}_int8"
        _recompile.note_cache(hit, (site, ("lm",)), key)
        with self._lock:
            per["hits" if hit else "misses"] += 1

    def _account(self, key: tuple, seconds: float) -> None:
        with self._lock:
            self._stats[key]["seconds"] += seconds

    def _put(self, arrays):
        dev = self._device
        return tuple(torch.from_numpy(_np.asarray(a, dt)).to(dev)
                     for a, dt in zip(arrays, self._OPERAND_DTYPES))

    def run(self, kind: str, cache, tokens, positions, lengths,
            block_tables, seeds, counters, temperature, top_k, top_p):
        """Execute one step (host numpy inputs); returns ``(next_tokens
        np(B,), last_logits (B, vocab) tensor)``.  ``cache`` is updated in
        place."""
        t0 = time.perf_counter()
        key = self._key(kind, cache, tokens, block_tables)
        self._lookup(kind, key)
        host = (tokens, positions, lengths, block_tables, seeds, counters,
                temperature, top_k, top_p)
        if self._mp is None:
            next_tokens, last = self._step(cache, host)
        else:
            next_tokens, last = self._mp.command(
                ("run", kind, host), lambda: self._step(cache, host))
        next_tokens = next_tokens.cpu().numpy()  # waits for the device
        self._account(key, time.perf_counter() - t0)
        return next_tokens, last

    def _mp_kw(self) -> dict:
        return {"cfg": self._cfg, "mesh": self._mp.mesh,
                "kernel": self._kernel}

    def _step(self, cache, host, sample: bool = True):
        args = self._put(host)
        with torch.no_grad():
            if self._mp is None:
                return _model_step(self._params, cache, *args,
                                   cfg=self._cfg)
            return _model_step_mp(self._params, cache, *args,
                                  sample=sample, **self._mp_kw())

    def _verify(self, cache, host, leader: bool = True):
        args = self._put(host)
        with torch.no_grad():
            if self._mp is None:
                return _verify_step(self._params, cache, *args,
                                    cfg=self._cfg)
            return _verify_step_mp(self._params, cache, *args,
                                   leader=leader, **self._mp_kw())

    def follow(self, cache) -> None:
        """A follower's loop (model-parallel ranks other than 0): receive
        the leader's commands and run each on this rank's part of
        ``cache`` until ``("stop",)``.  A failure is raised after marking
        the group broken."""
        mp = self._mp
        while True:
            cmd = mp.receive()
            if cmd[0] == "stop":
                return
            try:
                if cmd[0] == "run" and cmd[1] == "gen_verify":
                    self._verify(cache, cmd[2], leader=False)
                elif cmd[0] == "run" and cmd[1] == "gen_multistep":
                    self._multistep(cache, cmd[2][0], cmd[2][1:])
                elif cmd[0] == "run":
                    self._step(cache, cmd[2], sample=False)
                elif cmd[0] == "copy":
                    block_copy_pools(cache.k, cache.v, cmd[1], cmd[2],
                                     cache.k_scale, cache.v_scale)
            except BaseException as e:
                mp.broken = e
                raise

    def close(self) -> None:
        """The leader's stop: the followers' loops end."""
        if self._mp is not None:
            self._mp.close()

    def run_verify(self, cache, tokens, positions, lengths, block_tables,
                   seeds, counters, temperature, top_k, top_p):
        """One speculative verify step: ``tokens`` (S, Tk) holds
        ``[pending, d_1..d_s]`` per row (right-padded; ``lengths`` counts
        the valid columns).  Returns ``(target np(S, Tk), accepted
        np(S,))``.  Site ``gen_verify``."""
        t0 = time.perf_counter()
        key = self._key("gen_verify", cache, tokens, block_tables)
        self._lookup("gen_verify", key)
        host = (tokens, positions, lengths, block_tables, seeds, counters,
                temperature, top_k, top_p)
        if self._mp is None:
            target, accepted = self._verify(cache, host)
        else:
            target, accepted = self._mp.command(
                ("run", "gen_verify", host), lambda: self._verify(cache,
                                                                  host))
        out = torch.cat([target, accepted[:, None]], dim=1).cpu().numpy()
        self._account(key, time.perf_counter() - t0)
        return out[:, :-1], out[:, -1]

    def run_multistep(self, k: int, cache, tokens, positions, lengths,
                      block_tables, seeds, counters, temperature, top_k,
                      top_p):
        """``k`` decode iterations in one dispatch: on one card one replay
        of the key's CUDA graph (captured at its first call), on the CPU
        and under mp (one command) the same function eagerly.
        ``tokens``/``positions``/``counters``
        are the first iteration's (S,) values; returns np (S, k) tokens.
        Each k is its own signature (``("k", k)``, site
        ``gen_multistep``)."""
        t0 = time.perf_counter()
        k = int(k)
        key = self._key("gen_multistep", cache, tokens, block_tables)
        key = (key[0], key[1] + (("k", k),))
        self._lookup("gen_multistep", key)
        host = (tokens, positions, lengths, block_tables, seeds, counters,
                temperature, top_k, top_p)
        if self._mp is None:
            toks = self._multistep(cache, k, host)
        else:
            toks = self._mp.command(("run", "gen_multistep", (k,) + host),
                                    lambda: self._multistep(cache, k, host))
        out = toks.cpu().numpy()  # the one host copy; waits for the device
        self._account(key, time.perf_counter() - t0)
        return out

    def _ms_program(self, k: int, cache, args):
        """The k-iteration function over operand tensors ``args``: the
        single-device decode math, or this model-parallel rank's."""
        if self._mp is None:
            return lambda: _multistep(self._params, cache, *args, k=k,
                                      cfg=self._cfg)
        return lambda: _multistep_mp(self._params, cache, *args, k=k,
                                     **self._mp_kw())

    def _multistep(self, cache, k: int, host):
        """This rank's k iterations: eager on the CPU and under mp, on one
        card one replay of the (k, S, W) graph (captured at its first
        call)."""
        if self._device.type != "cuda" or self._mp is not None:
            with torch.no_grad():
                return self._ms_program(k, cache, self._put(host))()
        gkey = (k,) + tuple(_np.shape(host[3]))
        cap = self._graphs.get(gkey)
        if cap is None:
            cap = self._capture_multistep(k, cache, gkey[1:])
        for buf, a, dt in zip(cap.inputs, host, self._OPERAND_DTYPES):
            buf.copy_(torch.from_numpy(_np.asarray(a, dt)))
        cap.graph.replay()
        add_counts(cap.launches)
        return cap.out

    def _capture_multistep(self, k: int, cache, table_shape):
        """Capture the (S, W, k) multi-step program as a CUDA graph over
        static input buffers.  One eager warm-up on a side stream first
        (all rows inactive: it writes only the null block) launches every
        kernel, so each is built and its library state set up before
        capture.  The launches recorded during capture are taken back;
        each replay adds them."""
        S, W = table_shape
        dev = self._device
        cap = _Capture()
        shapes = ((S,), (S,), (S,), (S, W), (S,), (S,), (S,), (S,), (S,))
        cap.inputs = [torch.zeros(s, dtype=self._TORCH_DTYPES[dt],
                                  device=dev)
                      for s, dt in zip(shapes, self._OPERAND_DTYPES)]
        cap.inputs[-1].fill_(1.0)  # top_p 1: no nucleus filter
        program = self._ms_program(k, cache, cap.inputs)

        cap.graph = torch.cuda.CUDAGraph()
        with torch.no_grad():
            warm_up(program, dev)
            try:
                cap.out, cap.launches = capture_graph(
                    cap.graph, program, capture_error_mode="thread_local")
            except Exception as e:
                raise MXNetError(
                    f"multi-step decode (k={k}, S={S}, W={W}): the program "
                    f"cannot be captured as a CUDA graph: {e}") from e
            torch.cuda.synchronize(dev)
        with self._lock:
            self._graphs[(k, S, W)] = cap
            self.captures += 1
        return cap

    def copy_block(self, cache, src: int, dst: int) -> None:
        """Copy pool block ``src`` onto ``dst`` (scales included for the
        int8 pool) — the copy-on-write append of prefix caching.  One
        signature per pool family (kind ``gen_block_copy``)."""
        t0 = time.perf_counter()
        key = ("gen_block_copy",
               (("kv_pool", cache.shape, dtype_name(cache.k.dtype)),)
               + self._family())
        self._lookup("gen_block_copy", key)
        src, dst = int(src), int(dst)
        copy = lambda: block_copy_pools(  # noqa: E731
            cache.k, cache.v, src, dst, cache.k_scale, cache.v_scale)
        if self._mp is None:
            copy()
        else:
            self._mp.command(("copy", src, dst), copy)
        self._account(key, time.perf_counter() - t0)

    def compile_stats(self) -> Dict[tuple, Dict[str, int]]:
        """Per-signature ``{"hits", "misses", "seconds"}``: a signature's
        first run is its one miss; ``seconds`` is the host wall time of
        all its runs, each ending when the sampled tokens reach the
        host."""
        with self._lock:
            return {k: dict(v) for k, v in self._stats.items()}

    def step_seconds(self) -> Dict[str, dict]:
        """Steps run and their wall seconds, by kind."""
        out: Dict[str, dict] = {}
        with self._lock:
            for (kind, _), per in self._stats.items():
                agg = out.setdefault(kind, {"steps": 0, "seconds": 0.0})
                agg["steps"] += per["hits"] + per["misses"]
                agg["seconds"] += per["seconds"]
        return out

    def compiled_signatures(self) -> int:
        with self._lock:
            return len(self._stats)
