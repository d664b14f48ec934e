#!/usr/bin/env python3
"""The port's multi-process paths over NCCL on four NVIDIA GPUs of one host.

    python3 chip_multicard.py              # a machine with four cards
    python3 chip_multicard.py --rehearse   # the same workers over gloo on
                                           # the CPU, at small sizes
    python3 chip_multicard.py --legs=mp    # some legs only: sp (1-3),
                                           # dp (4), mp (5-8), serve (8),
                                           # module (9)

Run from the repository root.  The script builds the kernels, then starts
itself four times through ``tools/launch.py -n 4`` (``--worker``); worker
r trains on ``cuda:r``, and ``make_mesh`` joins the four into one NCCL
world.  Each worker checks, against the same work done on its own card
alone (the inputs are the same on every rank, from seeds):

1. collectives over ``sp=4``: psum, all_gather and its gradient (NCCL's
   reduce_scatter), reduce_scatter, all_to_all, ppermute and broadcast,
   against the sums and blocks of the whole inputs;
2. attention over ``sp=4`` at the LM's training shape (B=8, T=1024, H=12,
   D=64, causal): the ring (f32), Ulysses dense (f32) and Ulysses-flash
   (f32 and bf16: the flash kernels at T=1024, H=3 a rank) against
   ``local_attention`` and ``flash_attention`` over the whole sequence
   on one card, outputs and q, k, v gradients under ``chip_smoke.TOL``
   (bitwise reported);
3. ``make_sharded_train_step`` at ``dp=2 x sp=2``, GPT-2 width, B=8,
   T=1024: ring, ulysses and ulysses_flash in f32 against ``train_step``
   on one card with the whole sequence's attention (loss 1e-5 relative,
   every gradient 1e-4 normwise), ulysses_flash in bf16 (loss 2e-2);
   step ms of each beside the one-card step;
4. ``DataParallelTrainer`` over ``dp_mesh(4)``: a BatchNorm MLP in f32,
   three plain steps against the mesh-less trainer on the whole batch
   (losses, parameters and running statistics rtol 1e-5), three 2-bit
   steps leaving every rank's parameters bitwise equal; ResNet-50 v1
   channels-last: one f32 plain step at B=32 (8 a card, cuDNN
   deterministic) against the mesh-less trainer's on the whole batch,
   every gradient and running statistic within chip_smoke's floor rule
   (``_tolerance``: the one-card step again with the images moved by
   ~2^-22); then bf16 at B=128 (32 a card), plain and 2-bit, ten steps
   each beside the mesh-less trainer's B=128 on one card, every step
   launching 53 of each BatchNorm kernel (and with 2-bit 193 packs and
   193 unpacks) and one more step profiled for the same counts by
   kernel name: images/s, losses, launches a step;
5. ``make_partitioned_train_step`` at ``mp=4`` and ``dp=2 x mp=2``, both
   routes (compute: tensor parallelism; storage: FSDP), f32, GPT-2
   width, B=8, T=1024, three chained steps against three ``train_step``s
   on one card: loss 1e-5 relative, the first step's gradients and
   ``gather_fn`` of the params and momenta after the third 1e-4
   normwise; step ms beside the one-card step and each rank's stored
   bytes of params + momenta beside the whole; the LM head's two
   choices priced alone at mp=4 (the ``tok_emb`` all-gather the step
   runs, the (B, T, V) logits all-reduce it avoids);
6. ``pipeline_apply_sharded`` at ``pp=4``: the 12 GPT-2 blocks as 4
   stages of 3, 8 microbatches of (1, 1024, 768), outputs and gradients
   against the sequential stack on one card (1e-5 normwise);
7. ``moe_apply_sharded`` at ``ep=4``: one Switch FFN expert (768 -> 3072
   -> 768) a card, 8,192 tokens, against the dense oracle: outputs 1e-5,
   gradients 1e-4 normwise;
8. ``GenerationService`` at ``mp_devices=4`` (3 heads a rank) under the
   reference's default config with chip_smoke's ``serving_default``
   traffic, greedy, float and int8 pools: rank 0's tokens identical to
   one card's ``mp_devices=1`` service, the paged kernel (9 or 10)
   launched on every rank by wrapper and by name; tokens/s and each
   rank's pool bytes beside one card's; then speculative decode (n-gram
   and draft model) and multi-step decode at k=8 (eager under mp, one
   command a k-iteration step) on chip_smoke's greedy
   spec traffic: rank 0's tokens identical to one card's service of the
   same mode, the paged kernel's launches counted on every rank
   (``--legs=serve`` runs the two serving legs alone);
9. ``Module.fit`` over meshes (``TPUMX_DP/MP/PP_DEVICES``), three f32
   batches: dp=4 on the module_fit ResNet-50 symbol (B=128) against a
   one-card run of the same four blocks, mp=4 storage and dp=2 x mp=2
   tensor-parallel compute on a 1024 -> 8192 -> 1024 -> 10 MLP (B=512)
   and pp=4 on an FC stack against one card's ``Module.fit``: losses
   1e-5, parameters 1e-4 (ResNet-50: or 10 x its own noise floor), step
   ms and stored bytes a rank.

Prints each worker's results as one JSON line, the card's name and power
limit, and last ``{"ok": true, "device": {...}}``.  Any failed check, a
worker that fails or hangs, or fewer than four cards: exit non-zero and
no result line.
"""
from __future__ import annotations

import json
import os
import signal
import subprocess
import sys
import time

import numpy as np

SEED = 0
WORKERS = 4
TIMEOUT = 1200
# card sizes, and the rehearsal's (the same code at widths a CPU runs)
SIZES = {
    "card": dict(lm=dict(vocab=50257, d_model=768, n_heads=12, n_layers=12,
                         d_ff=3072, max_len=1024), B=8, T=1024,
                 attn=(8, 1024, 12, 64), resnet_hw=224, resnet_batch=128,
                 resnet_check_batch=32, resnet_steps=10, mp_steps=3,
                 pp_blocks=12, mp_micro=8, moe_tokens=8192,
                 module_resnet_batch=128, module_mlp=(1024, 8192, 10, 512),
                 module_pp=(8, 256, 2048),
                 serve_lm=dict(vocab=50257, d_model=768, n_heads=12,
                               n_layers=12, d_ff=3072, max_len=1024)),
    "rehearse": dict(lm=dict(vocab=256, d_model=32, n_heads=4, n_layers=2,
                             d_ff=64, max_len=64), B=4, T=16,
                     attn=(2, 16, 4, 8), resnet_hw=64, resnet_batch=8,
                     resnet_check_batch=8, resnet_steps=2, mp_steps=3,
                     pp_blocks=4, mp_micro=8, moe_tokens=64,
                     module_resnet_batch=8, module_mlp=(16, 64, 10, 16),
                     module_pp=(8, 16, 16),
                     serve_lm=dict(vocab=256, d_model=32, n_heads=4,
                                   n_layers=2, d_ff=64, max_len=1024)),
}


def _digest(tensors) -> str:
    import hashlib

    h = hashlib.sha256()
    for t in tensors:
        h.update(t.detach().float().cpu().numpy().tobytes())
    return h.hexdigest()


def _sync(dev):
    import torch

    if dev.type == "cuda":
        torch.cuda.synchronize(dev)


def _collectives(m4, dev, bad):
    """Each collective over sp=4 against the whole inputs."""
    import torch

    from mxnet_tpu_torch.parallel import collectives as C

    r = m4.axis_index("sp")
    g = torch.Generator().manual_seed(SEED)
    X = torch.randn(4, 8, 16, generator=g).to(dev)
    cot = torch.randn(32, 16, generator=g).to(dev)
    x = X[r].clone()
    xl = x.clone().requires_grad_()
    with C.spmd(m4):
        got = {"psum": (C.allreduce(x, "sp"), X.sum(0)),
               "all_gather": (C.allgather(x, "sp", axis=0),
                              X.reshape(32, 16)),
               "reduce_scatter": (C.reduce_scatter(x, "sp", axis=0),
                                  X.sum(0)[2 * r:2 * r + 2]),
               "all_to_all": (C.all_to_all(x, "sp", 0, 1),
                              torch.cat([X[j][2 * r:2 * r + 2]
                                         for j in range(4)], 1)),
               "ppermute": (C.ppermute(x, "sp", [(j, (j + 1) % 4)
                                                 for j in range(4)]),
                            X[(r - 1) % 4]),
               "broadcast": (C.broadcast(x, "sp", src=2), X[2])}
        # every rank's cotangent is the same: its block summed 4 times
        (gx,) = torch.autograd.grad(
            (C.allgather(xl, "sp", axis=0) * cot).sum(), xl)
        got["all_gather_grad"] = (gx, 4 * cot[8 * r:8 * r + 8])
    out = {}
    for name, (a, b) in got.items():
        err = (a.detach() - b).abs().max().item()
        out[name] = err
        if not torch.allclose(a.detach(), b, rtol=1e-5, atol=1e-5):
            bad.append(f"{name}: max error {err:.3g}")
    return out


def _attention(m4, dev, size, bad):
    """Ring, Ulysses and Ulysses-flash over sp=4 against the whole
    sequence on this card."""
    import torch

    import chip_smoke as cs
    from mxnet_tpu_torch.ops.flash_attention import flash_attention
    from mxnet_tpu_torch.parallel import collectives as C
    from mxnet_tpu_torch.parallel.mesh import (NamedSharding, PartitionSpec,
                                               gather, shard)
    from mxnet_tpu_torch.parallel.ring_attention import (local_attention,
                                                         ring_attention)
    from mxnet_tpu_torch.parallel.sequence_parallel import ulysses_attention

    B, T, H, D = size["attn"]
    spec = NamedSharding(m4, PartitionSpec(None, "sp"))
    legs = (("ring", "float32"), ("ulysses", "float32"),
            ("ulysses_flash", "float32"), ("ulysses_flash", "bfloat16"))
    out = {}
    for impl, dname in legs:
        dtype = getattr(torch, dname)
        g = torch.Generator().manual_seed(SEED + 1)
        q, k, v, go = (torch.randn(B, T, H, D, generator=g).to(dev, dtype)
                       for _ in range(4))
        leaves = [shard(t, spec).requires_grad_() for t in (q, k, v)]
        with C.spmd(m4):
            if impl == "ring":
                o = ring_attention(*leaves, axis_name="sp", causal=True)
            else:
                o = ulysses_attention(
                    *leaves, axis_name="sp", causal=True,
                    impl="flash" if impl == "ulysses_flash" else "dense")
            grads = torch.autograd.grad(o, leaves, shard(go, spec))
            got = [gather(t.detach(), spec) for t in (o, *grads)]
        whole = [t.clone().requires_grad_() for t in (q, k, v)]
        ref_o = (flash_attention if impl == "ulysses_flash"
                 else local_attention)(*whole, causal=True)
        ref = [ref_o.detach(), *torch.autograd.grad(ref_o, whole, go)]
        errs = {}
        for name, a, b in zip(("out", "dq", "dk", "dv"), got, ref):
            ok, err, _ = cs._close(a, b, dname)
            errs[name] = err
            if not ok:
                bad.append(f"{impl} {dname} {name}: {err:.3g}")
        errs["bitwise"] = all(bool(torch.equal(a, b))
                              for a, b in zip(got, ref))
        out[f"{impl}_{dname}"] = errs
    return out


def _timed(fn, dev, reps=3):
    times, res = [], None
    for _ in range(reps):
        _sync(dev)
        t0 = time.perf_counter()
        res = fn()
        _sync(dev)
        times.append((time.perf_counter() - t0) * 1e3)
    return res, times


def _lm(m22, dev, size, bad):
    """The dp=2 x sp=2 LM step against train_step on this card alone."""
    import functools

    import torch

    import chip_smoke as cs
    from mxnet_tpu_torch.ops.flash_attention import flash_attention
    from mxnet_tpu_torch.parallel.ring_attention import local_attention
    from mxnet_tpu_torch.parallel.transformer import (
        TransformerConfig, make_sharded_train_step, shard_batch, train_step,
        transformer_lm_init)

    cfg = TransformerConfig(**size["lm"])
    B, T = size["B"], size["T"]
    params = transformer_lm_init(cfg, seed=SEED, device=dev)
    zeros = {k: torch.zeros_like(v) for k, v in params.items()}
    tokens = np.random.RandomState(SEED).randint(0, cfg.vocab, (B, T))
    labels = np.roll(tokens, -1, 1)
    batch = shard_batch(m22, tokens, labels, np.arange(T))
    whole = [torch.as_tensor(a, device=dev) for a in (tokens, labels)] \
        + [torch.arange(T, device=dev)]
    attn = {"ring": functools.partial(local_attention, causal=True),
            "ulysses": functools.partial(local_attention, causal=True),
            "ulysses_flash": functools.partial(flash_attention,
                                               causal=True)}
    out = {}
    for impl, dname in (("ring", "float32"), ("ulysses", "float32"),
                        ("ulysses_flash", "float32"),
                        ("ulysses_flash", "bfloat16")):
        dt = None if dname == "float32" else torch.bfloat16
        step = make_sharded_train_step(m22, cfg, sp_impl=impl,
                                       compute_dtype=dt)
        (loss, _, mom), ms = _timed(lambda: step(params, zeros, *batch), dev)
        (ref_loss, _, ref_m), ref_ms = _timed(lambda: train_step(
            params, zeros, *whole, cfg, attention=attn[impl],
            compute_dtype=dt), dev)
        rel = cs._grad_rel_errors(mom, ref_m, zeros, 0.9)
        worst = max(rel, key=rel.get)
        loss_rel = abs(loss.item() - ref_loss.item()) / abs(ref_loss.item())
        out[f"{impl}_{dname}"] = {
            "loss": loss.item(), "one_card_loss": ref_loss.item(),
            "loss_rel_err": loss_rel, "grad_rel_err_max": rel[worst],
            "grad_rel_err_worst": worst, "step_ms": ms,
            "one_card_step_ms": ref_ms,
            "tokens_per_s": B * T / (float(np.median(ms[1:])) / 1e3)}
        if dname == "float32" and (loss_rel > 1e-5 or rel[worst] > 1e-4):
            bad.append(f"{impl} f32: loss {loss_rel:.3g}, gradient of "
                       f"{worst} {rel[worst]:.3g}")
        if dname == "bfloat16" and loss_rel > 2e-2:
            bad.append(f"{impl} bf16: loss {loss_rel:.3g}")
        del mom, ref_m
    return out


def _dp(d4, dev, size, bad):
    """The mesh DataParallelTrainer over dp=4 against the mesh-less one."""
    import torch
    import torch.distributed as dist

    import chip_smoke as cs
    import mxnet_tpu_torch as mx
    from mxnet_tpu_torch import gluon

    r = np.random.RandomState(SEED + 2)
    X = (r.rand(64, 32) * 2 + 1.5).astype(np.float32)
    Y = r.randint(0, 10, 64).astype(np.float32)

    def mlp():
        net = gluon.nn.HybridSequential()
        net.add(gluon.nn.Dense(64, in_units=32), gluon.nn.BatchNorm(),
                gluon.nn.Activation("relu"), gluon.nn.Dense(10, in_units=64))
        net.initialize(ctx=mx.current_context())
        net(torch.as_tensor(X[:4], device=dev))
        w = np.random.RandomState(SEED + 3)
        for p in net.collect_params().values():
            p.set_data(mx.nd.array((w.rand(*p.shape) * 0.2 + 0.4)
                                   .astype(np.float32)))
        return net

    out = {}
    kw = dict(lr=0.1, momentum=0.9, weight_decay=1e-3)
    loss_fn = gluon.loss.SoftmaxCrossEntropyLoss()
    from mxnet_tpu_torch.parallel import DataParallelTrainer

    mesh_tr = DataParallelTrainer(mlp(), loss_fn, mesh=d4, **kw)
    one_tr = DataParallelTrainer(mlp(), loss_fn, **kw)
    losses = [(mesh_tr.step(X, Y).item(), one_tr.step(X, Y).item())
              for _ in range(3)]
    # the two nets' parameters in creation order (their names differ)
    pairs = list(zip([*mesh_tr.params.values(), *mesh_tr.aux.values()],
                     [*one_tr.params.values(), *one_tr.aux.values()]))
    err = max((a - b).abs().max().item() for a, b in pairs)
    out["mlp_plain"] = {"losses": losses, "max_abs_err": err}
    if not all(torch.allclose(a, b, rtol=1e-5, atol=1e-6) for a, b in pairs) \
            or not np.allclose(*zip(*losses), rtol=1e-5):
        bad.append(f"mesh MLP against the one-card trainer: {losses}, "
                   f"parameters {err:.3g}")
    tr = DataParallelTrainer(mlp(), loss_fn, mesh=d4, compression_params={
        "type": "2bit", "threshold": 0.05}, **kw)
    for _ in range(3):
        tr.step(X, Y)
    digests = [None] * dist.get_world_size()
    dist.all_gather_object(digests, _digest(tr.params.values()))
    out["mlp_2bit_replicated"] = len(set(digests)) == 1
    if len(set(digests)) != 1:
        bad.append("2-bit mesh trainer: the ranks' parameters differ")
    # ResNet-50 v1: the synced BatchNorm's step against one card's, f32
    hw = size["resnet_hw"]
    net = cs._resnet(dev, hw=hw)[0]
    x, y = cs._resnet_batch(dev, size["resnet_check_batch"], hw=hw)
    u = torch.rand(x.shape, generator=torch.Generator(device=dev)
                   .manual_seed(SEED + 4), device=dev) * 2 - 1
    state = {}
    for name, mesh, xx in (("mesh", d4, x), ("one_card", None, x),
                           ("moved", None, x * (1 + 2.0 ** -22 * u))):
        tr = cs._trainer(net, mesh=mesh)
        tr.step(xx, y)
        # the momenta from zero are the step's gradients
        state[name] = {**tr.momenta, **tr.aux}
        del tr
    errs = {k: cs._rel(state["mesh"][k], state["one_card"][k])
            for k in state["one_card"]}
    floors = {k: cs._rel(state["moved"][k], state["one_card"][k])
              for k in state["one_card"]}

    def flat(t):
        return torch.cat([state[t][k].flatten() for k in sorted(errs)])

    glob = cs._rel(flat("mesh"), flat("one_card"))
    glob_floor = cs._rel(flat("moved"), flat("one_card"))
    over = cs._tolerance(errs, floors)
    worst = max(errs, key=errs.get)
    out["resnet_f32_step_vs_one_card"] = {
        "global": glob, "floor_global": glob_floor, "worst": worst,
        "max_tensor": errs[worst], "floor_of_worst": floors[worst],
        "over_tolerance": over}
    if over or glob > max(1e-4, 3 * glob_floor):
        bad.append(f"ResNet f32 mesh step against one card's: global "
                   f"{glob:.3g} (floor {glob_floor:.3g}), beyond tolerance "
                   f"{over[:8]}")
    del state
    # bf16, images/s over four cards beside one, and the kernels it ran
    x, y = cs._resnet_batch(dev, size["resnet_batch"], hw=hw)
    comp2 = {"type": "2bit", "threshold": cs.TWOBIT_THRESHOLD}
    n_params = sum(1 for p in net.collect_params().values()
                   if p.grad_req != "null")
    on_card = dev.type == "cuda"
    for name, mesh, comp in (("one_card", None, None), ("mesh", d4, None),
                             ("mesh_2bit", d4, comp2)):
        tr = cs._trainer(net, compute_dtype=torch.bfloat16, mesh=mesh,
                         compression_params=comp)
        coded = n_params if comp is not None and on_card else 0
        want = dict.fromkeys(cs._read_launches(), 0)
        want.update(bn_stats=cs.RESNET_BNS if on_card else 0,
                    bn_normalize=cs.RESNET_BNS if on_card else 0,
                    twobit_pack=coded, twobit_unpack=coded)
        losses, ms, launches = [], [], []
        for _ in range(size["resnet_steps"]):
            cs._reset_launches()
            _sync(dev)
            t0 = time.perf_counter()
            losses.append(tr.step(x, y).item())
            _sync(dev)
            ms.append((time.perf_counter() - t0) * 1e3)
            launches.append(cs._read_launches())
        off = [c for c in launches if c != want]
        if off:
            bad.append(f"ResNet {name}: {len(off)} steps launched other "
                       f"counts than {want}, the first {off[0]}")
        steady = float(np.median(ms[1:]))
        out[f"resnet_{name}"] = {
            "losses": losses, "step_ms": ms, "steady_step_ms": steady,
            "images_per_s": size["resnet_batch"] / (steady / 1e3),
            "launches_per_step": launches[-1]}
        if on_card:
            fam = cs._profiled(lambda: tr.step(x, y), families=(
                "twobit_pack_kernel", "twobit_unpack_kernel",
                "bn_stats_final", "bn_normalize"))["families"]
            out[f"resnet_{name}"]["profiled_families"] = fam
            if fam != {"twobit_pack_kernel": coded,
                       "twobit_unpack_kernel": coded,
                       "bn_stats_final": cs.RESNET_BNS,
                       "bn_normalize": cs.RESNET_BNS}:
                bad.append(f"ResNet {name} profiled step: {fam}")
        if not np.isfinite(losses).all():
            bad.append(f"ResNet {name}: non-finite loss {losses}")
        del tr
    return out


def _rel_err(a, b) -> float:
    return float((a.float() - b.float()).norm()
                 / b.float().norm().clamp_min(1e-30))


def _partitioned(meshes, dev, size, bad):
    """``make_partitioned_train_step`` at mp=4 and dp=2 x mp=2, both
    routes, f32, three chained steps against three ``train_step``s on this
    card alone: the first loss within 1e-5 relative, the first step's
    gradients within 1e-4 normwise, and ``gather_fn`` of the params and
    momenta after the third step within 1e-4 normwise; step ms (medians of
    steps 2-3) beside the one-card step, and this rank's stored bytes of
    params + momenta beside the whole."""
    import torch

    import chip_smoke as cs
    from mxnet_tpu_torch.parallel.mesh import shard, sharding_for
    from mxnet_tpu_torch.parallel.partition_rules import max_bytes_per_device
    from mxnet_tpu_torch.parallel.transformer import (
        TransformerConfig, make_partitioned_train_step, train_step,
        transformer_lm_init)

    cfg = TransformerConfig(**size["lm"])
    B, T = size["B"], size["T"]
    params = transformer_lm_init(cfg, seed=SEED, device=dev)
    zeros = {k: torch.zeros_like(v) for k, v in params.items()}
    tokens = np.random.RandomState(SEED).randint(0, cfg.vocab, (B, T))
    labels = np.roll(tokens, -1, 1)
    pos = torch.arange(T, device=dev)
    whole = [torch.as_tensor(a, device=dev) for a in (tokens, labels)]
    steps = size["mp_steps"]
    p, m, ref_ms, ref_loss = params, zeros, [], []
    for i in range(steps):
        _sync(dev)
        t0 = time.perf_counter()
        loss, p, m = train_step(p, m, *whole, pos, cfg)
        _sync(dev)
        ref_ms.append((time.perf_counter() - t0) * 1e3)
        ref_loss.append(loss.item())
        if i == 0:
            ref_m0 = m
    ref_p, ref_m = p, m
    whole_bytes = 2 * sum(v.numel() * v.element_size()
                          for v in params.values())
    out = {"one_card": {"step_ms": ref_ms, "losses": ref_loss,
                        "params_momenta_bytes": whole_bytes}}
    for name, mesh in meshes.items():
        data = sharding_for(mesh, "dp")
        mine = [shard(a, data) for a in (tokens, labels)]
        for route in ("compute", "storage"):
            step, shard_fn, gather_fn = make_partitioned_train_step(
                mesh, cfg, mp_compute=route == "compute")
            p, m = shard_fn(params), shard_fn(zeros)
            ms, losses = [], []
            for i in range(steps):
                _sync(dev)
                t0 = time.perf_counter()
                loss, p, m = step(p, m, *mine, pos)
                _sync(dev)
                ms.append((time.perf_counter() - t0) * 1e3)
                losses.append(loss.item())
                if i == 0:
                    g0 = cs._grad_rel_errors(gather_fn(m), ref_m0, zeros, 0.9)
            gp, gm = gather_fn(p), gather_fn(m)
            errs = {"loss0": abs(losses[0] - ref_loss[0]) / abs(ref_loss[0]),
                    "grad0": max(g0.values()),
                    "params": max(_rel_err(gp[k], ref_p[k]) for k in gp),
                    "momenta": max(_rel_err(gm[k], ref_m[k]) for k in gm)}
            stored = max_bytes_per_device([p, m])
            out[f"{name}_{route}"] = {
                "losses": losses, "rel_err": errs,
                "grad0_worst": max(g0, key=g0.get), "step_ms": ms,
                "steady_step_ms": float(np.median(ms[1:])),
                "one_card_steady_step_ms": float(np.median(ref_ms[1:])),
                "stored_bytes": stored, "whole_bytes": whole_bytes}
            if errs["loss0"] > 1e-5 or max(
                    errs["grad0"], errs["params"], errs["momenta"]) > 1e-4:
                bad.append(f"partitioned {name} {route}: {errs}")
            del p, m, gp, gm
    out["lm_head"] = _lm_head_costs(meshes["mp4"], params["tok_emb"], B, T,
                                    dev)
    return out


def _lm_head_costs(mesh, tok_emb, B, T, dev):
    """The compute route's two choices for the LM head over mp=4, each
    collective alone (medians of five, ms): all-gather the column-blocked
    ``tok_emb`` (what the step does) against all-reduce the (B, T, V) f32
    partial logits a row-parallel head would need."""
    import torch
    import torch.distributed as dist

    from mxnet_tpu_torch.parallel.mesh import gather, shard, sharding_for

    spec = sharding_for(mesh, None, "mp")
    block = shard(tok_emb, spec)
    partial = torch.zeros(B, T, tok_emb.shape[0], device=dev)

    def median_ms(fn):
        times = []
        for _ in range(6):
            _sync(dev)
            t0 = time.perf_counter()
            fn()
            _sync(dev)
            times.append((time.perf_counter() - t0) * 1e3)
        return float(np.median(times[1:]))

    return {"gather_tok_emb_ms": median_ms(lambda: gather(block, spec)),
            "gather_bytes": tok_emb.numel() * tok_emb.element_size(),
            "allreduce_logits_ms": median_ms(lambda: dist.all_reduce(
                partial, group=mesh.group("mp"))),
            "allreduce_bytes": partial.numel() * partial.element_size()}


def _pipeline(mesh, dev, size, bad):
    """``pipeline_apply_sharded`` at pp=4: GPT-2 blocks as 4 stages,
    ``mp_micro`` microbatches of (1, T, D), outputs and gradients (the
    stacked blocks', the input's) against the sequential stack on this
    card (1e-5 normwise); forward + backward ms of each."""
    import torch

    import chip_smoke as cs
    from mxnet_tpu_torch.parallel.pipeline import pipeline_apply_sharded
    from mxnet_tpu_torch.parallel.transformer import (TransformerConfig,
                                                      transformer_lm_init)

    cfg = TransformerConfig(**dict(size["lm"], n_layers=size["pp_blocks"]))
    params = transformer_lm_init(cfg, seed=SEED + 5, device=dev)
    stage = cs._mp_stage_fn(cfg)
    g = torch.Generator().manual_seed(SEED + 6)
    M, T = size["mp_micro"], size["T"]
    x = torch.randn(M, 1, T, cfg.d_model, generator=g).to(dev)
    c = torch.randn(x.shape, generator=g).to(dev)

    def run(fn, stacked):
        leaves = {k: v.clone().requires_grad_() for k, v in stacked.items()}
        xl = x.clone().requires_grad_()
        _sync(dev)
        t0 = time.perf_counter()
        y = fn(leaves, xl)
        grads = torch.autograd.grad((y * c).sum(), [xl, *leaves.values()])
        _sync(dev)
        return y.detach(), grads, (time.perf_counter() - t0) * 1e3

    stacked = cs._mp_stacked(params, cfg, 4)
    times = []
    for _ in range(size["mp_steps"]):
        y, grads, ms = run(lambda p, xl: pipeline_apply_sharded(
            stage, p, xl, mesh=mesh), stacked)
        times.append(ms)
    flat = cs._mp_stacked(params, cfg, 1)
    seq_times = []
    for _ in range(size["mp_steps"]):
        ys, gs, ms = run(lambda p, xl: torch.stack(
            [stage({k: v[0] for k, v in p.items()}, xl[i])
             for i in range(M)]), flat)
        seq_times.append(ms)
    errs = {"out": _rel_err(y, ys), "grad_x": _rel_err(grads[0], gs[0]),
            "grad_params": max(_rel_err(a.reshape(b.shape), b)
                               for a, b in zip(grads[1:], gs[1:]))}
    if max(errs.values()) > 1e-5:
        bad.append(f"pipeline pp=4 against the sequential stack: {errs}")
    return {"stages": 4, "blocks": size["pp_blocks"], "microbatches": M,
            "rel_err": errs, "fwd_bwd_ms": times,
            "one_card_fwd_bwd_ms": seq_times}


def _moe(mesh, dev, size, bad):
    """``moe_apply_sharded`` at ep=4, one Switch FFN expert (D -> d_ff ->
    D, GELU) a card, ``moe_tokens`` tokens: outputs (1e-5 normwise) and
    gradients (1e-4) against the dense oracle on this card; forward +
    backward ms."""
    import torch
    import torch.nn.functional as F

    from mxnet_tpu_torch.parallel.moe import moe_apply_sharded

    D, Fd, N = size["lm"]["d_model"], size["lm"]["d_ff"], size["moe_tokens"]
    g = torch.Generator().manual_seed(SEED + 7)
    x = torch.randn(N, D, generator=g).to(dev)
    c = torch.randn(N, D, generator=g).to(dev)
    rw = torch.randn(D, 4, generator=g).to(dev)
    w_in = (torch.randn(4, D, Fd, generator=g) / D ** 0.5).to(dev)
    w_out = (torch.randn(4, Fd, D, generator=g) / Fd ** 0.5).to(dev)

    def expert(p, h):
        return F.gelu(h @ p["w_in"], approximate="tanh") @ p["w_out"]

    def dense(x_, r_, a, b):
        gate, e = torch.softmax(x_ @ r_, dim=-1).max(dim=-1)
        y = x_.new_zeros(x_.shape)
        for j in range(4):   # each token through its argmax expert
            sel = (e == j).nonzero()[:, 0]
            y = y.index_add(0, sel, gate[sel, None] * expert(
                {"w_in": a[j], "w_out": b[j]}, x_[sel]))
        return y

    def run(fn):
        leaves = [t.clone().requires_grad_() for t in (x, rw, w_in, w_out)]
        _sync(dev)
        t0 = time.perf_counter()
        y = fn(*leaves)
        grads = torch.autograd.grad((y * c).sum(), leaves)
        _sync(dev)
        return y.detach(), grads, (time.perf_counter() - t0) * 1e3

    times, dense_times = [], []
    # capacity factor 4: no token over capacity, so the oracle is exact
    for _ in range(size["mp_steps"]):
        y, grads, ms = run(lambda x_, r_, a, b: moe_apply_sharded(
            x_, r_, {"w_in": a, "w_out": b}, expert, mesh=mesh,
            capacity_factor=4.0))
        times.append(ms)
        yd, gd, ms = run(dense)
        dense_times.append(ms)
    errs = {"out": _rel_err(y, yd)}
    for n, a, b in zip(("x", "router", "w_in", "w_out"), grads, gd):
        errs["grad_" + n] = _rel_err(a, b)
    # the gradients sum 8,192 tokens' terms in another order than the
    # oracle's: the LM step's gradient tolerance
    if errs["out"] > 1e-5 or max(errs.values()) > 1e-4:
        bad.append(f"MoE ep=4 against the dense oracle: {errs}")
    return {"experts": 4, "tokens": N, "d_model": D, "d_ff": Fd,
            "rel_err": errs, "fwd_bwd_ms": times,
            "one_card_dense_fwd_bwd_ms": dense_times}


def _serving(coord, dev, size, bad):
    """``GenerationService`` at ``mp_devices=4`` under the reference's
    default config (preemption, prefix cache) on chip_smoke's
    ``serving_default`` traffic (16 greedy requests in two waves, 32 new
    tokens each), float and int8 pools: rank 0's tokens against one
    card's ``mp_devices=1`` service, every rank's paged kernel (9 float,
    10 int8) by wrapper and by name on its 3 heads; tokens/s and each
    rank's pool bytes beside one card's."""
    import torch
    import torch.distributed as dist
    from torch.profiler import ProfilerActivity, profile

    import chip_smoke as cs
    from mxnet_tpu_torch.ops.paged_attention import paged_attention
    from mxnet_tpu_torch.parallel.transformer import (TransformerConfig,
                                                      transformer_lm_init)
    from mxnet_tpu_torch.serving.generation import (GenerationConfig,
                                                    GenerationService)

    cfg = TransformerConfig(**size["serve_lm"])
    params = transformer_lm_init(cfg, seed=SEED, device=dev)
    waves = cs._default_traffic(cfg)
    rank = dist.get_rank()
    out = {}

    def serve(svc):
        svc.warmup()
        outs, n, t0 = [], 0, time.perf_counter()
        for wave in waves:
            streams = [svc.submit(p) for p in wave]
            got = [st.result(timeout=600) for st in streams]
            outs += got
            n += sum(len(o) for o in got)
        _sync(dev)
        return outs, n / (time.perf_counter() - t0)

    for kv in (None, "int8"):
        tag = kv or "float"
        gen = dict(max_slots=8, block_size=32,
                   num_blocks=cs.DEFAULT_POOL_BLOCKS,
                   seq_buckets=[64, 128, 256, 512], max_new_tokens=32,
                   kv_dtype=kv)
        svc = GenerationService(params, cfg, GenerationConfig(
            mp_devices=4, **gen), device=dev)
        heads = svc._cache.k.shape[3]
        pool_bytes = svc._cache.nbytes()
        cs._reset_launches()
        _sync(dev)
        with profile(activities=[ProfilerActivity.CUDA if dev.type == "cuda"
                                 else ProfilerActivity.CPU]) as prof:
            if rank == 0:
                outs, tps = serve(svc)
            svc.stop()
            _sync(dev)
        names = [e.name for e in prof.events()
                 if e.device_type == torch.autograd.DeviceType.CUDA
                 and "paged_" in e.name]
        key = "paged_attention_int8" if kv else "paged_attention"
        launched = getattr(paged_attention, "launches_int8" if kv
                           else "launches")
        row = {"heads_a_rank": heads, "pool_bytes": pool_bytes,
               "param_bytes": sum(t.numel() * t.element_size() for t in
                                  svc._programs._params.values()),
               "launches": cs._read_launches(),
               "paged_kernels_by_name": len(names),
               "paged_kernel_names": sorted(set(names))}
        if heads != cfg.n_heads // 4 or (dev.type == "cuda" and (
                not launched or not names)):
            bad.append(f"mp=4 serving {tag} on rank {rank}: {heads} heads, "
                       f"{launched} {key} launches, {len(names)} paged "
                       f"kernels by name")
        del svc
        if rank == 0:
            one = GenerationService(params, cfg, GenerationConfig(**gen),
                                    device=dev)
            try:
                ref, ref_tps = serve(one)
                row.update(tokens_per_s=tps, one_card_tokens_per_s=ref_tps,
                           one_card_pool_bytes=one._cache.nbytes(),
                           tokens=sum(len(o) for o in outs),
                           same_tokens=outs == ref,
                           mismatched_requests=sum(
                               a != b for a, b in zip(outs, ref)))
            finally:
                one.stop()
            if outs != ref:
                bad.append(f"mp=4 serving {tag}: tokens differ from one "
                           f"card's in {row['mismatched_requests']} "
                           f"requests")
        dist.barrier(group=coord)
        out[tag] = row
    return out


def _serving_multi_token(coord, dev, size, bad):
    """Speculative decode (n-gram and draft-model proposers, draft_k =
    chip_smoke's SPEC_DRAFT_K) and multi-step decode (k =
    SPEC_MULTISTEP_K, eager under mp: one command a k-iteration step) at
    ``mp_devices=4``, warmed up, on chip_smoke's greedy spec traffic in
    waves of max_slots: rank 0's tokens against one card's
    ``mp_devices=1`` service of the same mode (multi-step there one CUDA
    graph replay); every rank's paged-kernel launches (row 9) by
    wrapper over the warm-up and the traffic, and the spec and multi-step
    step counts; tokens/s beside one card's."""
    import torch.distributed as dist

    import chip_smoke as cs
    from mxnet_tpu_torch.parallel.transformer import (TransformerConfig,
                                                      transformer_lm_init)
    from mxnet_tpu_torch.serving.generation import (GenerationConfig,
                                                    GenerationService)

    cfg = TransformerConfig(**size["serve_lm"])
    params = transformer_lm_init(cfg, seed=SEED, device=dev)
    prompts = [p for i, p in enumerate(cs._spec_traffic(cfg))
               if i not in cs.SPEC_SAMPLED]
    rank = dist.get_rank()
    modes = {"ngram": dict(speculative=True, draft_mode="ngram",
                           draft_k=cs.SPEC_DRAFT_K),
             "model": dict(speculative=True, draft_mode="model",
                           draft_k=cs.SPEC_DRAFT_K,
                           draft_window=cs.SPEC_DRAFT_WINDOW),
             "multistep": dict(multistep_k=cs.SPEC_MULTISTEP_K)}
    out = {}

    def serve(svc, slots):
        outs, t0 = [], time.perf_counter()
        for w in range(0, len(prompts), slots):
            streams = [svc.submit(p) for p in prompts[w:w + slots]]
            outs += [st.result(timeout=600) for st in streams]
        _sync(dev)
        return outs, sum(len(o) for o in outs) / (time.perf_counter() - t0)

    for mode, kw in modes.items():
        gen = dict(max_slots=8, block_size=32,
                   seq_buckets=[64, 128, 256, 512], max_new_tokens=32, **kw)
        draft = (dict(draft_params=params, draft_cfg=cfg)
                 if mode == "model" else {})
        svc = GenerationService(params, cfg, GenerationConfig(
            mp_devices=4, **gen), device=dev, **draft)
        # a follower's steps run on its own thread until the leader stops:
        # each rank counts from before the warm-up to after its stop()
        cs._reset_launches()
        t0 = time.perf_counter()
        svc.warmup()
        warm_s = time.perf_counter() - t0
        if rank == 0:
            outs, tps = serve(svc, gen["max_slots"])
            st = svc.stats()
        row = {"kernel": svc._programs.kernel, "warmup_s": warm_s,
               "captures": svc._programs.captures}
        svc.stop()
        _sync(dev)
        row["launches"] = launches = cs._read_launches()
        if not launches["paged_attention"] and dev.type == "cuda":
            bad.append(f"mp=4 {mode} on rank {rank}: no paged kernel "
                       f"launch")
        del svc
        if rank == 0:
            one = GenerationService(params, cfg, GenerationConfig(**gen),
                                    device=dev, **draft)
            try:
                one.warmup()
                ref, ref_tps = serve(one, gen["max_slots"])
            finally:
                one.stop()
            row.update(tokens_per_s=tps, one_card_tokens_per_s=ref_tps,
                       tokens=sum(len(o) for o in outs),
                       same_tokens=outs == ref,
                       mismatched_requests=sum(
                           a != b for a, b in zip(outs, ref)),
                       speculative=st["speculative"],
                       multistep=st["multistep"],
                       counts={k: st["counts"][k] for k in (
                           "spec_steps", "multistep_steps",
                           "draft_proposed", "draft_accepted", "failed")})
            if outs != ref:
                bad.append(f"mp=4 {mode}: tokens differ from one card's "
                           f"in {row['mismatched_requests']} requests")
            steps = row["counts"]["multistep_steps" if mode == "multistep"
                                  else "spec_steps"]
            if not steps or row["counts"]["failed"]:
                bad.append(f"mp=4 {mode}: {row['counts']}")
        dist.barrier(group=coord)
        out[mode] = row
    return out


def _mod_fit(mx, net, X, Y, B, start, env, opt_params, rules=None):
    """``Module.fit`` over ``net`` on this rank's card (one epoch of
    len(X) / B batches, ``tpu_sync``, SGD) from ``start``'s parameters
    with the ``TPUMX_*`` variables ``env`` set: (module, each batch's loss,
    step ms of each batch, stored bytes of params + momenta)."""
    import torch

    from mxnet_tpu_torch.parallel.partition_rules import max_bytes_per_device

    os.environ.update(env)
    try:
        dev = mx.current_context().torch_device
        losses, marks = [], []

        def keep(p):
            _sync(dev)
            marks.append(time.perf_counter())
            o = p.locals["self"].get_outputs()[0]._data.float()
            y = p.locals["data_batch"].label[0]._data.long().to(o.device)
            losses.append(-torch.log(o.gather(1, y[:, None]).clamp_min(
                1e-30)).mean().item())

        mod = mx.mod.Module(net, label_names=["softmax_label"],
                            context=mx.current_context())
        _sync(dev)
        t0 = time.perf_counter()
        mod.fit(mx.io.NDArrayIter(X, Y, batch_size=B), num_epoch=1,
                kvstore="tpu_sync", optimizer="sgd",
                optimizer_params=dict(opt_params), arg_params=start[0],
                aux_params=start[1], batch_end_callback=keep,
                shard_rules=rules)
        ms = [(b - a) * 1e3 for a, b in zip([t0] + marks, marks)]
        stored = max_bytes_per_device(
            [mod._exec.arg_dict[n] for n in mod._param_names]
            + [s for s in mod._updater.states.values()])
        return mod, losses, ms, stored
    finally:
        for k in env:
            del os.environ[k]


def _shard_oracle(mx, net, X, Y, B, start, opt_params, ndev):
    """The dp mesh step's semantics on this card alone: each batch's
    ``ndev`` blocks forward and backward one after the other (BatchNorm
    statistics of each block, as on its rank), the gradients summed, the
    new running statistics averaged, then one SGD update with the global
    batch's ``rescale_grad``: (each batch's loss, final params + aux)."""
    import torch

    b = B // ndev
    ex = net.simple_bind(ctx=mx.current_context(), grad_req={
        n: ("null" if n in ("data", "softmax_label") else "write")
        for n in net.list_arguments()}, data=(b,) + X.shape[1:])
    ex.copy_params_from(start[0], start[1])
    names = ex._grad_arg_names
    opt = mx.optimizer.create("sgd", rescale_grad=1.0 / B, sym=net,
                              param_idx2name=dict(enumerate(names)),
                              **opt_params)
    upd = mx.optimizer.get_updater(opt)
    losses = []
    for i in range(len(X) // B):
        aux0 = {k: v._data.clone() for k, v in ex.aux_dict.items()}
        gsum = {n: torch.zeros_like(ex.grad_dict[n]._data) for n in names}
        asum = {k: torch.zeros_like(v) for k, v in aux0.items()}
        nll = []
        for q in range(ndev):
            for k, v in aux0.items():
                ex.aux_dict[k]._data.copy_(v)
            xs = X[i * B + q * b:i * B + (q + 1) * b]
            ys = Y[i * B + q * b:i * B + (q + 1) * b]
            o = ex.forward(is_train=True, data=xs, softmax_label=ys)[0]
            ex.backward()
            y = torch.as_tensor(ys).long().to(o._data.device)
            nll.append(-torch.log(o._data.gather(1, y[:, None]).clamp_min(
                1e-30)))
            for n in names:
                gsum[n] += ex.grad_dict[n]._data
            for k in asum:
                asum[k] += ex.aux_dict[k]._data
        for k in asum:
            ex.aux_dict[k]._data.copy_(asum[k] / ndev)
        idx = list(range(len(names)))
        upd(idx, [mx.nd.NDArray(gsum[n]) for n in names],
            [ex.arg_dict[n] for n in names])
        losses.append(torch.cat(nll).mean().item())
    params = {n: ex.arg_dict[n]._data for n in names}
    params.update({"aux:" + k: v._data for k, v in ex.aux_dict.items()})
    return losses, params


def _mlp_symbol(mx, dim, hidden, classes):
    """The wide MLP: fc1 (dim -> hidden, column-parallel under the
    compute rules), fc2 (hidden -> dim, row-parallel), fc3 (-> classes)."""
    with mx.name.NameManager():
        h = mx.sym.Activation(mx.sym.FullyConnected(
            mx.sym.Variable("data"), num_hidden=hidden, name="fc1"),
            act_type="relu")
        h = mx.sym.Activation(mx.sym.FullyConnected(
            h, num_hidden=dim, name="fc2"), act_type="relu")
        out = mx.sym.FullyConnected(h, num_hidden=classes, name="fc3")
        return mx.sym.SoftmaxOutput(out, mx.sym.Variable("softmax_label"),
                                    name="softmax")


MODULE_RULES = ((r"fc1_weight", ("mp", None)), (r"fc1_bias", ("mp",)),
                (r"fc2_weight", (None, "mp")))


def _module(dev, size, bad):
    """``Module.fit`` over meshes of the four cards against this card
    alone, three batches each, f32: dp=4 on the module_fit ResNet-50
    symbol (against ``_shard_oracle``: the reference's dp step takes each
    rank's BatchNorm statistics; each tensor also within 10 x the
    oracle's own noise floor where that exceeds the bound, as chip_smoke
    holds ResNet-50); mp=4 storage and dp=2 x mp=2
    tensor-parallel compute on the wide MLP; pp=4 on a stage-stackable FC
    stack (the last three against one card's ``Module.fit``).  Losses
    within 1e-5 relative, every parameter (and running statistic) within
    1e-4 normwise; step ms (median of batches 2-3) beside the one-card
    fit's, and this rank's stored bytes of params + momenta beside the
    whole."""
    import torch

    import chip_smoke as cs
    import mxnet_tpu_torch as mx

    cs.RESNET_HW = size["resnet_hw"]
    out = {}

    def loss_rel(a, b):
        return max(abs(x - y) / abs(y) for x, y in zip(a, b))

    def compare(tag, got, want, got_ms, want_ms, extra=None, floor=None):
        """Losses within 1e-5 and parameters within 1e-4 of ``want``; with
        ``floor`` (the one-card run against itself on images moved by
        ~2^-22: the net's own f32 noise), each within 10 x its floor
        where that is larger (chip_smoke's ``_tolerance`` rule)."""
        (gl, gp), (wl, wp) = got, want
        loss_err = loss_rel(gl, wl)
        errs = {k: _rel_err(gp[k], wp[k]) for k in wp}
        worst = max(errs, key=errs.get)
        floors = {k: 0.0 for k in wp}
        loss_floor = 0.0
        if floor is not None:
            loss_floor = loss_rel(floor[0], wl)
            floors = {k: _rel_err(floor[1][k], wp[k]) for k in wp}
        over = sorted(k for k in errs
                      if errs[k] > max(1e-4, 10 * floors[k]))
        row = {"losses": gl, "one_card_losses": wl,
               "loss_rel_err": loss_err, "max_param_rel_err": errs[worst],
               "worst": worst, "floor_of_worst": floors[worst],
               "loss_floor": loss_floor, "over_tolerance": over,
               "step_ms": float(np.median(got_ms[1:])),
               "one_card_step_ms": float(np.median(want_ms[1:])),
               **(extra or {})}
        if loss_err > max(1e-5, 10 * loss_floor) or over \
                or not all(np.isfinite(gl)):
            bad.append(f"module {tag}: losses {gl} vs {wl}, {worst} by "
                       f"{errs[worst]:.3g} (floor {floors[worst]:.3g}), "
                       f"over {over}")
        out[tag] = row

    def whole(mod):
        arg, aux = mod.get_params()
        p = {k: v._data for k, v in arg.items()}
        p.update({"aux:" + k: v._data for k, v in aux.items()})
        return p

    sgd = {"learning_rate": 0.05, "momentum": 0.9}
    # dp=4 on the ResNet-50 symbol
    net, _, _ = cs._fit_loaded_symbol()
    B = size["module_resnet_batch"]
    X, Y = cs._fit_images(3, B, SEED + 20)
    args, aux = cs._random_values(net, (B,) + X.shape[1:], SEED + 21,
                                  cs.RESNET_CLASSES)
    start = ({k: mx.nd.array(v) for k, v in args.items()
              if k not in ("data", "softmax_label")},
             {k: mx.nd.array(v) for k, v in aux.items()})
    mod, losses, ms, stored = _mod_fit(mx, net, X, Y, B, start,
                                       {"TPUMX_DP_DEVICES": "4"}, sgd)
    got = (losses, whole(mod))
    mesh = dict(mod._exec._spmd_mesh.shape)
    del mod
    t0 = time.perf_counter()
    want = _shard_oracle(mx, net, X, Y, B, start, sgd, 4)
    _sync(dev)
    oracle_ms = (time.perf_counter() - t0) * 1e3 / 3
    u = np.random.default_rng(SEED + 23).uniform(-1, 1, X.shape)
    moved = _shard_oracle(mx, net, (X * (1 + 2.0 ** -22 * u)).astype(
        np.float32), Y, B, start, sgd, 4)
    compare("dp4_resnet50", got, want, ms, [oracle_ms] * 2,
            {"mesh": mesh, "B": B, "fused_steps": 3,
             "stored_bytes": stored}, floor=moved)
    del got, want, moved
    # the wide MLP: mp=4 storage, dp=2 x mp=2 compute
    D, Hd, C, Bm = size["module_mlp"]
    r = np.random.RandomState(SEED + 22)
    Xm = r.randn(3 * Bm, D).astype(np.float32)
    Ym = r.randint(0, C, 3 * Bm).astype(np.float32)
    mlp = _mlp_symbol(mx, D, Hd, C)
    shapes = mlp.infer_shape(data=(Bm, D), softmax_label=(Bm,))[0]
    mstart = ({n: mx.nd.array((r.randn(*s) / np.sqrt(s[-1]))
                              .astype(np.float32))
               for n, s in zip(mlp.list_arguments(), shapes)
               if n not in ("data", "softmax_label")}, {})
    one, one_l, one_ms, one_bytes = _mod_fit(mx, mlp, Xm, Ym, Bm, mstart,
                                             {}, sgd)
    want = (one_l, whole(one))
    del one
    for tag, env, rules in (
            ("mp4_storage", {"TPUMX_MP_DEVICES": "4"}, None),
            ("dp2mp2_compute", {"TPUMX_DP_DEVICES": "2",
                                "TPUMX_MP_DEVICES": "2"}, MODULE_RULES)):
        mod, losses, ms, stored = _mod_fit(mx, mlp, Xm, Ym, Bm, mstart, env,
                                           sgd, rules)
        ex = mod._exec
        compare(tag, (losses, whole(mod)), want, ms, one_ms,
                {"mesh": dict(ex._spmd_mesh.shape),
                 "compute": ex._spmd_compute,
                 "gathers": ex.mp_gathers,
                 "stored_bytes": stored, "one_card_bytes": one_bytes})
        if tag == "dp2mp2_compute" and (not ex._spmd_compute or any(
                ex.mp_gathers.values())):
            bad.append(f"module {tag}: compute {ex._spmd_compute}, "
                       f"gathers {ex.mp_gathers}")
        del mod, ex
    # pp=4 on the FC stack
    L, Bp, Wp = size["module_pp"]
    stack = cs._mpar_stack(mx, L, Wp)
    Xp = r.randn(3 * Bp, Wp).astype(np.float32)
    Yp = r.randint(0, 10, 3 * Bp).astype(np.float32)
    shapes = stack.infer_shape(data=(Bp, Wp), softmax_label=(Bp,))[0]
    pstart = ({n: mx.nd.array((r.randn(*s) / np.sqrt(s[-1]))
                              .astype(np.float32))
               for n, s in zip(stack.list_arguments(), shapes)
               if n not in ("data", "softmax_label")}, {})
    one, one_l, one_ms, _ = _mod_fit(mx, stack, Xp, Yp, Bp, pstart, {}, sgd)
    want = (one_l, whole(one))
    del one
    mod, losses, ms, stored = _mod_fit(mx, stack, Xp, Yp, Bp, pstart,
                                       {"TPUMX_PP_DEVICES": "4"}, sgd)
    plan = mod._exec._spmd_pipeline
    compare("pp4_stack", (losses, whole(mod)), want, ms, one_ms,
            {"mesh": dict(mod._exec._spmd_mesh.shape),
             "plan": plan[0].describe() if plan else None,
             "microbatches": plan[1] if plan else None,
             "stored_bytes": stored})
    if plan is None:
        bad.append("module pp4_stack: no pipeline plan")
    del mod
    return out


def worker(out_dir, rehearse, legs):
    import torch

    sys.path.insert(0, os.path.dirname(os.path.abspath(__file__)))
    import mxnet_tpu_torch as mx
    from mxnet_tpu_torch.parallel import mesh as pmesh

    rank = int(os.environ["MXTPU_PROC_ID"])
    ctx = mx.cpu() if rehearse else mx.gpu(rank)
    dev = ctx.torch_device
    if not rehearse:
        torch.cuda.set_device(rank)
    torch.backends.cudnn.deterministic = True
    torch.backends.cudnn.benchmark = False
    size = SIZES["rehearse" if rehearse else "card"]
    res, bad = {"rank": rank, "device": str(dev)}, []
    try:
        _legs(res, bad, ctx, dev, size, legs)
    finally:
        res["bad"] = bad
        with open(os.path.join(out_dir, f"rank{rank}.json"), "w") as f:
            json.dump(res, f)
    return 1 if bad else 0


def _legs(res, bad, ctx, dev, size, legs):
    """Run the chosen legs into ``res``; an exception is also noted in
    ``bad`` (the worker writes what the finished legs measured)."""
    import traceback

    from mxnet_tpu_torch.parallel import mesh as pmesh

    with ctx:
        # none installed: the one-card trainers must not adopt one
        m22 = pmesh.make_mesh(dp=2, sp=2, install=False, device=dev)
        try:
            m4 = pmesh.make_mesh(sp=4, install=False, device=dev)
            d4 = pmesh.dp_mesh(4, device=dev)
            res["backend"] = m22.backend
            if "sp" in legs:
                res["collectives"] = _collectives(m4, dev, bad)
                res["attention"] = _attention(m4, dev, size, bad)
                res["lm"] = _lm(m22, dev, size, bad)
            if "dp" in legs:
                res["dp"] = _dp(d4, dev, size, bad)
            if "module" in legs:
                res["module"] = _module(dev, size, bad)
            if "serve" in legs:
                import torch.distributed as dist

                coord = dist.new_group(backend="gloo")
                res["serving"] = _serving(coord, dev, size, bad)
                res["serving_multi_token"] = _serving_multi_token(
                    coord, dev, size, bad)
            if "mp" in legs:
                import torch.distributed as dist

                meshes = {"mp4": pmesh.make_mesh(dp=1, mp=4, install=False,
                                                 device=dev),
                          "dp2mp2": pmesh.make_mesh(dp=2, mp=2,
                                                    install=False,
                                                    device=dev)}
                res["partitioned"] = _partitioned(meshes, dev, size, bad)
                res["pipeline"] = _pipeline(pmesh.make_mesh(
                    pp=4, install=False, device=dev), dev, size, bad)
                res["moe"] = _moe(pmesh.make_mesh(
                    ep=4, install=False, device=dev), dev, size, bad)
                coord = dist.new_group(backend="gloo")
                res["serving"] = _serving(coord, dev, size, bad)
                res["serving_multi_token"] = _serving_multi_token(
                    coord, dev, size, bad)
        except BaseException:
            bad.append(traceback.format_exc()[-2000:])
            raise
        finally:
            pmesh.shutdown()


def main(argv) -> int:
    rehearse = "--rehearse" in argv
    root = os.path.dirname(os.path.abspath(__file__))
    out_dir = os.path.join(root, "build", "multicard")
    legs = next((a.split("=", 1)[1].split(",") for a in argv
                 if a.startswith("--legs=")), ["sp", "dp", "mp", "module"])
    if "--worker" in argv:
        return worker(out_dir, rehearse, legs)
    try:
        import torch
    except ImportError:
        print("chip_multicard: torch is not installed", file=sys.stderr)
        return 2
    smi = None
    if not rehearse:
        if not torch.cuda.is_available() or \
                torch.cuda.device_count() < WORKERS:
            print(f"chip_multicard: needs {WORKERS} CUDA devices",
                  file=sys.stderr)
            return 2
        smi = subprocess.run(
            ["nvidia-smi", "--query-gpu=name,power.limit",
             "--format=csv,noheader"], capture_output=True, text=True,
            timeout=60, check=True).stdout.strip().splitlines()
        from mxnet_tpu_torch.ops import _build

        _build.build_all()   # the workers load what this built
    os.makedirs(out_dir, exist_ok=True)
    for f in os.listdir(out_dir):
        os.remove(os.path.join(out_dir, f))
    import socket

    s = socket.socket()
    s.bind(("127.0.0.1", 0))
    port = s.getsockname()[1]
    s.close()
    env = {k: v for k, v in os.environ.items()
           if not k.startswith(("MXTPU_", "DMLC_"))}
    env["PYTHONPATH"] = root
    cmd = [sys.executable, os.path.join(root, "tools", "launch.py"), "-n",
           str(WORKERS), "--coordinator", f"127.0.0.1:{port}", "--",
           sys.executable, os.path.abspath(__file__), "--worker",
           "--legs=" + ",".join(legs)] + (["--rehearse"] if rehearse else [])
    t0 = time.perf_counter()
    proc = subprocess.Popen(cmd, env=env, cwd=root, start_new_session=True)
    try:
        rc = proc.wait(timeout=TIMEOUT)
    except subprocess.TimeoutExpired:
        os.killpg(proc.pid, signal.SIGKILL)
        proc.wait()
        print(f"chip_multicard: the workers hung past {TIMEOUT} s",
              file=sys.stderr)
        return 1
    results = []
    for rank in range(WORKERS):
        path = os.path.join(out_dir, f"rank{rank}.json")
        if os.path.exists(path):
            with open(path) as f:
                results.append(json.load(f))
    for res in results:
        print(json.dumps(res), flush=True)
    print(json.dumps({"phase": "total", "workers_wall_s":
                      time.perf_counter() - t0}), flush=True)
    bad = [b for res in results for b in res["bad"]]
    if rc != 0 or len(results) != WORKERS or bad:
        print(f"chip_multicard failed (launcher {rc}, {len(results)} "
              f"results): {bad}", file=sys.stderr)
        return 1
    if rehearse:
        return 0
    print(smi[0], flush=True)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main(sys.argv))
