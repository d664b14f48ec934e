#!/usr/bin/env python3
"""Drive the PyTorch port (``mxnet_tpu_torch``) once on one NVIDIA GPU.

    python3 chip_smoke.py

Run from the repository root on a machine with a CUDA card, the CUDA
toolkit (``nvcc``) and PyTorch built for CUDA.  Phases, one JSON line each:

1. device   — the card (``nvidia-smi`` name and power limit); TF32 off.
2. build    — compile every ``mxnet_tpu_torch/ops/csrc/*.cu`` (one nvcc
              each, in parallel) and report seconds and each kernel
              function's registers and spills (ptxas); no tensor-core
              flash kernel (bf16, and the f32 3xTF32 forward, dQ and
              dK/dV) may spill, at any head dim.
3. kernels  — each CUDA kernel against its plain PyTorch version on the
              card at its path's shapes: 2-bit pack and unpack (ResNet-50's
              193 gradient shapes and edge sizes, thresholds 0.5, 0 and
              1e9, bit for bit; timed at the largest gradient and summed
              over one step's), BatchNorm stats and normalize
              (ResNet-50's shapes, f32 and bf16, bitwise repeatable; and
              BatchNorm's gradient through them), LayerNorm (forward, and its
              gradient — kernel forward plus autograd — at the training
              rows), paged attention over the float pool and over the int8
              pool (q in float32 and bfloat16; decode at block sizes 32
              and 16, one 1,000-position row, three queries a row, head
              dims 128 and 40, and T=512 prefill chunks; bitwise
              repeatable; timed over table sets that cycle past the L2;
              decode launching the split and merge kernels and prefill
              the tile kernel, by kernel name), and the three flash
              attention kernels (forward with lse, dQ, dK/dV; float32 and
              bfloat16, causal and not, the training shape, a ragged T and
              D = 16, 32 and 128; the backward kernels bitwise equal over
              two runs; bf16 launching the three tensor-core kernels
              and f32 the three 3xTF32 kernels, by kernel name; a NaN in
              q and in g, causal and not, NaN where the plain versions'
              are, by the rule in ``_flash_nan_cases``).  With the
              error, the kernel's time, the plain version's, a library
              call's where one computes the same function, and the least
              time the card could take (bytes or operations over the H100's
              peak rates).
4. model    — the GPT-2-small-width LM (random weights from a seed): a
              prefill chunk plus T=1 decode steps through the paged KV
              cache and both kernels, against the full-sequence forward;
              the same through an int8 pool, the paged path (the int8
              kernel) against the dequantizing gather path.
5. training — the reference trainer's LM step (B=8, T=1024, labels the
              tokens rolled by one, lr 0.1, momentum 0.9) at the same width:
              one float32 ``train_step`` with flash attention against one
              with ``local_attention`` (loss and every gradient; wall and
              device time of each), then ten
              chained bfloat16 steps through the flash kernels (losses
              finite and falling, 12 launches of each flash kernel and 25
              LayerNorms per step); step ms, tokens/s, peak memory.
6. serving  — ``GenerationService`` on ``cuda`` serves 12 requests (8
              greedy, 4 sampled) through reserve-ahead admission, chunked
              prefill and continuous-batching decode; greedy tokens are
              checked teacher-forced against the full-sequence forward
              and against the same request served alone; both kernels
              must have launched on this path.
7. serving_default — the same model under the reference's default
              ``GenerationConfig`` (incremental allocation with
              preemption, the prefix cache) on a 52-block pool: two waves
              of requests sharing 256-token system prompts; greedy tokens
              checked teacher-forced; preemption, prefix hits and
              copy-on-write copies must all have happened.
8. serving_int8 — the ``serving`` phase's requests with
              ``kv_dtype="int8"``: all complete, only the int8 kernel
              serves attention, and greedy tokens agree with the float
              pool's on >= 75% of positions.
9. resnet_training — ``bench.py``'s flagship step: Gluon ``resnet50_v1``
              channels-last at 224x224 (random weights from a seed); an
              f32 step at B=32 with the BatchNorm kernels against one
              with the plain BatchNorm, then ten bf16 steps at B=128 (53
              launches of each BatchNorm kernel a step); images/s, peak
              memory.
10. resnet_compressed — the same net through the port's mesh-less
              ``DataParallelTrainer`` (Gluon ``SoftmaxCrossEntropyLoss``,
              bf16 compute, lr 0.1, momentum 0.9) at B=128: ten steps
              without compression and ten with ``{"type": "2bit",
              "threshold": 0.5}``, twice each in turns (one pack and one
              unpack launch per trainable parameter a step, 53 of each
              BatchNorm kernel); step ms, images/s, peak memory of each,
              and the compression alone between syncs.  Checks: the f32
              trainer loss against resnet_training's step, and a step at
              threshold 1e9 that leaves every parameter unchanged and the
              gradients in the residuals.
11. gluon_training — the imperative Gluon loop on the same net in f32
              (``NDArray``, ``autograd.record``/``backward``,
              ``gluon.Trainer`` over the ``device`` kvstore,
              ``DataLoader``, parameter files; cuDNN deterministic): one
              Trainer step at B=32 against ``_resnet_step`` (loss 1e-6,
              weights against the net's noise floor, running statistics),
              ten steps at B=128 from a ``DataLoader`` over 1,280 random
              images (53 launches of each BatchNorm kernel a step and no
              other; the first two updates lower the repeated first
              batch's loss; two backwards leave one gradient), images/s
              and peak memory beside ``_sgd_foreach_step``'s (the same
              ``_foreach`` SGD pass over ``block_train_fn`` and over the
              block called with tensors) on the same batches and one
              profiled step of each, three 2-bit
              steps at B=32 (a pack and an unpack per trainable parameter
              a step; the residuals and pulled gradients bit for bit
              against the plain 2-bit round trip), a dataset kept on the
              card (batches stacked on the card), and ``save_parameters``/
              ``load_parameters`` (outputs and file bytes bitwise).

Every ResNet phase also requires that the BatchNorm op copied no
non-contiguous input (``batch_norm.noncontiguous_copies`` stays 0).

An optional comma-separated argument (``kernels``, ``model``,
``training``, ``serving``, ``serving_default``, ``serving_int8`` — which
also runs ``serving``, its float baseline — ``resnet_training``,
``resnet_compressed``, ``gluon_training``, and
``profile``, ``profile_training`` and ``profile_resnet``, which are not in
the default run: the serving window, or two bf16 LM or ResNet training
steps, once more under ``torch.profiler``)
runs only those phases after device and build.  Then the kernel table line
(when ``kernels`` and a path ran), the ``nvidia-smi`` line and, last, the
result line ``{"ok": true, "device": {...}}``.  Any failure raises: the
script exits non-zero and prints no result line.  It also exits non-zero
without a CUDA device or without the rest of the repository beside it.
"""
from __future__ import annotations

import dataclasses
import itertools
import json
import subprocess
import sys
import time

import numpy as np

# H100 SXM peak rates (NVIDIA data sheet, dense): device memory bandwidth,
# f32 outside the tensor cores, bf16 and TF32 on the tensor cores
HBM_BYTES_PER_S = 3.35e12
PEAK_FLOPS = {"float32": 67e12, "bfloat16": 989e12, "tf32": 495e12}
# f32 accuracy on the tensor cores takes three TF32 products (3xTF32), so
# the least time for f32 products is the faster of the two routes
PEAK_FLOPS["float32_3xtf32"] = max(PEAK_FLOPS["float32"],
                                   PEAK_FLOPS["tf32"] / 3)

# kernel vs plain version on the same card
TOL = {"float32": dict(rtol=1e-4, atol=1e-5),
       "bfloat16": dict(rtol=2e-2, atol=1e-3),
       # BatchNorm kernels: f32 statistics and f32 out; bf16 out within one
       # bf16 ulp beyond this
       "batch_norm": dict(rtol=1e-5, atol=1e-5)}
# BatchNorm's gradient through the kernel forward against the plain
# forward's, normwise (bf16: the two outputs may differ by one bf16 ulp)
BN_GRAD_TOL = {"float32": 1e-5, "bfloat16": 1e-2}

GPT2_SMALL = dict(vocab=50257, d_model=768, n_heads=12, n_layers=12,
                  d_ff=3072, max_len=1024)
SEED = 0
# flash attention shapes (B, T, H, D): the LM training step's, a T that is
# no multiple of the kernels' 64-row tiles, and the other head dims (every
# instantiation of each kernel, float32 and bfloat16)
FLASH_SHAPES = {"training": (8, 1024, 12, 64), "ragged": (2, 1000, 3, 64),
                "d16": (2, 200, 2, 16), "d32": (2, 200, 2, 32),
                "d128": (2, 200, 2, 128)}
# the flash kernel functions each dtype must launch (bf16: the tensor-core
# forward, dQ and dK/dV; f32: the 3xTF32 forward, dQ and dK/dV)
FLASH_ROUTES = {"bfloat16": ("flash_fwd_tc_kernel", "flash_dq_tc_kernel",
                             "flash_dkv_tc_kernel"),
                "float32": ("flash_fwd_tf32_kernel", "flash_dq_tf32_kernel",
                            "flash_dkv_tf32_kernel")}
# ResNet-50's BatchNorm inputs (B, H, W, C) at B = 128, 224x224: the stem,
# stages 1, 2 and 4; and an odd M = B*H*W
BN_SHAPES = ((128, 112, 112, 64), (128, 56, 56, 256), (128, 28, 28, 512),
             (128, 7, 7, 2048), (1, 1, 12345, 320))
# resnet_training: bench.py's flagship step (resnet50_v1, 1000 classes,
# channels-last 224x224x3, SGD lr 0.1 momentum 0.9) and its 53 BatchNorms
# (stem 1, 16 bottleneck units x 3, 4 projections)
RESNET_CLASSES, RESNET_HW, RESNET_BNS = 1000, 224, 53
RESNET_BATCH, RESNET_F32_BATCH = 128, 32
RESNET_LR, RESNET_MOMENTUM = 0.1, 0.9
# the port's CUDA kernel functions, as the profiler names them
PORT_KERNELS = ("twobit_pack_kernel", "twobit_unpack_kernel",
                "bn_stats_partial", "bn_stats_final", "bn_normalize",
                "layer_norm_kernel", "flash_fwd_tf32_kernel",
                "flash_dq_tf32_kernel", "flash_dkv_tf32_kernel",
                "flash_fwd_tc_kernel", "flash_dq_tc_kernel",
                "flash_dkv_tc_kernel",
                "paged_decode_split_kernel", "paged_decode_merge_kernel",
                "paged_prefill_tile_kernel")
# serving_default's pool: small enough that its two waves preempt
DEFAULT_POOL_BLOCKS = 52
# 2-bit compression: the reference's documented default threshold; the
# pack/unpack edge sizes (one element, a 2048-element row less and more
# one, the TPU kernel's 64-row block, one element past it — padded to 128
# rows — and 65 rows); chained steps of each resnet_compressed trainer
TWOBIT_THRESHOLD = 0.5
TWOBIT_EDGES = (1, 2047, 2049, 64 * 2048, 64 * 2048 + 1, 65 * 2048)
COMPRESSED_STEPS = 10
# gluon_training: the imperative loop's DataLoader samples and steps, and
# its compressed steps (at RESNET_F32_BATCH)
GLUON_SAMPLES, GLUON_STEPS, GLUON_COMPRESSED_STEPS = 1280, 10, 3


def emit(obj) -> None:
    print(json.dumps(obj), flush=True)


def _close(a, b, dtype: str):
    import torch

    a, b = a.float(), b.float()
    tol = TOL[dtype]
    diff = (a - b).abs()
    ok = bool((diff <= tol["atol"] + tol["rtol"] * b.abs()).all())
    rel = (diff / b.abs().clamp_min(1e-6)).max().item()
    return ok, diff.max().item(), rel


def time_ms(fn, x0, iters: int = 20, reps: int = 9) -> float:
    """Median device time of one call: ``iters`` chained calls (each call's
    output is the next one's input) captured in a CUDA graph, replayed
    ``reps`` times between CUDA events."""
    import torch

    s = torch.cuda.Stream()
    s.wait_stream(torch.cuda.current_stream())
    with torch.cuda.stream(s):
        fn(x0)  # warm up outside the capture
    torch.cuda.current_stream().wait_stream(s)
    g = torch.cuda.CUDAGraph()
    with torch.cuda.graph(g):
        y = x0
        for _ in range(iters):
            y = fn(y)
    g.replay()
    torch.cuda.synchronize()
    times = []
    for _ in range(reps):
        e0 = torch.cuda.Event(enable_timing=True)
        e1 = torch.cuda.Event(enable_timing=True)
        e0.record()
        g.replay()
        e1.record()
        torch.cuda.synchronize()
        times.append(e0.elapsed_time(e1) / iters)
    return float(np.median(times))


def bound_ms(nbytes: float, flops: float, dtype: str):
    t_bytes = nbytes / HBM_BYTES_PER_S
    t_ops = flops / PEAK_FLOPS[dtype]
    return (max(t_bytes, t_ops) * 1e3,
            "bytes" if t_bytes >= t_ops else "operations")


# -- phase 1 ------------------------------------------------------------------------
def phase_device():
    import torch

    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        timeout=60, check=True).stdout.strip().splitlines()[0]
    from mxnet_tpu_torch.context import resolve_device

    dev = resolve_device(None)
    emit({"phase": "device", "nvidia_smi": smi,
          "name": torch.cuda.get_device_name(0),
          "count": torch.cuda.device_count(), "torch": torch.__version__,
          "cuda": torch.version.cuda,
          "allow_tf32": [torch.backends.cuda.matmul.allow_tf32,
                         torch.backends.cudnn.allow_tf32]})
    return dev, smi


# -- phase 2 ------------------------------------------------------------------------
def _ptxas_functions(report: str):
    """Registers, spill bytes and shared memory of each kernel function in
    one source's ``-Xptxas -v`` report, by mangled name."""
    import re

    funcs, cur = {}, None
    for ln in report.splitlines():
        m = re.search(r"Compiling entry function '(\w+)'", ln)
        if m:
            cur = funcs.setdefault(m.group(1), {})
            continue
        if cur is None:
            continue
        m = re.search(r"(\d+) bytes spill stores, (\d+) bytes spill loads",
                      ln)
        if m:
            cur["spill_stores"], cur["spill_loads"] = map(int, m.groups())
        m = re.search(r"Used (\d+) registers", ln)
        if m:
            cur["registers"] = int(m.group(1))
            sm = re.search(r"(\d+) bytes smem", ln)
            cur["static_smem"] = int(sm.group(1)) if sm else 0
    return funcs


# paged-attention kernel functions (by mangled-name fragment: kernel, q's
# type, the pool's type, queries a block) that ptxas lets spill, with the
# most bytes each may; every other paged function, the main path's f32 and
# int8 decode (one query) and every prefill tile, must not spill
PAGED_SPILLS_ALLOWED = {
    "paged_decode_split_kernelI13__nv_bfloat16S1_Li1E": 8,
    "paged_decode_split_kernelI13__nv_bfloat16S1_Li4E": 16,
    "paged_decode_split_kernelIffLi4E": 12,
}


def _spills(rows: dict, allowed: dict) -> dict:
    """The functions of ``rows`` that spill more than ``allowed`` lets
    them (keyed by a fragment of the mangled name; 0 if none matches)."""
    bad = {}
    for f, r in rows.items():
        cap = next((n for k, n in allowed.items() if k in f), 0)
        if max(r.get("spill_stores", 1), r.get("spill_loads", 1)) > cap:
            bad[f] = r
    return bad


def phase_build():
    """Build every kernel source; no tensor-core flash kernel (the three
    bf16 and the three f32 3xTF32 functions at four head dims: 24) may
    spill registers, and no paged-attention function (22) beyond
    ``PAGED_SPILLS_ALLOWED``."""
    from mxnet_tpu_torch.ops import _build

    t0 = time.perf_counter()
    info = _build.build_all()
    funcs = {n: _ptxas_functions(v["ptxas"]) for n, v in info.items()}
    emit({"phase": "build", "seconds": time.perf_counter() - t0,
          "kernels": {n: {"seconds": v["seconds"], "functions": funcs[n]}
                      for n, v in info.items()}})
    if info["flash_attention"]["ptxas"]:   # empty when loaded from disk
        tc = {f: r for f, r in funcs["flash_attention"].items()
              if "_tc_kernelILi" in f or "_tf32_kernelILi" in f}
        if len(tc) != 24 or _spills(tc, {}):
            raise SystemExit(f"tensor-core flash kernels spill: {tc}")
    if info["paged_attention"]["ptxas"]:
        paged = funcs["paged_attention"]
        bad = _spills(paged, PAGED_SPILLS_ALLOWED)
        if len(paged) != 22 or bad:
            raise SystemExit(f"paged attention kernels spill: {bad} "
                             f"({len(paged)} functions)")


# -- phase 3 ------------------------------------------------------------------------
def _layer_norm_cases(dev):
    import torch
    import torch.nn.functional as F

    from mxnet_tpu_torch.ops.layer_norm import (layer_norm_fused,
                                                layer_norm_reference)

    g = torch.Generator(device=dev).manual_seed(SEED)
    rows = []
    C = GPT2_SMALL["d_model"]
    for M in (8, 512):
        for dtype in (torch.float32, torch.bfloat16):
            for gelu in (False, True):
                x = (torch.randn(M, C, generator=g, device=dev) * 2.0
                     + 0.5).to(dtype)
                gam = (1.0 + 0.1 * torch.randn(C, generator=g, device=dev)
                       ).to(dtype)
                bet = (0.1 * torch.randn(C, generator=g, device=dev)
                       ).to(dtype)
                got = layer_norm_fused(x, gam, bet, 1e-5, gelu)
                want = layer_norm_reference(x, gam, bet, 1e-5, gelu)
                torch.cuda.synchronize()
                dname = str(dtype).split(".")[-1]
                ok, err, rel = _close(got, want, dname)
                ms = time_ms(lambda t: layer_norm_fused(t, gam, bet, 1e-5,
                                                        gelu), x)
                plain = time_ms(lambda t: layer_norm_reference(
                    t, gam, bet, 1e-5, gelu), x)
                lib = None if gelu else time_ms(
                    lambda t: F.layer_norm(t, (C,), gam, bet, 1e-5), x)
                item = x.element_size()
                bms, by = bound_ms(2 * M * C * item + 2 * C * item,
                                   (18 if gelu else 8) * M * C, dname)
                rows.append({"M": M, "C": C, "dtype": dname, "gelu": gelu,
                             "ok": ok, "max_abs_err": err,
                             "max_rel_err": rel, "ms": ms, "plain_ms": plain,
                             "library_ms": lib, "bound_ms": bms,
                             "bound_by": by})
    return rows


def _paged_bytes_flops(q, k_pool, tables, pos, max_pos, bs):
    """Bytes the call must move (q and out; the indices; the rows of live
    K/V blocks up to the row's last query position, once, with their two
    f32 scales per block and head for an int8 pool) and the f32 operations
    its unmasked (query, key) pairs need."""
    import torch

    B, T, H, D = q.shape
    item = q.element_size()
    kv_item = k_pool.element_size()
    scale_bytes = 2 * H * 4 if k_pool.dtype == torch.int8 else 0
    tab = tables.cpu().numpy()
    mp = max_pos.cpu().numpy()
    ps = pos.cpu().numpy()
    W = tab.shape[1]
    nbytes = 2 * q.numel() * item + tables.numel() * 4 + pos.numel() * 4
    pairs = 0
    for b in range(B):
        live = [w for w in range(W) if tab[b, w] != 0 and w * bs <= mp[b]]
        ctx = np.concatenate([np.arange(w * bs, (w + 1) * bs)
                              for w in live]) if live else np.zeros(0)
        nbytes += len(live) * scale_bytes + int(
            (ctx <= ps[b].max()).sum()) * 2 * H * D * kv_item
        for t in range(T):
            pairs += int((ctx <= ps[b, t]).sum())
    return nbytes, 4.0 * D * H * pairs


# paged attention: each case's K/V pool holds enough disjoint table sets
# that one cycle of timed calls reads more than the 50 MB L2
PAGED_ROTATE_BYTES = 64e6
# the paged kernel functions each route must launch
PAGED_ROUTES = {"decode": ("paged_decode_split_kernel",
                           "paged_decode_merge_kernel"),
                "prefill": ("paged_prefill_tile_kernel",)}


def _paged_cases():
    """The paged-attention call shapes of the serving path and its edges:
    (name, B, T, W, bs, H, D, starts, lengths, table template).  Row b's
    queries sit at positions starts[b] .. starts[b]+T-1, of which
    lengths[b] are valid; the template marks the table entries that hold a
    block (each timed set gets its own physical blocks)."""
    def decode(ctx, W, bs, T=1):
        tmpl = np.zeros((len(ctx), W), np.int32)
        for b, n in enumerate(ctx):
            if n:
                tmpl[b, :-(-(n + 1) // bs)] = 1
        starts = [max(0, n - T + 1) for n in ctx]
        lengths = [T if n else 0 for n in ctx]
        return starts, lengths, tmpl

    # the serving decode step: 8 slots with ragged contexts, one inactive
    # (max_pos = -1), null entries past each row's blocks and one null
    # entry inside a live range (row 7, logical block 10)
    ctx = [1000, 37, 300, 0, 511, 64, 129, 800]
    cases = []
    for name, W, bs, H, D in (("decode", 32, 32, 12, 64),
                              ("decode_bs16", 64, 16, 12, 64),
                              ("decode_d128", 32, 32, 6, 128),
                              ("decode_d40", 32, 32, 4, 40)):
        st, ln, tmpl = decode(ctx, W, bs)
        tmpl[7, 320 // bs] = 0
        cases.append((name, 8, 1, W, bs, H, D, st, ln, tmpl))
    # split-K's own case: one 1,000-position row
    st, ln, tmpl = decode([1000], 32, 32)
    cases.append(("decode_long", 1, 1, 32, 32, 12, 64, st, ln, tmpl))
    # three queries a row (the multi-query decode kernel), one row with two
    # valid
    st, ln, tmpl = decode(ctx, 32, 32, T=3)
    ln[2] = 2
    cases.append(("decode_t3", 8, 3, 32, 32, 12, 64, st, ln, tmpl))
    # prefill: one 512-query chunk at offset 256 (a chunked prompt), 400
    # valid queries, so blocks past the last valid position are skipped
    for name, W, bs, H, D in (("prefill", 32, 32, 12, 64),
                              ("prefill_bs16", 64, 16, 12, 64),
                              ("prefill_d40", 32, 32, 4, 40)):
        cases.append((name, 1, 512, W, bs, H, D, [256], [400],
                      np.ones((1, W), np.int32)))
    return cases


def _int8_pools(dev, nb, bs, H, D, seed):
    """Random int8 K/V pools with per-(block, head) scales; block 0 (the
    null block) carries NaN scales, which no reader may touch."""
    import torch

    g = torch.Generator(device=dev).manual_seed(seed)
    kp = torch.randint(-127, 128, (nb, bs, H, D), generator=g, device=dev,
                       dtype=torch.int8)
    vp = torch.randint(-127, 128, (nb, bs, H, D), generator=g, device=dev,
                       dtype=torch.int8)
    ks = torch.rand(nb, H, generator=g, device=dev) * 0.05 + 1e-3
    vs = torch.rand(nb, H, generator=g, device=dev) * 0.05 + 1e-3
    ks[0] = vs[0] = float("nan")
    return kp, vp, ks, vs


def _paged_inputs(dev, dtype, int8, case, rotate=True):
    """One case's inputs: q, the pools (block 0 poisoned with NaN: NaN
    scales for int8, NaN values for a float pool), the table sets (with
    ``rotate``, enough that one cycle reads more than PAGED_ROTATE_BYTES,
    at most 256; else one), positions and max_pos."""
    import torch

    name, B, T, W, bs, H, D, starts, lengths, tmpl = case
    pos = (torch.tensor(starts, device=dev)[:, None]
           + torch.arange(T, device=dev)[None, :]).to(torch.int32)
    valid = torch.arange(T, device=dev)[None, :] < torch.tensor(
        lengths, device=dev)[:, None]
    max_pos = torch.where(valid, pos, -1).amax(dim=1).to(torch.int32)
    n_live = int(tmpl.sum())
    q0 = torch.zeros(B, T, H, D, device=dev, dtype=dtype)
    probe = torch.zeros(2, bs, H, D, device=dev,
                        dtype=torch.int8 if int8 else dtype)
    tab0 = torch.tensor(tmpl, dtype=torch.int32, device=dev)
    per_set, _ = _paged_bytes_flops(q0, probe, tab0, pos, max_pos, bs)
    n_sets = min(256, max(2, int(np.ceil(PAGED_ROTATE_BYTES / per_set)))) \
        if rotate else 1
    nb = 1 + n_sets * n_live
    rs = np.random.RandomState(SEED + T + W + D)
    phys = (rs.permutation(nb - 1) + 1).reshape(n_sets, n_live)
    tables = []
    for i in range(n_sets):
        t = np.zeros((B, W), np.int32)
        t[tmpl != 0] = phys[i]
        tables.append(torch.tensor(t, device=dev))
    g = torch.Generator(device=dev).manual_seed(SEED + B * 1000 + T)
    q = torch.randn(B, T, H, D, generator=g, device=dev).to(dtype)
    ks = vs = None
    if int8:
        kp, vp, ks, vs = _int8_pools(dev, nb, bs, H, D, SEED + B + T)
    else:
        kp = torch.randn(nb, bs, H, D, generator=g, device=dev).to(dtype)
        vp = torch.randn(nb, bs, H, D, generator=g, device=dev).to(dtype)
        kp[0] = vp[0] = float("nan")
    return q, kp, vp, ks, vs, tables, pos.contiguous(), max_pos


def _paged_attention_cases(dev, int8: bool = False):
    """Kernels 9 (float pool) and 10 (int8 pool) against their plain
    version on the card, every case of ``_paged_cases`` with q float32 and
    bfloat16: outputs at ``TOL``, inactive rows exactly 0, two runs equal
    bit for bit; times of kernel and plain version over table sets that
    cycle past the L2 (one CUDA graph of one call per set)."""
    import torch

    from mxnet_tpu_torch.ops.paged_attention import (attention_scale,
                                                     paged_attention,
                                                     paged_attention_plain)

    out = []
    for case in _paged_cases():
        name, B, T, W, bs, H, D = case[:7]
        for dtype in (torch.float32, torch.bfloat16):
            q, kp, vp, ks, vs, tables, pos, mp = _paged_inputs(
                dev, dtype, int8, case)
            scale = attention_scale(D)
            got = paged_attention(q, kp, vp, tables[0], pos, mp,
                                  k_scale=ks, v_scale=vs)
            again = paged_attention(q, kp, vp, tables[0], pos, mp,
                                    k_scale=ks, v_scale=vs)
            want = paged_attention_plain(q, kp, vp, tables[0], pos, mp,
                                         scale, ks, vs)
            torch.cuda.synchronize()
            dname = str(dtype).split(".")[-1]
            ok, err, rel = _close(got, want, dname)
            ok = ok and bool(torch.isfinite(got).all())
            bitwise = bool(torch.equal(got, again))
            zero_rows = [b for b in range(B) if int(mp[b]) < 0]
            zeros_ok = all(bool((got[b] == 0).all()) for b in zero_rows)
            nxt = _rotating(tables)
            n = max(20, len(tables))
            ms = time_ms(lambda t: paged_attention(
                t, kp, vp, nxt(), pos, mp, k_scale=ks, v_scale=vs), q,
                iters=n)
            nxt = _rotating(tables)
            plain = time_ms(lambda t: paged_attention_plain(
                t, kp, vp, nxt(), pos, mp, scale, ks, vs), q, iters=n,
                reps=5)
            nbytes, flops = _paged_bytes_flops(q, kp, tables[0], pos, mp,
                                               bs)
            bms, by = bound_ms(nbytes, flops, dname)
            out.append({"case": name, "kind": name.split("_")[0], "B": B,
                        "T": T, "W": W, "bs": bs, "H": H, "D": D,
                        "dtype": dname, "kv": "int8" if int8 else dname,
                        "ok": ok and zeros_ok and bitwise,
                        "inactive_rows_zero": zeros_ok,
                        "bitwise_deterministic": bitwise,
                        "table_sets": len(tables), "max_abs_err": err,
                        "max_rel_err": rel, "ms": ms, "plain_ms": plain,
                        "library_ms": None, "bound_ms": bms, "bound_by": by,
                        "bytes": nbytes})
            del q, kp, vp, ks, vs, tables
    return out


def _paged_routes(dev):
    """Which kernel functions ``paged_attention`` launches (torch.profiler
    over two calls of each route and pool at a small shape): decode must
    run the split and merge kernels, prefill the tile kernel
    (``PAGED_ROUTES``), and no other paged kernel function runs."""
    import torch

    from mxnet_tpu_torch.ops.paged_attention import paged_attention

    rows = []
    for route, T in (("decode", 1), ("prefill", 64)):
        for int8 in (False, True):
            case = (route, 2, T, 8, 32, 2, 64, [100, 37], [T, T],
                    np.ones((2, 8), np.int32))
            q, kp, vp, ks, vs, tables, pos, mp = _paged_inputs(
                dev, torch.float32, int8, case, rotate=False)

            def calls():
                for _ in range(2):
                    paged_attention(q, kp, vp, tables[0], pos, mp,
                                    k_scale=ks, v_scale=vs)

            names, sessions = _launched(calls, "paged_")
            ok, other = _routed(names, PAGED_ROUTES[route])
            rows.append({"route": route, "kv": "int8" if int8 else "float32",
                         "kernels": names, "other": other,
                         "profiler_sessions": sessions, "ok": ok})
    return rows


def _layer_norm_backward_cases(dev):
    """LayerNorm's gradient on the card at the training path's rows (B*T =
    8192, C = 768): the kernel forward plus autograd through the plain
    version, against autograd through the plain version alone."""
    import torch

    from mxnet_tpu_torch.ops.layer_norm import (layer_norm_fused,
                                                layer_norm_reference)

    g = torch.Generator(device=dev).manual_seed(SEED + 1)
    M, C = 8 * 1024, GPT2_SMALL["d_model"]
    rows = []
    for dtype in (torch.float32, torch.bfloat16):
        for gelu in (False, True):
            x = (torch.randn(M, C, generator=g, device=dev) * 2.0 + 0.5
                 ).to(dtype).requires_grad_()
            gam = (1.0 + 0.1 * torch.randn(C, generator=g, device=dev)
                   ).to(dtype).requires_grad_()
            bet = (0.1 * torch.randn(C, generator=g, device=dev)
                   ).to(dtype).requires_grad_()
            dy = torch.randn(M, C, generator=g, device=dev).to(dtype)
            n0 = layer_norm_fused.launches
            out = layer_norm_fused(x, gam, bet, 1e-5, gelu)
            launched = layer_norm_fused.launches - n0
            has_grad_fn = out.grad_fn is not None
            got = torch.autograd.grad(out, (x, gam, bet), dy)
            want = torch.autograd.grad(
                layer_norm_reference(x, gam, bet, 1e-5, gelu),
                (x, gam, bet), dy)
            torch.cuda.synchronize()
            dname = str(dtype).split(".")[-1]
            close = [_close(a, b, dname) for a, b in zip(got, want)]
            rows.append({"M": M, "C": C, "dtype": dname, "gelu": gelu,
                         "grad_fn": has_grad_fn, "launches": launched,
                         "ok": has_grad_fn and launched == 1
                         and all(c[0] for c in close),
                         "bitwise_equal": all(bool(torch.equal(a, b))
                                              for a, b in zip(got, want)),
                         "max_abs_err": {n: c[1] for n, c in
                                         zip(("dx", "dgamma", "dbeta"),
                                             close)}})
    return rows


def _event_ms(fn, n: int = 10) -> float:
    """Mean device time of ``fn`` over ``n`` calls between CUDA events,
    after two warm-up calls (for work a CUDA graph cannot capture)."""
    import torch

    for _ in range(2):
        fn()
    torch.cuda.synchronize()
    e0 = torch.cuda.Event(enable_timing=True)
    e1 = torch.cuda.Event(enable_timing=True)
    e0.record()
    for _ in range(n):
        fn()
    e1.record()
    torch.cuda.synchronize()
    return e0.elapsed_time(e1) / n


def _flash_work(B, T, H, D, item, causal):
    """Bytes each flash kernel must move (inputs read once, outputs
    written once; lse and delta are f32 rows) and the operations its live
    (query, key) pairs need: 4*D per pair forward, 6*D for dQ, 8*D for
    dK/dV."""
    pairs = B * H * (T * (T + 1) // 2 if causal else T * T)
    n, rows = B * T * H * D * item, B * H * T * 4
    return {"fwd": (4 * n + rows, 4 * D * pairs),
            "dq": (5 * n + 2 * rows, 6 * D * pairs),
            "dkv": (6 * n + 2 * rows, 8 * D * pairs)}


def _flash_cases(dev):
    """Kernels 6-8 against their plain versions on the card: the LM's
    training shape (q, k, v strided views of one fused qkv product, as the
    model passes them), a ragged T and the head dims 16, 32 and 128
    (``FLASH_SHAPES``), float32 and bfloat16, causal and not.  The
    backward kernels and their plain versions take the same out,
    lse and delta; each backward kernel runs twice and must give the same
    bits.  Times at the training shape only."""
    import torch
    import torch.nn.functional as F

    from mxnet_tpu_torch.ops import flash_attention as fa

    rows = []
    for shape, (B, T, H, D) in FLASH_SHAPES.items():
        for dtype in (torch.float32, torch.bfloat16):
            for causal in (True, False):
                dname = str(dtype).split(".")[-1]
                g = torch.Generator(device=dev).manual_seed(
                    SEED + T + int(causal))
                if shape == "training":
                    qkv = torch.randn(B, T, 3 * H * D, generator=g,
                                      device=dev).to(dtype)
                    q, k, v = (t.reshape(B, T, H, D)
                               for t in qkv.split(H * D, dim=-1))
                else:
                    q, k, v = (torch.randn(B, T, H, D, generator=g,
                                           device=dev).to(dtype)
                               for _ in range(3))
                go = torch.randn(B, T, H, D, generator=g,
                                 device=dev).to(dtype)
                scale = 1.0 / np.sqrt(D)
                out, lse = fa.flash_attention_forward(q, k, v, causal)
                w_out, w_lse = fa.flash_attention_forward_reference(
                    q, k, v, causal)
                delta = fa.flash_delta(w_out, go)
                bwd_args = (q, k, v, go, w_lse, delta, causal)
                runs = [(fa.flash_attention_dq(*bwd_args),
                         *fa.flash_attention_dkv(*bwd_args))
                        for _ in range(2)]
                want = (fa.flash_attention_dq_reference(*bwd_args, scale),
                        *fa.flash_attention_dkv_reference(*bwd_args, scale))
                torch.cuda.synchronize()
                errs, ok = {}, True
                for name, a, b, tol in (
                        ("out", out, w_out, dname), ("lse", lse, w_lse,
                                                     "float32"),
                        ("dq", runs[0][0], want[0], dname),
                        ("dk", runs[0][1], want[1], dname),
                        ("dv", runs[0][2], want[2], dname)):
                    good, err, _ = _close(a, b, tol)
                    good = good and bool(torch.isfinite(a.float()).all())
                    errs[name] = err
                    ok = ok and good
                bitwise = all(bool(torch.equal(a, b))
                              for a, b in zip(runs[0], runs[1]))
                row = {"shape": shape, "B": B, "T": T, "H": H, "D": D,
                       "dtype": dname, "causal": causal,
                       "ok": ok and bitwise, "bitwise_deterministic": bitwise,
                       "max_abs_err": errs}
                if shape == "training":
                    row["ms"] = {
                        "fwd": time_ms(lambda _: fa.flash_attention_forward(
                            q, k, v, causal)[0], q),
                        "dq": time_ms(lambda _: fa.flash_attention_dq(
                            *bwd_args), q),
                        "dkv": time_ms(lambda _: fa.flash_attention_dkv(
                            *bwd_args)[0], q)}
                    row["plain_ms"] = {
                        "fwd": time_ms(
                            lambda _: fa.flash_attention_forward_reference(
                                q, k, v, causal)[0], q, iters=4, reps=5),
                        "dq": time_ms(
                            lambda _: fa.flash_attention_dq_reference(
                                *bwd_args, scale), q, iters=4, reps=5),
                        "dkv": time_ms(
                            lambda _: fa.flash_attention_dkv_reference(
                                *bwd_args, scale)[0], q, iters=4, reps=5)}
                    qt, kt, vt = (t.transpose(1, 2) for t in (q, k, v))
                    sdpa_fwd = time_ms(
                        lambda _: F.scaled_dot_product_attention(
                            qt, kt, vt, is_causal=causal, scale=scale), q)
                    lq, lk, lv = (t.detach().requires_grad_()
                                  for t in (qt, kt, vt))
                    gt = go.transpose(1, 2)

                    def sdpa_step():
                        o = F.scaled_dot_product_attention(
                            lq, lk, lv, is_causal=causal, scale=scale)
                        torch.autograd.grad(o, (lq, lk, lv), gt)

                    both = _event_ms(sdpa_step)
                    row["sdpa_ms"] = {"fwd": sdpa_fwd, "fwd_bwd": both,
                                      "bwd": both - sdpa_fwd}
                    row["bound_ms"], row["bound_by"] = {}, {}
                    rate = "float32_3xtf32" if dname == "float32" \
                        else dname
                    for kname, (nbytes, flops) in _flash_work(
                            B, T, H, D, q.element_size(), causal).items():
                        row["bound_ms"][kname], row["bound_by"][kname] = \
                            bound_ms(nbytes, flops, rate)
                rows.append(row)
    return rows


def _flash_nan_cases(dev):
    """A NaN reaches each flash kernel's outputs as it reaches its plain
    version's: the card's own NaN (0x7fffffff, what q * scale gives for a
    NaN q) in q at one (batch, row, head) and in g at another, float32 and
    bfloat16, D = 64 and 128, T = 200, causal and not.  out, lse and dq
    must be NaN exactly where the plain versions' are, and so must dk and
    dv without the mask.  Under it the plain version puts a NaN row's NaN
    into every key's dk and dv (exp(-1e30 - NaN) and 0 * NaN are NaN at
    masked positions) and a tiled kernel only into the keys of the tiles
    that are live for that row's tile; so there, for any tile size, dk
    and dv must be (a) NaN wherever the plain version is NaN at a key j <=
    r, the keys that the NaN row r attends to, and (b) NaN nowhere the
    plain version is not.  Where the plain version is not NaN, kernel and
    plain version agree within the dtype's tolerance."""
    import torch

    from mxnet_tpu_torch.ops import flash_attention as fa

    nan = torch.tensor([0x7FFFFFFF], dtype=torch.int32).view(torch.float32)
    B, T, H = 2, 200, 2
    # each (batch, head)'s NaN row (q's at (0, 5, 0), g's at (1, 40, 1)),
    # -1 where none; the keys j <= it in dk and dv's layout
    nan_row = torch.full((B, 1, H, 1), -1, device=dev)
    nan_row[0, 0, 0, 0], nan_row[1, 0, 1, 0] = 5, 40
    attended = torch.arange(T, device=dev).view(1, T, 1, 1) <= nan_row
    rows = []
    for dtype in (torch.float32, torch.bfloat16):
        for D in (64, 128):
            for causal in (False, True):
                dname = str(dtype).split(".")[-1]
                g = torch.Generator(device=dev).manual_seed(SEED + D)
                q, k, v, go = (torch.randn(B, T, H, D, generator=g,
                                           device=dev) for _ in range(4))
                q[0, 5, 0, 3:4] = nan  # a bit copy: the pattern stays
                go[1, 40, 1, D - 1:] = nan
                q, k, v, go = (t.to(dtype) for t in (q, k, v, go))
                out, lse = fa.flash_attention_forward(q, k, v, causal)
                w_out, w_lse = fa.flash_attention_forward_reference(
                    q, k, v, causal)
                args = (q, k, v, go, w_lse, fa.flash_delta(w_out, go),
                        causal)
                scale = 1.0 / np.sqrt(D)
                got = (out, lse, fa.flash_attention_dq(*args),
                       *fa.flash_attention_dkv(*args))
                want = (w_out, w_lse,
                        fa.flash_attention_dq_reference(*args, scale),
                        *fa.flash_attention_dkv_reference(*args, scale))
                torch.cuda.synchronize()
                ok, counts = True, {}
                for name, a, b in zip(("out", "lse", "dq", "dk", "dv"),
                                      got, want):
                    a, b = a.float(), b.float()
                    na, nb = torch.isnan(a), torch.isnan(b)
                    counts[name] = [int(na.sum()), int(nb.sum())]
                    if causal and name in ("dk", "dv"):
                        placed = bool((na | ~(nb & attended)).all()) \
                            and not bool((na & ~nb).any())
                    else:
                        placed = bool(torch.equal(na, nb))
                    close, _, _ = _close(
                        a.masked_fill(nb, 0), b.masked_fill(nb, 0),
                        "float32" if name == "lse" else dname)
                    ok = ok and bool(nb.any()) and placed and close
                rows.append({"dtype": dname, "D": D, "causal": causal,
                             "nan_counts": counts, "ok": ok})
    return rows


def _launched(fn, family):
    """The names of the CUDA kernel functions containing ``family`` that
    ``fn`` launches (``torch.profiler``), and the sessions it took.  A
    session that records none of them runs again, up to three sessions: a
    process's profiler sessions can come back without kernels the program
    launched, and an empty list says nothing about which kernel ran."""
    import torch
    from torch.profiler import ProfilerActivity, profile

    names = []
    for sessions in range(1, 4):
        torch.cuda.synchronize()
        with profile(activities=[ProfilerActivity.CUDA]) as prof:
            fn()
            torch.cuda.synchronize()
        names = sorted({e.name for e in prof.events()
                        if e.device_type == torch.autograd.DeviceType.CUDA
                        and family in e.name})
        if names:
            break
    return names, sessions


def _routed(names, want):
    """Whether the kernel functions ``names`` are exactly ``want``, each
    run (demangled "name<" or mangled "nameI") and no other; and the
    others."""
    import re

    def hit(w, n):
        return re.search(rf"(?<![A-Za-z_]){w}[<I]", n) is not None

    ran = [w for w in want if any(hit(w, n) for n in names)]
    other = [n for n in names if not any(hit(w, n) for w in want)]
    return ran == list(want) and not other and len(names) == len(want), \
        other


def _flash_routes(dev):
    """Which kernel functions the three flash wrappers launch for each
    dtype (``torch.profiler`` over two calls of each at a small shape):
    bf16 must take the three tensor-core kernels, f32 the three 3xTF32
    kernels (``FLASH_ROUTES``), and no other flash kernel (bf16 no
    ``_tf32_kernel``, f32 no ``_tc_kernel``)."""
    import torch

    from mxnet_tpu_torch.ops import flash_attention as fa

    rows = []
    for dname, want in FLASH_ROUTES.items():
        dtype = getattr(torch, dname)
        g = torch.Generator(device=dev).manual_seed(SEED)
        q, k, v, go = (torch.randn(2, 128, 2, 64, generator=g,
                                   device=dev).to(dtype) for _ in range(4))

        def calls():
            for _ in range(2):
                out, lse = fa.flash_attention_forward(q, k, v, True)
                delta = fa.flash_delta(out, go)
                fa.flash_attention_dq(q, k, v, go, lse, delta, True)
                fa.flash_attention_dkv(q, k, v, go, lse, delta, True)

        names, sessions = _launched(calls, "flash_")
        ok, other = _routed(names, want)
        rows.append({"dtype": dname, "kernels": names, "other": other,
                     "profiler_sessions": sessions, "ok": ok})
    return rows


def _bf16_ulps(a, b, tol) -> float:
    """Largest |a - b| beyond the f32 tolerance ``tol`` that the two sides
    may differ by before rounding, in units of b's bf16 ulp (2^(e-7) for
    |b| in [2^e, 2^(e+1))): <= 1 means the two agree to one bf16 rounding."""
    import torch

    a, b = a.float(), b.float()
    e = torch.floor(torch.log2(b.abs().clamp_min(2.0 ** -126)))
    beyond = ((a - b).abs() - tol["atol"] - tol["rtol"] * b.abs())
    return (beyond.clamp_min(0.0) / torch.exp2(e - 7)).max().item()


def _rotating(xs):
    """A call argument that cycles through ``xs`` (copies of one input,
    more bytes than the 50 MB L2 together), so chained timed calls read
    device memory as the training step does, not L2."""
    it = itertools.cycle(xs)
    return lambda: next(it)


def _batch_norm_cases(dev):
    """Kernels 3-4 against their plain versions on the card at ResNet-50's
    BatchNorm shapes at B = 128 (the stem, stages 1, 2 and 4) and an odd
    M, f32 and bf16: ``bn_train_fused`` (stats, then normalize) against
    ``bn_train_reference`` — mean and var rtol 1e-5 / atol 1e-5, out the
    same in f32 and, in bf16, within one bf16 ulp beyond that f32
    tolerance (the kernel's ``x * scale + shift`` and the plain
    ``(x - mean) * scale + beta`` round differently in f32 before the
    cast) — and bitwise equal over two runs.  Times of each kernel alone
    (and of the pair) against its plain version and one PyTorch call:
    ``torch.var_mean`` for the stats, ``torch.addcmul`` for normalize,
    ``F.batch_norm`` on the ``channels_last`` tensor for the pair."""
    import torch
    import torch.nn.functional as F

    from mxnet_tpu_torch.ops import batch_norm as bn

    rows = []
    for (B, H, W, C), dtype in itertools.product(
            BN_SHAPES, (torch.float32, torch.bfloat16)):
        M = B * H * W
        dname = str(dtype).split(".")[-1]
        g = torch.Generator(device=dev).manual_seed(SEED + C)
        x = (torch.randn(M, C, generator=g, device=dev) * 2.0 + 0.5
             ).to(dtype)
        gam = 1.0 + 0.1 * torch.randn(C, generator=g, device=dev)
        bet = 0.1 * torch.randn(C, generator=g, device=dev)
        runs = [bn.bn_train_fused(x, gam, bet, 1e-5) for _ in range(2)]
        want = bn.bn_train_reference(x, gam, bet, 1e-5)
        torch.cuda.synchronize()
        errs, ok = {}, True
        for name, a, b in zip(("out", "mean", "var"), runs[0], want):
            good, errs[name], _ = _close(a, b, "batch_norm")
            if name == "out" and dtype == torch.bfloat16:
                errs["out_bf16_ulps"] = _bf16_ulps(a, b, TOL["batch_norm"])
                good = errs["out_bf16_ulps"] <= 1.0
            ok = ok and good and bool(torch.isfinite(a).all())
        bitwise = all(bool(torch.equal(a, b))
                      for a, b in zip(runs[0], runs[1]))
        _, mean, var = want
        scale = gam * torch.rsqrt(var + 1e-5)
        shift = bet - mean * scale
        item = x.element_size()
        copies = max(1, -(-120_000_000 // (M * C * item)))
        xs = [x] + [x.clone() for _ in range(copies - 1)]
        nxt = _rotating(xs)
        nxt4 = _rotating([t.view(B, H, W, C).permute(0, 3, 1, 2)
                          for t in xs])
        ms = {"stats": time_ms(lambda _: bn.bn_stats(nxt())[0], x),
              "normalize": time_ms(lambda _: bn.bn_normalize(
                  nxt(), scale, shift), x),
              "pair": time_ms(lambda _: bn.bn_train_fused(
                  nxt(), gam, bet, 1e-5)[0], x)}
        plain = {"stats": time_ms(lambda _: bn.bn_stats_reference(
                     nxt())[0], x),
                 "normalize": time_ms(lambda _: bn.bn_normalize_reference(
                     nxt(), scale, shift), x),
                 "pair": time_ms(lambda _: bn.bn_train_reference(
                     nxt(), gam, bet, 1e-5)[0], x)}
        lib = {"stats": time_ms(lambda _: torch.var_mean(
                   nxt(), dim=0, unbiased=False)[0], x),
               "normalize": time_ms(lambda _: torch.addcmul(
                   shift, nxt(), scale), x),
               "pair": time_ms(lambda _: F.batch_norm(
                   nxt4(), None, None, gam, bet, True, 0.1, 1e-5), x)}
        work = {"stats": (M * C * item + 2 * C * 4, 3 * M * C),
                "normalize": (2 * M * C * item + 2 * C * 4, 2 * M * C)}
        # the pair reads x once and writes out once at the least
        work["pair"] = (2 * M * C * item + 4 * C * 4, 5 * M * C)
        bounds = {k: bound_ms(nb, fl, "float32") for k, (nb, fl)
                  in work.items()}
        rows.append({"shape": [B, H, W, C], "M": M, "C": C, "dtype": dname,
                     "ok": ok and bitwise,
                     "bitwise_deterministic": bitwise, "max_abs_err": errs,
                     "l2_copies": copies, "ms": ms, "plain_ms": plain,
                     "library_ms": lib,
                     "bound_ms": {k: v[0] for k, v in bounds.items()},
                     "bound_by": {k: v[1] for k, v in bounds.items()}})
        del x, xs, runs, want, nxt, nxt4
    return rows


def _batch_norm_backward_cases(dev):
    """BatchNorm's gradient on the card at ResNet-50 stage-1 rows (B = 32,
    56x56, C = 256): the kernel forward plus autograd through the plain
    version (``_BatchNormFn``) against autograd through the plain version
    alone, for dx, dgamma and dbeta, normwise."""
    import torch

    from mxnet_tpu_torch.ops import batch_norm as bn

    g = torch.Generator(device=dev).manual_seed(SEED + 2)
    shape = (32, 56, 56, 256)
    rows = []
    for dtype in (torch.float32, torch.bfloat16):
        x = (torch.randn(*shape, generator=g, device=dev) * 2.0 + 0.5
             ).to(dtype).requires_grad_()
        gam = (1.0 + 0.1 * torch.randn(shape[-1], generator=g, device=dev)
               ).requires_grad_()
        bet = (0.1 * torch.randn(shape[-1], generator=g, device=dev)
               ).requires_grad_()
        dy = torch.randn(*shape, generator=g, device=dev).to(dtype)
        n0 = bn.bn_stats.launches
        out = bn.bn_train_fused(x, gam, bet, 1e-5)[0]
        launched = bn.bn_stats.launches - n0
        got = torch.autograd.grad(out, (x, gam, bet), dy)
        want = torch.autograd.grad(bn.bn_train_reference(x, gam, bet, 1e-5)[0],
                                   (x, gam, bet), dy)
        torch.cuda.synchronize()
        rel = {n: ((a.float() - b.float()).norm() / b.float().norm()).item()
               for n, a, b in zip(("dx", "dgamma", "dbeta"), got, want)}
        dname = str(dtype).split(".")[-1]
        rows.append({"shape": list(shape), "dtype": dname,
                     "grad_fn": out.grad_fn is not None, "launches": launched,
                     "grad_rel_err": rel,
                     "ok": out.grad_fn is not None and launched == 1
                     and max(rel.values()) <= BN_GRAD_TOL[dname]})
        del x, dy, out, got, want
    return rows


def _twobit_inputs(dev, shape, t, gen):
    """A gradient (N(0, 0.6^2)) and residual (N(0, 0.2^2)) of ``shape``
    whose first elements are exactly +t, -t, 0 and +t with residual 0."""
    import torch

    grad = torch.randn(shape, generator=gen, device=dev) * 0.6
    res = torch.randn(shape, generator=gen, device=dev) * 0.2
    k = min(4, grad.numel())
    grad.view(-1)[:k] = torch.tensor([t, -t, 0.0, t], device=dev)[:k]
    res.view(-1)[:k] = 0.0
    return grad, res


def _twobit_case(dev, shape, t, gen):
    """Pack and unpack (f32 and bf16 out) against their plain versions at
    one shape and threshold: packed words (shape and bits), new residual
    and unpacked values, each bitwise equal."""
    import torch

    from mxnet_tpu_torch.ops import twobit as tb

    grad, res = _twobit_inputs(dev, shape, t, gen)
    packed, newres = tb.twobit_pack(grad, res, t)
    want_p, want_r = tb.twobit_pack_reference(grad, res, t)
    ok = {"packed": tuple(packed.shape) == tuple(want_p.shape)
          and torch.equal(packed.view(torch.int32),
                          want_p.view(torch.int32)),
          "residual": torch.equal(newres.view(torch.int32),
                                  want_r.view(torch.int32))}
    err = (newres - want_r).abs().max().item()
    for dtype, ints in ((torch.float32, torch.int32),
                        (torch.bfloat16, torch.int16)):
        out = tb.twobit_unpack(packed, shape, t, dtype)
        want = tb.twobit_unpack_reference(want_p, shape, t, dtype)
        ok["unpack_" + str(dtype).split(".")[-1]] = torch.equal(
            out.view(ints), want.view(ints))
        err = max(err, (out.float() - want.float()).abs().max().item())
    return ok, err


def _twobit_cases(dev):
    """Kernels 1-2 against their plain versions on the card, bit for bit
    (zero tolerance): every one of ResNet-50's 193 trainable parameter
    shapes (the gradients of a compressed step) at the threshold 0.5; the
    edge sizes of TWOBIT_EDGES at thresholds 0.5, 0 (padded words 0b11)
    and 1e9; each input with elements exactly at +-t.  Times (CUDA graph
    of chained calls, inputs rotating past the 50 MB L2) at the largest
    shape and summed over the 193 shapes of a step, against the plain
    versions and the byte bound: pack reads grad and residual and writes
    the residual (12 bytes an element) and the words (512 bytes a row);
    unpack reads the words and writes 4 bytes an element.  No single
    PyTorch call packs or unpacks, so there is no library time."""
    import math

    import torch

    from mxnet_tpu_torch.ops import twobit as tb

    _, _, params, _ = _resnet(dev)
    shapes = [tuple(v.shape) for v in params.values()]
    del params
    gen = torch.Generator(device=dev).manual_seed(SEED + 4)
    cases = [(s, TWOBIT_THRESHOLD) for s in shapes] + [
        ((n,), t) for n in TWOBIT_EDGES for t in (TWOBIT_THRESHOLD, 0.0, 1e9)]
    bad, err = [], 0.0
    for shape, t in cases:
        ok, e = _twobit_case(dev, shape, t, gen)
        err = max(err, e)
        if not all(ok.values()):
            bad.append({"shape": list(shape), "threshold": t, **ok})
    torch.cuda.synchronize()

    def work(n):
        words = tb.packed_rows(n) * tb.WORDS_PER_ROW
        return {"pack": (12 * n + 4 * words, 5 * n),
                "unpack": (4 * words + 4 * n, n)}

    t = TWOBIT_THRESHOLD
    big = max(shapes, key=math.prod)
    n = math.prod(big)
    copies = max(1, -(-120_000_000 // (8 * n)))
    pairs = [_twobit_inputs(dev, big, t, gen) for _ in range(copies)]
    words = [tb.twobit_pack(g, r, t)[0] for g, r in pairs]
    nxt, nxt_w = _rotating(pairs), _rotating(words)
    ms = {"pack": time_ms(lambda _: tb.twobit_pack(*nxt(), t)[1], pairs[0][0]),
          "unpack": time_ms(lambda _: tb.twobit_unpack(nxt_w(), big, t),
                            pairs[0][0])}
    plain = {"pack": time_ms(lambda _: tb.twobit_pack_reference(
                 *nxt(), t)[1], pairs[0][0]),
             "unpack": time_ms(lambda _: tb.twobit_unpack_reference(
                 nxt_w(), big, t), pairs[0][0])}
    bounds = {k: bound_ms(*v, "float32") for k, v in work(n).items()}
    del pairs, words, nxt, nxt_w
    # one step's worth: every gradient of the net once (313.6 MB for pack)
    step = [_twobit_inputs(dev, s, t, gen) for s in shapes]
    step_words = [tb.twobit_pack(g, r, t)[0] for g, r in step]

    def all_of(fn, args):
        def run(_):
            for a in args:
                out = fn(*a)
            return out
        return run

    pack_args = [(g, r, t) for g, r in step]
    unpack_args = [(w, s, t) for w, s in zip(step_words, shapes)]
    step_ms = {"pack": time_ms(all_of(lambda *a: tb.twobit_pack(*a)[1],
                                      pack_args), None, iters=5),
               "unpack": time_ms(all_of(tb.twobit_unpack, unpack_args),
                                 None, iters=5)}
    step_plain = {"pack": time_ms(all_of(
                      lambda *a: tb.twobit_pack_reference(*a)[1], pack_args),
                      None, iters=5),
                  "unpack": time_ms(all_of(tb.twobit_unpack_reference,
                                           unpack_args), None, iters=5)}
    total = {k: [sum(work(math.prod(s))[k][i] for s in shapes)
                 for i in (0, 1)] for k in ("pack", "unpack")}
    step_bounds = {k: bound_ms(*v, "float32") for k, v in total.items()}
    del step, step_words, pack_args, unpack_args
    return [{"kernel": k, "ok": not bad, "cases": len(cases),
             "mismatches": bad, "max_abs_err": err,
             "tolerance": "bitwise",
             "largest_shape": list(big), "ms": ms[k], "plain_ms": plain[k],
             "bound_ms": bounds[k][0], "bound_by": bounds[k][1],
             "library_ms": None, "step_tensors": len(shapes),
             "step_elements": sum(math.prod(s) for s in shapes),
             "step_bytes": total[k][0], "step_ms": step_ms[k],
             "step_plain_ms": step_plain[k],
             "step_bound_ms": step_bounds[k][0]}
            for k in ("pack", "unpack")]


def phase_kernels(dev):
    rows = {"twobit": _twobit_cases(dev),
            "batch_norm": _batch_norm_cases(dev),
            "batch_norm_backward": _batch_norm_backward_cases(dev),
            "layer_norm": _layer_norm_cases(dev),
            "layer_norm_backward": _layer_norm_backward_cases(dev),
            "paged_attention": _paged_attention_cases(dev),
            "paged_attention_int8": _paged_attention_cases(dev, int8=True),
            "paged_routes": _paged_routes(dev),
            "flash_attention": _flash_cases(dev),
            "flash_nan": _flash_nan_cases(dev),
            "flash_routes": _flash_routes(dev)}
    emit({"phase": "kernels", "tolerance": TOL, **rows})
    bad = [r for rs in rows.values() for r in rs if not r["ok"]]
    if bad:
        raise SystemExit(f"kernel disagrees with its plain version: {bad}")
    return rows


# -- phase 4 ------------------------------------------------------------------------
def _model(dev):
    from mxnet_tpu_torch.parallel.transformer import (TransformerConfig,
                                                      transformer_lm_init)

    cfg = TransformerConfig(**GPT2_SMALL)
    return cfg, transformer_lm_init(cfg, seed=SEED, device=dev)


def phase_model(dev, cfg, params):
    import torch

    from mxnet_tpu_torch.ops.layer_norm import layer_norm_fused
    from mxnet_tpu_torch.ops.paged_attention import paged_attention
    from mxnet_tpu_torch.parallel.transformer import (transformer_lm_apply,
                                                      transformer_lm_decode)

    bs, nb, T, n_prompt, n_dec = 32, 64, 128, 100, 4
    rs = np.random.RandomState(SEED)
    seq = rs.randint(0, cfg.vocab, size=n_prompt + n_dec).astype(np.int64)
    shape = (cfg.n_layers, nb, bs, cfg.n_heads, cfg.d_head)
    k_pool = torch.zeros(shape, device=dev)
    v_pool = torch.zeros(shape, device=dev)
    W = 8
    table = np.zeros((1, W), np.int32)
    table[0, :4] = [5, 9, 2, 17]
    ln0, pa0 = layer_norm_fused.launches, paged_attention.launches
    toks = np.zeros((1, T), np.int64)
    toks[0, :n_prompt] = seq[:n_prompt]
    logits, k_pool, v_pool = transformer_lm_decode(
        params, toks, np.arange(T)[None], [n_prompt], k_pool, v_pool, table,
        cfg, attention_kernel="paged")
    got = [logits[0, :n_prompt]]
    for j in range(n_dec):
        p = n_prompt + j
        lg, k_pool, v_pool = transformer_lm_decode(
            params, seq[None, p:p + 1], [[p]], [1], k_pool, v_pool, table,
            cfg, attention_kernel="paged")
        got.append(lg[0])
    got = torch.cat(got, dim=0)
    want = transformer_lm_apply(
        params, torch.as_tensor(seq[None], device=dev),
        torch.arange(len(seq), device=dev), cfg)[0]
    torch.cuda.synchronize()
    diff = (got - want).abs()
    ok = bool((diff <= 1e-4 + 1e-3 * want.abs()).all())
    launches = {"layer_norm": layer_norm_fused.launches - ln0,
                "paged_attention": paged_attention.launches - pa0}
    int8 = _model_int8(dev, cfg, params, seq, n_prompt, n_dec, T, table)
    emit({"phase": "model", "config": GPT2_SMALL, "prompt": n_prompt,
          "prefill_bucket": T, "decode_steps": n_dec, "ok": ok,
          "max_abs_err": diff.max().item(), "tolerance":
          {"rtol": 1e-3, "atol": 1e-4}, "launches": launches,
          "int8": int8, "step_ms": _step_times(dev, cfg, params)})
    if not ok:
        raise SystemExit("paged model step disagrees with the full forward")
    if not int8["ok"]:
        raise SystemExit("int8 paged model step disagrees with the gather "
                         "path")


def _model_int8(dev, cfg, params, seq, n_prompt, n_dec, T, table):
    """The same prefill chunk + decode steps through int8 pools, once with
    the paged path (the int8 kernel) and once with the dequantizing gather
    path: layer-0 pool writes (block 0 aside) must be bitwise equal, and
    the logits within 2% of max |logit| (the reference's own bound for its
    kernel against its gather path)."""
    import torch

    from mxnet_tpu_torch.ops.paged_attention import paged_attention
    from mxnet_tpu_torch.parallel.transformer import transformer_lm_decode

    nb, bs = 64, 32
    shape = (cfg.n_layers, nb, bs, cfg.n_heads, cfg.d_head)
    sshape = (cfg.n_layers, nb, cfg.n_heads)
    runs = {}
    for kernel in ("paged", "gather"):
        pools = [torch.zeros(shape, dtype=torch.int8, device=dev),
                 torch.zeros(shape, dtype=torch.int8, device=dev),
                 torch.ones(sshape, device=dev),
                 torch.ones(sshape, device=dev)]
        q0 = paged_attention.launches_int8
        toks = np.zeros((1, T), np.int64)
        toks[0, :n_prompt] = seq[:n_prompt]
        feeds = [(toks, np.arange(T)[None], [n_prompt])] + [
            (seq[None, p:p + 1], [[p]], [1])
            for p in range(n_prompt, n_prompt + n_dec)]
        logits = []
        for tk, ps, ln in feeds:
            lg, *pools = transformer_lm_decode(
                params, tk, ps, ln, pools[0], pools[1], table, cfg,
                attention_kernel=kernel, k_scale=pools[2],
                v_scale=pools[3])
            logits.append(lg[0, :ln[0]])
        torch.cuda.synchronize()
        runs[kernel] = (torch.cat(logits), pools,
                        paged_attention.launches_int8 - q0)
    (lp, pp, np_), (lg, pg, ng) = runs["paged"], runs["gather"]
    layer0_equal = all(bool(torch.equal(a[0, 1:], b[0, 1:]))
                       for a, b in zip(pp, pg))
    err = (lp - lg).abs().max().item()
    bound = 0.02 * lg.abs().max().item()
    return {"ok": layer0_equal and err <= bound and np_ > 0 and ng == 0,
            "layer0_pools_equal": layer0_equal, "max_abs_err": err,
            "bound": bound, "int8_launches": {"paged": np_, "gather": ng}}


def _step_times(dev, cfg, params):
    """Host wall time (ending in a device sync) of the serving step's
    parts, eager as the engine runs them: a decode model step at
    max_slots=8 (contexts of 300 positions, table width 16), the sampler
    over its (8, vocab) logits, and a T=512 prefill chunk; then the same
    decode step through an int8 pool, with its two int8-specific parts
    alone: the 2 x n_layers quantizing scatters and the n_layers int8
    paged-attention kernel calls (the float pool's n_layers kernel calls
    beside them), as host wall time and as device time."""
    import torch

    from mxnet_tpu_torch.ops.paged_attention import (attention_scale,
                                                     paged_attention)
    from mxnet_tpu_torch.ops.sampling import sample_logits
    from mxnet_tpu_torch.parallel.transformer import (_scatter_kv_quantized,
                                                      transformer_lm_decode)

    B, bs, W, ctx = 8, 32, 16, 300
    nb = 1 + B * W
    shape = (cfg.n_layers, nb, bs, cfg.n_heads, cfg.d_head)
    k_pool = torch.zeros(shape, device=dev)
    v_pool = torch.zeros(shape, device=dev)
    tables = np.arange(1, 1 + B * W, dtype=np.int32).reshape(B, W)
    rs = np.random.RandomState(SEED)

    def median_ms(fn, n=15):
        fn()
        torch.cuda.synchronize()
        ts = []
        for _ in range(n):
            t0 = time.perf_counter()
            fn()
            torch.cuda.synchronize()
            ts.append((time.perf_counter() - t0) * 1e3)
        return float(np.median(ts))

    toks = rs.randint(0, cfg.vocab, (B, 1))
    decode = median_ms(lambda: transformer_lm_decode(
        params, toks, np.full((B, 1), ctx), np.ones(B), k_pool, v_pool,
        tables, cfg))
    logits = torch.randn(B, cfg.vocab, device=dev)
    seeds = torch.arange(B, device=dev)
    temp = torch.full((B,), 0.8, device=dev)
    top_k = torch.full((B,), 40, device=dev)
    top_p = torch.ones(B, device=dev)
    sample = median_ms(lambda: sample_logits(logits, seeds, seeds + ctx,
                                             temp, top_k, top_p))
    ptoks = rs.randint(0, cfg.vocab, (1, 512))
    prefill = median_ms(lambda: transformer_lm_decode(
        params, ptoks, np.arange(512)[None], [512], k_pool, v_pool,
        tables[:1], cfg), n=5)
    # int8 pool: the whole step, then its scatter and kernel parts alone
    kq, vq, ksq, vsq = _int8_pools(dev, nb, bs, cfg.n_heads, cfg.d_head,
                                   SEED)
    kq = kq[None].repeat(cfg.n_layers, 1, 1, 1, 1)
    vq = vq[None].repeat(cfg.n_layers, 1, 1, 1, 1)
    ksq = ksq.nan_to_num(1.0)[None].repeat(cfg.n_layers, 1, 1)
    vsq = vsq.nan_to_num(1.0)[None].repeat(cfg.n_layers, 1, 1)
    decode_q = median_ms(lambda: transformer_lm_decode(
        params, toks, np.full((B, 1), ctx), np.ones(B), kq, vq, tables,
        cfg, k_scale=ksq, v_scale=vsq))
    t_tab = torch.as_tensor(tables, device=dev)
    pos = torch.full((B, 1), ctx, dtype=torch.int32, device=dev)
    valid = torch.ones(B, 1, dtype=torch.bool, device=dev)
    max_pos = torch.full((B,), ctx, dtype=torch.int32, device=dev)
    vals = torch.randn(B, 1, cfg.n_heads, cfg.d_head, device=dev)

    def scatters():
        for i in range(cfg.n_layers):
            _scatter_kv_quantized(kq[i], ksq[i], vals, t_tab, pos, valid,
                                  max_pos, 1)
            _scatter_kv_quantized(vq[i], vsq[i], vals, t_tab, pos, valid,
                                  max_pos, 1)

    q = torch.randn(B, 1, cfg.n_heads, cfg.d_head, device=dev)
    scale = attention_scale(cfg.d_head)

    def attend(quantized, x=q):
        for i in range(cfg.n_layers):
            if quantized:
                y = paged_attention(x, kq[i], vq[i], t_tab, pos, max_pos,
                                    scale, ksq[i], vsq[i])
            else:
                y = paged_attention(x, k_pool[i], v_pool[i], t_tab, pos,
                                    max_pos, scale)
        return y

    # the n_layers calls' device time: a CUDA graph of them, the next
    # step's queries the last call's output
    return {"decode_b8_w16": decode, "sample_b8": sample,
            "prefill_t512": prefill, "decode_int8_b8_w16": decode_q,
            "int8_scatters_b8": median_ms(scatters),
            "int8_attention_b8": median_ms(lambda: attend(True)),
            "float_attention_b8": median_ms(lambda: attend(False)),
            "int8_attention_b8_device": time_ms(
                lambda x: attend(True, x), q, iters=5),
            "float_attention_b8_device": time_ms(
                lambda x: attend(False, x), q, iters=5)}


# -- phase 5 ------------------------------------------------------------------------
def _service(dev, cfg, params, kv_dtype=None):
    """The serving configuration and its 12 requests: prompt lengths
    16..512 from a numpy seed (the largest rung, 512, is the longest
    prompt submit() accepts; prompts past the smallest rung, 64, prefill
    in chunks), 8 greedy and 4 sampled."""
    from mxnet_tpu_torch.serving.generation import (GenerationConfig,
                                                    GenerationService)

    gcfg = GenerationConfig(max_slots=8, block_size=32, num_blocks=2048,
                            seq_buckets=[64, 128, 256, 512],
                            max_new_tokens=32, preemption=False,
                            prefix_cache=False, kv_dtype=kv_dtype)
    rs = np.random.RandomState(SEED)
    lens = rs.randint(16, 513, size=12)
    prompts = [rs.randint(0, cfg.vocab, size=int(n)) for n in lens]
    return GenerationService(params, cfg, gcfg, device=dev), prompts


def _serve(svc, prompts):
    """Submit every request at once and wait; the streams and outputs."""
    streams = []
    for i, p in enumerate(prompts):
        if i < 8:
            streams.append(svc.submit(p))
        else:
            streams.append(svc.submit(p, temperature=0.8, top_k=40, seed=i))
    return streams, [s.result(timeout=600) for s in streams]


def _reset_launches():
    from mxnet_tpu_torch.ops import batch_norm as bn
    from mxnet_tpu_torch.ops import flash_attention as fa
    from mxnet_tpu_torch.ops import nn as ops_nn
    from mxnet_tpu_torch.ops import twobit as tb
    from mxnet_tpu_torch.ops.layer_norm import layer_norm_fused
    from mxnet_tpu_torch.ops.paged_attention import paged_attention

    tb.twobit_pack.launches = 0
    tb.twobit_unpack.launches = 0
    ops_nn.batch_norm.noncontiguous_copies = 0
    bn.bn_stats.launches = 0
    bn.bn_normalize.launches = 0
    layer_norm_fused.launches = 0
    paged_attention.launches = 0
    paged_attention.launches_int8 = 0
    fa.flash_attention_forward.launches = 0
    fa.flash_attention_dq.launches = 0
    fa.flash_attention_dkv.launches = 0


def _read_launches():
    """Each kernel's launches since :func:`_reset_launches`, and the copies
    the BatchNorm op made of non-contiguous channels-last input (a layout
    slip: 0 on every ResNet path)."""
    from mxnet_tpu_torch.ops import batch_norm as bn
    from mxnet_tpu_torch.ops import flash_attention as fa
    from mxnet_tpu_torch.ops import nn as ops_nn
    from mxnet_tpu_torch.ops import twobit as tb
    from mxnet_tpu_torch.ops.layer_norm import layer_norm_fused
    from mxnet_tpu_torch.ops.paged_attention import paged_attention

    return {"twobit_pack": tb.twobit_pack.launches,
            "twobit_unpack": tb.twobit_unpack.launches,
            "bn_noncontiguous_copies":
            ops_nn.batch_norm.noncontiguous_copies,
            "bn_stats": bn.bn_stats.launches,
            "bn_normalize": bn.bn_normalize.launches,
            "layer_norm": layer_norm_fused.launches,
            "paged_attention": paged_attention.launches,
            "paged_attention_int8": paged_attention.launches_int8,
            "flash_attention_fwd": fa.flash_attention_forward.launches,
            "flash_attention_dq": fa.flash_attention_dq.launches,
            "flash_attention_dkv": fa.flash_attention_dkv.launches}


def _greedy_check(dev, cfg, params, prompts, outs):
    """Greedy tokens teacher-forced against the full-sequence forward: a
    mismatch counts as a near tie where the oracle's top-2 logit gap is
    < 1e-3, else it is a failure.  Returns (mismatches, near ties, the
    per-request gap arrays)."""
    import torch

    from mxnet_tpu_torch.parallel.transformer import transformer_lm_apply

    mismatches, near_ties, gaps = [], 0, []
    for i, (prompt, out) in enumerate(zip(prompts, outs)):
        seq = np.concatenate([prompt, out])
        logits = transformer_lm_apply(
            params, torch.as_tensor(seq[None, :-1], device=dev),
            torch.arange(len(seq) - 1, device=dev), cfg)[0]
        tail = logits[len(prompt) - 1:]
        top2 = torch.topk(tail, 2, dim=-1).values
        gap = (top2[:, 0] - top2[:, 1]).cpu().numpy()
        pred = tail.argmax(dim=-1).cpu().numpy()
        for j, (a, b) in enumerate(zip(pred, out)):
            if int(a) != int(b):
                if gap[j] < 1e-3:
                    near_ties += 1
                else:
                    mismatches.append((i, j, int(a), int(b), float(gap[j])))
        gaps.append(gap)
    return mismatches, near_ties, gaps


def _window(stats, steps0, streams, wall, n_tokens):
    """Throughput, TTFT and model-step time of a served window."""
    ttft = sorted(s.ttft_ms for s in streams)
    return {"wall_s": wall, "tokens": n_tokens,
            "tokens_per_s": n_tokens / wall,
            "ttft_ms": {"p50": float(np.percentile(ttft, 50)),
                        "p99": float(np.percentile(ttft, 99))},
            "steps": {k: {"steps": v["steps"]
                          - steps0.get(k, {}).get("steps", 0),
                          "seconds": v["seconds"]
                          - steps0.get(k, {}).get("seconds", 0.0)}
                      for k, v in stats["step_seconds"].items()}}


def phase_serving(dev, cfg, params, kv_dtype=None, baseline=None):
    """The 12-request serving window (reserve-ahead; ``kv_dtype="int8"``:
    the ``serving_int8`` phase, held against the float pool's greedy
    tokens ``baseline``)."""
    import torch

    name = "serving_int8" if kv_dtype else "serving"
    svc, prompts = _service(dev, cfg, params, kv_dtype)
    lens = [len(p) for p in prompts]
    try:
        t0 = time.perf_counter()
        warmed = svc.warmup()
        warm_s = time.perf_counter() - t0
        steps0 = svc.stats()["step_seconds"]
        _reset_launches()
        t0 = time.perf_counter()
        streams, outs = _serve(svc, prompts)
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
        launches = _read_launches()
        stats = svc.stats()
        # batch-composition independence: each greedy request once more,
        # alone in the engine (decode still runs at all 8 slots' shape)
        alone = [svc.submit(p).result(timeout=600) for p in prompts[:8]]
    finally:
        svc.stop()
    n_tokens = sum(len(o) for o in outs)
    res = {"phase": name, "kv_dtype": stats["kv_dtype"], "requests": 12,
           "succeeded": len(outs), "failed": stats["counts"]["failed"],
           "prompt_lens": [int(n) for n in lens],
           **_window(stats, steps0, streams, wall, n_tokens),
           "warmup_s": warm_s, "warmup_signatures": warmed,
           "iterations": stats["iterations"],
           "prefill_tokens": stats["counts"]["prefill_tokens"],
           "launches": launches}
    alone_diverged = [
        (i, next(j for j, (a, b) in enumerate(zip(alone[i], outs[i]))
                 if a != b))
        for i in range(8) if alone[i] != outs[i]]
    res["greedy_alone_identical"] = 8 - len(alone_diverged)
    res["greedy_alone_diverged"] = alone_diverged
    res["sampled_in_support"] = all(
        len(o) == 32 and all(0 <= t < cfg.vocab for t in o)
        for o in outs[8:])
    res["outs"] = outs
    if kv_dtype is None:
        # greedy check, teacher-forced against the full-sequence forward;
        # a request served alone must emit the batched tokens up to the
        # first near-tie of the oracle (top-2 gap < 1e-3)
        mismatches, near_ties, gaps = _greedy_check(dev, cfg, params,
                                                    prompts[:8], outs[:8])
        for i, j in alone_diverged:
            if gaps[i][j] >= 1e-3:
                mismatches.append((i, j, "alone", alone[i][j], outs[i][j]))
        res.update(greedy_mismatches=mismatches,
                   greedy_near_tie_mismatches=near_ties)
        emit({k: v for k, v in res.items() if k != "outs"})
        if mismatches or not res["sampled_in_support"]:
            raise SystemExit("served tokens disagree with the oracle")
        if not (launches["layer_norm"] and launches["paged_attention"]):
            raise SystemExit(f"a kernel never launched on the serving "
                             f"path: {launches}")
        return res
    # int8: the float pool's greedy tokens are the reference, with the
    # reference's own bound for int8 against float (75% of positions)
    agree = sum(a == b for o1, o2 in zip(outs[:8], baseline["outs"][:8])
                for a, b in zip(o1, o2))
    total = sum(len(o) for o in baseline["outs"][:8])
    res.update(greedy_agreement_with_float=agree / total)
    emit({k: v for k, v in res.items() if k != "outs"})
    if len(outs) != 12 or res["failed"] or not res["sampled_in_support"]:
        raise SystemExit("int8 serving did not complete every request")
    if not (launches["layer_norm"] and launches["paged_attention_int8"]) \
            or launches["paged_attention"]:
        raise SystemExit(f"int8 serving did not run on LayerNorm and the "
                         f"int8 kernel alone: {launches}")
    if agree / total < 0.75:
        raise SystemExit(f"int8 greedy tokens agree with the float pool on "
                         f"{agree}/{total} positions (< 75%)")
    return res


def _default_traffic(cfg):
    """Two waves over four distinct 256-token (8-block) system prompts:
    wave 1 is one request each, system prompt plus a 16-128-token suffix
    (the first suffix 32 tokens, so that prompt is block-aligned); wave 2,
    sent when wave 1 has finished, three per system prompt: first the
    block-aligned wave-1 prompt again, then new suffixes."""
    rs = np.random.RandomState(SEED + 1)
    system = [rs.randint(0, cfg.vocab, 256) for _ in range(4)]

    def ask(i, n):
        return np.concatenate([system[i], rs.randint(0, cfg.vocab, n)])

    wave1 = [ask(i, 32 if i == 0 else int(rs.randint(16, 129)))
             for i in range(4)]
    wave2 = [wave1[0].copy()] + [ask(i, int(rs.randint(16, 129)))
                                 for i in range(4) for _ in range(3 - (i == 0))]
    return [wave1, wave2]


def phase_serving_default(dev, cfg, params):
    """``GenerationService`` with the reference's default preemption and
    prefix cache (f32 pool, a 52-block pool so that preemption fires),
    the serving phase's block size, rungs and max_new_tokens."""
    import torch

    from mxnet_tpu_torch.serving.generation import (GenerationConfig,
                                                    GenerationService)

    gcfg = GenerationConfig(max_slots=8, block_size=32,
                            num_blocks=DEFAULT_POOL_BLOCKS,
                            seq_buckets=[64, 128, 256, 512],
                            max_new_tokens=32)
    assert gcfg.preemption and gcfg.prefix_cache
    svc = GenerationService(params, cfg, gcfg, device=dev)
    waves = _default_traffic(cfg)
    try:
        t0 = time.perf_counter()
        warmed = svc.warmup()
        warm_s = time.perf_counter() - t0
        steps0 = svc.stats()["step_seconds"]
        _reset_launches()
        windows, prompts, outs = [], [], []
        for wave in waves:
            t0 = time.perf_counter()
            streams = [svc.submit(p) for p in wave]
            got = [st.result(timeout=600) for st in streams]
            torch.cuda.synchronize()
            stats = svc.stats()
            windows.append(_window(stats, steps0, streams,
                                   time.perf_counter() - t0,
                                   sum(len(o) for o in got)))
            steps0 = stats["step_seconds"]
            prompts += wave
            outs += got
        launches = _read_launches()
        preempted_reqs = sum(1 for st in streams if st._req.n_preempted)
    finally:
        svc.stop()
    counts = stats["counts"]
    mismatches, near_ties, _ = _greedy_check(dev, cfg, params, prompts, outs)
    res = {"phase": "serving_default", "requests": len(prompts),
           "succeeded": sum(len(o) == 32 for o in outs),
           "config": {"num_blocks": DEFAULT_POOL_BLOCKS, "preemption": True,
                      "prefix_cache": True,
                      "watermarks": stats["watermarks"]},
           "waves": windows, "warmup_s": warm_s,
           "warmup_signatures": warmed, "iterations": stats["iterations"],
           "prompt_tokens": int(sum(len(p) for p in prompts)),
           "counts": {k: counts[k] for k in (
               "preempted", "prefix_hits", "prefix_misses", "cached_tokens",
               "prefill_tokens", "cow_copies", "prefix_evictions",
               "tokens", "failed")},
           "wave2_preempted_requests": preempted_reqs,
           "peak_occupancy": stats["kv_blocks"]["peak_occupancy"],
           "greedy_mismatches": mismatches,
           "greedy_near_tie_mismatches": near_ties, "launches": launches}
    emit(res)
    if mismatches or res["succeeded"] != len(prompts):
        raise SystemExit("served tokens disagree with the oracle")
    need = ("prefix_hits", "cached_tokens", "cow_copies", "preempted")
    if not all(counts[k] > 0 for k in need):
        raise SystemExit(f"the default configuration did not exercise "
                         f"{need}: {res['counts']}")
    if not (launches["layer_norm"] and launches["paged_attention"]):
        raise SystemExit(f"a kernel never launched on the serving path: "
                         f"{launches}")
    return res


def _grad_rel_errors(m_a, m_b, m0, momentum):
    """Per-parameter normwise error ||a - b|| / ||b|| of the gradients read
    back from two steps' momenta: ``g = m_after - momentum * m_before``."""
    out = {}
    for k in m_b:
        a = m_a[k] - momentum * m0[k]
        b = m_b[k] - momentum * m0[k]
        out[k] = ((a - b).norm() / b.norm().clamp_min(1e-30)).item()
    return out


def phase_training(dev, cfg, params):
    """The LM training step of the reference's trainer
    (``benchmark/python/transformer/lm_bench.py``: B=8, T=1024, labels
    ``np.roll(tokens, -1, 1)``, lr 0.1, momentum 0.9) at GPT-2-small width.

    f32 check: one ``train_step`` with ``flash_attention(causal=True)``
    against one with ``local_attention(causal=True)`` from the same params
    and zero momenta — loss within 1e-5 relative, every parameter's
    gradient within 1e-4 normwise; each step's wall time (a second step)
    and device time (a third, under ``torch.profiler``: the union of its
    kernels' intervals).  Then the main path, lm_bench's flash
    leg: ten chained bf16 steps (``compute_dtype=torch.bfloat16``) on the
    same batch, counted from 0 — every loss finite, the last below the
    first, the first within 2e-2 of the f32 loss, and per step 12 launches
    of each flash kernel, 25 LayerNorms and no paged attention."""
    import functools

    import torch

    from mxnet_tpu_torch.ops.flash_attention import flash_attention
    from mxnet_tpu_torch.parallel.ring_attention import local_attention
    from mxnet_tpu_torch.parallel.transformer import train_step

    if torch.backends.cuda.matmul.allow_tf32 or \
            torch.backends.cudnn.allow_tf32:
        raise SystemExit("TF32 is on: the f32 comparison needs full f32")
    B, T, lr, momentum = 8, 1024, 0.1, 0.9
    rs = np.random.RandomState(SEED)
    tokens_np = rs.randint(0, cfg.vocab, (B, T))
    tokens = torch.as_tensor(tokens_np, device=dev)
    labels = torch.as_tensor(np.roll(tokens_np, -1, 1), device=dev)
    positions = torch.arange(T, device=dev)
    zeros = {k: torch.zeros_like(v) for k, v in params.items()}
    flash = functools.partial(flash_attention, causal=True)
    local = functools.partial(local_attention, causal=True)

    def timed_step(attention, p, m, dtype=None):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        res = train_step(p, m, tokens, labels, positions, cfg, lr=lr,
                         momentum=momentum, attention=attention,
                         compute_dtype=dtype)
        torch.cuda.synchronize()
        return res, (time.perf_counter() - t0) * 1e3

    n = cfg.n_layers
    per_step = {"flash_attention_fwd": n, "flash_attention_dq": n,
                "flash_attention_dkv": n, "layer_norm": 2 * n + 1,
                "paged_attention": 0, "paged_attention_int8": 0,
                "bn_stats": 0, "bn_normalize": 0, "twobit_pack": 0,
                "twobit_unpack": 0, "bn_noncontiguous_copies": 0}
    # f32: flash against local attention
    f32 = {}
    for name, att in (("flash", flash), ("local", local)):
        _reset_launches()
        torch.cuda.reset_peak_memory_stats()
        (loss, _, mom), first_ms = timed_step(att, params, zeros)
        launches = _read_launches()
        peak = torch.cuda.max_memory_allocated()
        _, again_ms = timed_step(att, params, zeros)
        f32[name] = {"loss": loss.item(), "momenta": mom,
                     "step_ms": again_ms,
                     "device_ms": _device_ms(
                         lambda: timed_step(att, params, zeros)),
                     "first_step_ms": first_ms,
                     "tokens_per_s": B * T / (again_ms / 1e3),
                     "peak_bytes": peak, "launches": launches}
    rel = _grad_rel_errors(f32["flash"]["momenta"], f32["local"]["momenta"],
                           zeros, momentum)
    loss_rel = abs(f32["flash"]["loss"] - f32["local"]["loss"]) \
        / abs(f32["local"]["loss"])
    worst = max(rel, key=rel.get)
    for v in f32.values():
        del v["momenta"]
    # the main path: lm_bench's bf16 flash leg, ten chained steps
    _reset_launches()
    torch.cuda.reset_peak_memory_stats()
    p, m, losses, step_ms = params, zeros, [], []
    for _ in range(10):
        (loss, p, m), ms = timed_step(flash, p, m, torch.bfloat16)
        losses.append(loss)
        step_ms.append(ms)
    launches = _read_launches()
    peak = torch.cuda.max_memory_allocated()
    losses = [x.item() for x in losses]
    del p, m
    steady = float(np.median(step_ms[1:]))
    res = {"phase": "training", "config": dataclasses.asdict(cfg),
           "B": B, "T": T,
           "lr": lr, "momentum": momentum,
           "f32": {"flash": f32["flash"], "local": f32["local"],
                   "loss_rel_err": loss_rel,
                   "grad_rel_err_max": rel[worst], "grad_rel_err_worst": worst,
                   "grad_rel_err": rel,
                   "tolerance": {"loss_rel": 1e-5, "grad_rel": 1e-4}},
           "bf16": {"losses": losses, "step_ms": step_ms,
                    "steady_step_ms": steady,
                    "tokens_per_s": B * T / (steady / 1e3),
                    "peak_bytes": peak, "launches": launches,
                    "first_loss_rel_to_f32":
                    abs(losses[0] - f32["flash"]["loss"])
                    / abs(f32["flash"]["loss"])},
           "launches": launches}
    emit(res)
    bad = []
    if loss_rel > 1e-5:
        bad.append(f"f32 flash loss differs from local by {loss_rel:.3g}")
    if rel[worst] > 1e-4:
        bad.append(f"gradient of {worst} differs by {rel[worst]:.3g}")
    if f32["flash"]["launches"] != per_step:
        bad.append(f"f32 flash step launches {f32['flash']['launches']}")
    if f32["local"]["launches"] != dict(
            per_step, flash_attention_fwd=0, flash_attention_dq=0,
            flash_attention_dkv=0):
        bad.append(f"f32 local step launches {f32['local']['launches']}")
    if launches != {k: 10 * v for k, v in per_step.items()}:
        bad.append(f"bf16 steps launched {launches}, not 10 x {per_step}")
    if not all(np.isfinite(losses)):
        bad.append(f"non-finite bf16 loss: {losses}")
    elif not losses[-1] < losses[0]:
        bad.append(f"bf16 loss did not fall at lr {lr}, momentum "
                   f"{momentum}: {losses}")
    if res["bf16"]["first_loss_rel_to_f32"] > 2e-2:
        bad.append(f"bf16 first loss {losses[0]} vs f32 "
                   f"{f32['flash']['loss']}")
    if bad:
        raise SystemExit("training phase failed: " + "; ".join(bad))
    return res


def _profiled(fn):
    """Run ``fn`` under ``torch.profiler``: wall time, device busy time
    (the union of kernel intervals), the idle share, device time by kernel
    name, and by autograd backward node.  The profiler slows the host, so
    the wall time is not an unprofiled run's."""
    import torch
    from torch.profiler import ProfilerActivity, profile

    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        fn()
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
    kernels = [e for e in prof.events()
               if e.device_type == torch.autograd.DeviceType.CUDA]
    spans = sorted((e.time_range.start, e.time_range.end) for e in kernels)
    busy_us, end = 0.0, float("-inf")
    for s, e in spans:   # union of kernel intervals (one stream: ~the sum)
        if e > end:
            busy_us += e - max(s, end)
            end = e
    by_name = {}
    for e in kernels:
        agg = by_name.setdefault(e.name, [0, 0.0])
        agg[0] += 1
        agg[1] += e.time_range.elapsed_us()
    top = sorted(by_name.items(), key=lambda kv: -kv[1][1])[:12]
    # the port's own kernels, by kernel function
    ours = {}
    for n, (c, us) in by_name.items():
        for k in PORT_KERNELS:
            if k in n:
                ours[k] = ours.get(k, 0.0) + us / 1e3
    # device time under each autograd backward node, inclusive of the
    # kernels its ops launch (a node whose backward runs autograd itself,
    # as the BatchNorm and LayerNorm Functions' do, includes the nodes it
    # evaluates, so the times nest and do not add up)
    nodes = {}
    for e in prof.key_averages():
        if e.key.startswith("autograd::engine::evaluate_function: "):
            us = getattr(e, "device_time_total", None)
            if us is None:
                us = e.cuda_time_total
            nodes[e.key.split(": ", 1)[1]] = us / 1e3
    return {"wall_s": wall, "kernels": len(kernels),
            "device_busy_s": busy_us / 1e6,
            "idle_share": 1.0 - busy_us / 1e6 / wall,
            "top": [{"name": n[:80], "count": c, "ms": us / 1e3}
                    for n, (c, us) in top],
            "port_kernels_ms": ours,
            "backward_nodes_ms": dict(sorted(nodes.items(),
                                             key=lambda kv: -kv[1])[:10])}


def _device_ms(fn):
    """Device time of ``fn`` in ms, the union of its kernels' intervals
    (``_profiled``), or None when three profiler sessions record no kernel
    (a session can come back empty; see ``_launched``)."""
    for _ in range(3):
        res = _profiled(fn)
        if res["kernels"]:
            return res["device_busy_s"] * 1e3
    return None


def phase_profile(dev, cfg, params):
    """Optional (not in the default run): the serving window once more
    under ``torch.profiler`` — device time by kernel name and the share of
    the window with no kernel running."""
    svc, prompts = _service(dev, cfg, params)
    try:
        svc.warmup()
        res = _profiled(lambda: _serve(svc, prompts))
    finally:
        svc.stop()
    emit({"phase": "profile", **res})


def phase_profile_training(dev, cfg, params):
    """Optional (not in the default run): two chained bf16 training steps
    of the ``training`` phase's main path under ``torch.profiler``, after
    one unprofiled warm-up step; the flash kernels that ran must be the
    bf16 ones (``FLASH_ROUTES``)."""
    import functools

    import torch

    from mxnet_tpu_torch.ops.flash_attention import flash_attention
    from mxnet_tpu_torch.parallel.transformer import train_step

    B, T = 8, 1024
    tokens_np = np.random.RandomState(SEED).randint(0, cfg.vocab, (B, T))
    tokens = torch.as_tensor(tokens_np, device=dev)
    labels = torch.as_tensor(np.roll(tokens_np, -1, 1), device=dev)
    positions = torch.arange(T, device=dev)
    state = [params, {k: torch.zeros_like(v) for k, v in params.items()}]

    def steps(n):
        for _ in range(n):
            _, state[0], state[1] = train_step(
                state[0], state[1], tokens, labels, positions, cfg,
                attention=functools.partial(flash_attention, causal=True),
                compute_dtype=torch.bfloat16)

    steps(1)
    torch.cuda.synchronize()
    res = _profiled(lambda: steps(2))
    emit({"phase": "profile_training", "steps": 2, **res})
    # the bf16 window's flash kernels are the routed ones, by name
    ran = {k for k in res["port_kernels_ms"] if k.startswith("flash_")}
    if ran != set(FLASH_ROUTES["bfloat16"]):
        raise SystemExit(f"bf16 training ran flash kernels {sorted(ran)}, "
                         f"not {FLASH_ROUTES['bfloat16']}")


# -- phase 9 ------------------------------------------------------------------------
def _resnet(dev):
    """``resnet50_v1(classes=1000, layout="NHWC")``, Gluon's default
    initializer drawing from seed 0, shapes resolved by one eager forward;
    with ``block_train_fn``'s function and initial tensors."""
    import torch

    from mxnet_tpu_torch.gluon.model_zoo.vision import resnet50_v1
    from mxnet_tpu_torch.parallel.data_parallel import block_train_fn

    net = resnet50_v1(classes=RESNET_CLASSES, layout="NHWC")
    net.initialize(ctx=dev,
                   generator=torch.Generator(device=dev).manual_seed(SEED))
    with torch.no_grad():
        net(torch.zeros(1, RESNET_HW, RESNET_HW, 3, device=dev))
    return net, *block_train_fn(net, is_train=True)


def _resnet_step(apply_fn, params, momenta, aux, x, y, dtype=None):
    """``bench.py``'s ``make_step`` over ``block_train_fn``: params, aux
    and input cast to ``dtype`` inside the loss (None: f32), f32 logits,
    ``log_softmax`` NLL mean, ``m = 0.9 m + g``, ``p = p - 0.1 m``.  Returns
    new dicts (the new running statistics in aux's dtype) and the
    gradients; the inputs are untouched."""
    import torch

    leaves = {k: v.detach().requires_grad_() for k, v in params.items()}
    p, a, xc = leaves, aux, x
    if dtype is not None:
        p = {k: v.to(dtype) for k, v in leaves.items()}
        a = {k: v.to(dtype) for k, v in aux.items()}
        xc = x.to(dtype)
    out, new_aux = apply_fn(p, a, xc)
    logp = torch.log_softmax(out.float(), dim=-1)
    loss = -logp.gather(1, y[:, None]).mean()
    grads = dict(zip(leaves, torch.autograd.grad(loss, list(
        leaves.values()))))
    with torch.no_grad():
        momenta = {k: RESNET_MOMENTUM * m + grads[k].to(m.dtype)
                   for k, m in momenta.items()}
        params = {k: v - RESNET_LR * momenta[k] for k, v in params.items()}
        new_aux = {k: v.detach().to(aux[k].dtype) for k, v in new_aux.items()}
    return loss.detach(), params, momenta, new_aux, grads


def _resnet_batch(dev, B):
    """B random NHWC images and labels, from seed 1."""
    import torch

    g = torch.Generator(device=dev).manual_seed(SEED + 1)
    x = torch.randn(B, RESNET_HW, RESNET_HW, 3, generator=g, device=dev)
    y = torch.randint(0, RESNET_CLASSES, (B,), generator=g, device=dev)
    return x, y


def phase_resnet_training(dev):
    """The flagship's training step (``bench.py`` ``main``: Gluon
    ``resnet50_v1``, channels-last, bf16 compute, SGD with momentum 0.9 at
    lr 0.1) at 224x224x3, random weights and images from seed 0.

    f32 check, cuDNN deterministic: one step at B = 32 with the BatchNorm
    kernels against the same step with every BatchNorm through
    ``bn_train_reference`` — loss within 1e-5 relative, the new running
    statistics rtol 1e-5 / atol 1e-6.  The gradients: this randomly
    initialised 53-BatchNorm net amplifies f32 rounding (moving the images
    by ~2^-22 relative moves its gradients by ~2% normwise), so they are
    held against that measured floor — the plain step on the moved images
    — all together within 3x the floor, each within max(1e-4, 10x its
    own); a conv bias feeding a BatchNorm has an analytically zero
    gradient, held below 1e-6 of the largest gradient's norm on both
    sides.  (BatchNorm's own gradient, kernel forward against plain, is
    held to 1e-5 in the kernels phase.)  Then the main path: ten chained
    bf16 steps at B = 128 on one batch, counted from 0 — losses finite,
    the first two updates each lowering the loss, the first loss within
    2e-2 of the f32 loss on that batch, and per step 53 launches of each
    BatchNorm kernel and none of any other kernel; images/s (median of
    steps 2-10, host wall ending in a sync) and peak memory; the same ten
    steps with the plain BatchNorm, for the loss trajectory."""
    import torch

    from mxnet_tpu_torch.ops import batch_norm as bn
    from mxnet_tpu_torch.ops import nn as ops_nn

    if torch.backends.cuda.matmul.allow_tf32 or \
            torch.backends.cudnn.allow_tf32:
        raise SystemExit("TF32 is on: the f32 comparison needs full f32")
    net, apply_fn, params, aux = _resnet(dev)
    zeros = {k: torch.zeros_like(v) for k, v in params.items()}

    def timed(fn):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        res = fn()
        torch.cuda.synchronize()
        return res, (time.perf_counter() - t0) * 1e3

    def step_with(bn_fn, x, y, dtype=None, p=params, m=zeros, a=aux):
        """One timed step with every BatchNorm through ``bn_fn``, counted
        from 0; (loss, params, momenta, aux, grads), its launches, ms and
        peak bytes."""
        ops_nn.bn_train_fused = bn_fn
        try:
            _reset_launches()
            torch.cuda.reset_peak_memory_stats()
            res, ms = timed(lambda: _resnet_step(apply_fn, p, m, a, x, y,
                                                 dtype))
            return res, _read_launches(), ms, \
                torch.cuda.max_memory_allocated()
        finally:
            ops_nn.bn_train_fused = bn.bn_train_fused

    # f32, cuDNN deterministic (the same conv algorithms throughout): the
    # step with the kernels, with the plain BatchNorm, and with the plain
    # BatchNorm on the images moved by ~one f32 rounding — the network's
    # own noise floor, against which the kernels' gradients are held
    x32, y32 = _resnet_batch(dev, RESNET_F32_BATCH)
    g1 = torch.Generator(device=dev).manual_seed(SEED + 3)
    x32p = x32 + x32 * 2.0 ** -22 * torch.empty_like(x32).uniform_(
        -1.0, 1.0, generator=g1)
    det = (torch.backends.cudnn.deterministic, torch.backends.cudnn.benchmark)
    torch.backends.cudnn.deterministic, torch.backends.cudnn.benchmark = \
        True, False
    try:
        step_with(bn.bn_train_fused, x32, y32)   # warm-up
        f32 = {name: step_with(fn, x, y32) for name, fn, x in (
            ("kernels", bn.bn_train_fused, x32),
            ("plain", bn.bn_train_reference, x32),
            ("floor", bn.bn_train_reference, x32p))}
    finally:
        torch.backends.cudnn.deterministic, torch.backends.cudnn.benchmark \
            = det
    (lk, _, _, ak, gk), launches_k, ms_k, peak_k = f32["kernels"]
    (lp, _, _, ap, gp), launches_p, ms_p, peak_p = f32["plain"]
    gf = f32["floor"][0][4]
    top = max(v.norm().item() for v in gp.values())
    zero_grads = sorted(k for k, v in gp.items() if v.norm() < 1e-6 * top)
    zero_ok = all(gk[k].norm() < 1e-6 * top for k in zero_grads) and all(
        k.endswith("bias") and "conv2d" in k for k in zero_grads)

    def rel(a, keys):
        return (torch.cat([(a[k] - gp[k]).flatten() for k in keys]).norm()
                / torch.cat([gp[k].flatten() for k in keys]).norm()).item()

    live = [k for k in gp if k not in zero_grads]
    grad_rel = {k: rel(gk, [k]) for k in live}
    floor_rel = {k: rel(gf, [k]) for k in live}
    glob, glob_floor = rel(gk, live), rel(gf, live)
    over = sorted(k for k in live if grad_rel[k] > max(
        1e-4, 10 * floor_rel[k]))
    worst = max(grad_rel, key=grad_rel.get)
    aux_err = max(((ak[k] - ap[k]).abs() - 1e-5 * ap[k].abs()).max().item()
                  for k in ap)
    loss_rel = abs(lk.item() - lp.item()) / abs(lp.item())
    f32 = {"B": RESNET_F32_BATCH,
           "kernels": {"loss": lk.item(), "step_ms": ms_k,
                       "peak_bytes": peak_k, "launches": launches_k},
           "plain": {"loss": lp.item(), "step_ms": ms_p,
                     "peak_bytes": peak_p, "launches": launches_p},
           "floor_loss": f32["floor"][0][0].item(),
           "loss_rel_err": loss_rel,
           "grad_rel_err_global": glob, "grad_rel_err_floor_global":
           glob_floor, "grad_rel_err_max": grad_rel[worst],
           "grad_rel_err_worst": worst,
           "grad_rel_err_floor_of_worst": floor_rel[worst],
           "grads_beyond_floor": over, "zero_grads": zero_grads,
           "zero_grads_ok": zero_ok,
           "running_stats_err_beyond_rtol": aux_err,
           "tolerance": {"loss_rel": 1e-5, "grad_global":
                         "3 x floor", "grad_each": "max(1e-4, 10 x floor)",
                         "running_stats": {"rtol": 1e-5, "atol": 1e-6}}}
    del gk, gp, gf, ak, ap, x32, y32, x32p

    # the f32 loss on the bf16 steps' batch (forward only)
    B = RESNET_BATCH
    x, y = _resnet_batch(dev, B)
    with torch.no_grad():
        out, _ = apply_fn(params, aux, x)
        loss128 = -torch.log_softmax(out.float(), -1).gather(
            1, y[:, None]).mean().item()
    del out
    # the main path: ten chained bf16 steps
    p, m, a, losses, step_ms = params, zeros, aux, [], []
    launches, peak = {}, 0
    for _ in range(10):
        (loss, p, m, a, _), n, ms, pk = step_with(
            bn.bn_train_fused, x, y, torch.bfloat16, p, m, a)
        losses.append(loss)
        step_ms.append(ms)
        launches = {k: launches.get(k, 0) + v for k, v in n.items()}
        peak = max(peak, pk)
    losses = [v.item() for v in losses]
    # the same ten steps with the plain BatchNorm, for the trajectory
    p, m, a, plain_losses = params, zeros, aux, []
    for _ in range(10):
        (loss, p, m, a, _), _, _, _ = step_with(
            bn.bn_train_reference, x, y, torch.bfloat16, p, m, a)
        plain_losses.append(loss.item())
    del p, m, a
    steady = float(np.median(step_ms[1:]))
    per_step = {k: 0 for k in launches}
    per_step.update(bn_stats=RESNET_BNS, bn_normalize=RESNET_BNS)
    res = {"phase": "resnet_training",
           "config": {"model": "resnet50_v1", "classes": RESNET_CLASSES,
                      "layout": "NHWC", "image": [RESNET_HW, RESNET_HW, 3],
                      "parameters": sum(v.numel() for v in params.values()),
                      "batch_norms": RESNET_BNS},
           "lr": RESNET_LR, "momentum": RESNET_MOMENTUM,
           "f32": f32,
           "bf16": {"B": B, "losses": losses, "step_ms": step_ms,
                    "steady_step_ms": steady,
                    "images_per_s": B / (steady / 1e3), "peak_bytes": peak,
                    "f32_loss_same_batch": loss128,
                    "first_loss_rel_to_f32":
                    abs(losses[0] - loss128) / abs(loss128),
                    "plain_batch_norm_losses": plain_losses},
           "launches": launches}
    emit(res)
    bad = []
    if loss_rel > 1e-5:
        bad.append(f"f32 loss with the kernels differs by {loss_rel:.3g}")
    if glob > 3 * glob_floor:
        bad.append(f"gradients differ by {glob:.3g} normwise, over 3 x the "
                   f"noise floor {glob_floor:.3g}")
    if over:
        bad.append(f"gradients beyond max(1e-4, 10 x their floor): {over}")
    if not zero_ok:
        bad.append(f"gradients expected zero are not: {zero_grads}")
    if aux_err > 1e-6:
        bad.append(f"running statistics differ by {aux_err:.3g} beyond "
                   f"rtol 1e-5")
    if launches_k != per_step:
        bad.append(f"f32 kernel step launches {launches_k}")
    if launches_p != {k: 0 for k in launches}:
        bad.append(f"f32 plain step launches {launches_p}")
    if launches != {k: 10 * v for k, v in per_step.items()}:
        bad.append(f"bf16 steps launched {launches}, not 10 x {per_step}")
    if not all(np.isfinite(losses + plain_losses)):
        bad.append(f"non-finite bf16 loss: {losses}, {plain_losses}")
    elif not losses[2] < losses[1] < losses[0]:
        bad.append(f"bf16 loss did not fall over the first two updates: "
                   f"{losses}")
    if res["bf16"]["first_loss_rel_to_f32"] > 2e-2:
        bad.append(f"bf16 first loss {losses[0]} vs f32 {loss128}")
    if bad:
        raise SystemExit("resnet_training phase failed: " + "; ".join(bad))
    return res


def _trainer(net, **kw):
    """The port's ``DataParallelTrainer`` over ``net`` with Gluon's
    ``SoftmaxCrossEntropyLoss`` and bench.py's SGD (lr 0.1, momentum
    0.9)."""
    from mxnet_tpu_torch.gluon import loss as gloss
    from mxnet_tpu_torch.parallel import DataParallelTrainer

    return DataParallelTrainer(net, gloss.SoftmaxCrossEntropyLoss(),
                               lr=RESNET_LR, momentum=RESNET_MOMENTUM, **kw)


def phase_resnet_compressed(dev):
    """2-bit gradient compression on the flagship: ``resnet50_v1``
    channels-last at 224x224 (random weights from a seed) trained through
    the port's mesh-less ``DataParallelTrainer`` with Gluon's
    ``SoftmaxCrossEntropyLoss``, bf16 compute, SGD lr 0.1 momentum 0.9.

    Checks first.  f32 at B = 32: the uncompressed trainer's first loss
    against ``_resnet_step``'s (the resnet_training phase's step) within
    1e-5 relative.  bf16 at B = 32, cuDNN deterministic: one compressed
    step at threshold 1e9 (every code 0) leaves every parameter
    unchanged and the residuals equal to the step's f32 gradients.  Then
    the main path: COMPRESSED_STEPS chained bf16 steps at B = 128 on one
    batch without compression and with ``{"type": "2bit", "threshold":
    0.5}``, twice each in turns (A B B A), each step counted from 0 —
    losses finite; per step 53 launches of each BatchNorm kernel, no
    BatchNorm input copy, and with compression one pack and one unpack
    launch per trainable parameter (none without); step ms (median and
    quartiles of steps 2 on of both runs), images/s and peak memory of
    each, and the compression alone between syncs (``compress_ms``)."""
    import torch

    if torch.backends.cuda.matmul.allow_tf32 or \
            torch.backends.cudnn.allow_tf32:
        raise SystemExit("TF32 is on: the f32 comparison needs full f32")
    net, apply_fn, params, aux = _resnet(dev)
    n_params = len(params)
    bad = []
    # f32: the trainer's loss against _resnet_step's
    x, y = _resnet_batch(dev, RESNET_F32_BATCH)
    zeros = {k: torch.zeros_like(v) for k, v in params.items()}
    want_loss = _resnet_step(apply_fn, params, zeros, aux, x, y)[0].item()
    got = _trainer(net).step(x, y).item()
    f32_rel = abs(got - want_loss) / abs(want_loss)
    del zeros
    # threshold 1e9: nothing reaches the update, everything the residual
    det = (torch.backends.cudnn.deterministic, torch.backends.cudnn.benchmark)
    torch.backends.cudnn.deterministic, torch.backends.cudnn.benchmark = \
        True, False
    try:
        tr = _trainer(net, compute_dtype=torch.bfloat16,
                      compression_params={"type": "2bit",
                                          "threshold": 1e9})
        # the gradients the step will take, from the same parameters
        _, grads, _ = tr._loss_and_grads(x, y)
        before = dict(tr.params)
        tr.step(x, y)
        torch.cuda.synchronize()
        unchanged = [k for k in before if torch.equal(before[k],
                                                      tr.params[k])]
        carried = [k for k in grads if torch.equal(tr.residuals[k][0],
                                                   grads[k].float())]
    finally:
        torch.backends.cudnn.deterministic, torch.backends.cudnn.benchmark \
            = det
    blocked = {"params_unchanged": len(unchanged),
               "residuals_equal_grads": len(carried), "of": n_params}
    del tr, grads, before, x, y
    # the main path, without and with compression, in turns (A B B A) so
    # that drift of the host clock falls on both alike
    B = RESNET_BATCH
    x, y = _resnet_batch(dev, B)
    comp2 = {"type": "2bit", "threshold": TWOBIT_THRESHOLD}
    runs, total = {}, {}
    for name, comp in (("uncompressed", None), ("2bit", comp2),
                       ("2bit", comp2), ("uncompressed", None)):
        tr = _trainer(net, compute_dtype=torch.bfloat16,
                      compression_params=comp)
        torch.cuda.reset_peak_memory_stats()
        losses, step_ms, per_step = [], [], []
        for _ in range(COMPRESSED_STEPS):
            torch.cuda.synchronize()
            _reset_launches()
            t0 = time.perf_counter()
            losses.append(tr.step(x, y))
            torch.cuda.synchronize()
            step_ms.append((time.perf_counter() - t0) * 1e3)
            per_step.append(_read_launches())
        peak = torch.cuda.max_memory_allocated()
        losses = [v.item() for v in losses]
        want = {k: 0 for k in per_step[0]}
        want.update(bn_stats=RESNET_BNS, bn_normalize=RESNET_BNS)
        if comp is not None:
            want.update(twobit_pack=n_params, twobit_unpack=n_params)
        run = runs.setdefault(name, {"losses": losses, "step_ms": [],
                                     "peak_bytes": 0,
                                     "launches_per_step": per_step[0],
                                     "expected_per_step": want})
        run["step_ms"].append(step_ms)
        run["peak_bytes"] = max(run["peak_bytes"], peak)
        if comp is not None and "compress_ms" not in run:
            # the compression alone, between syncs: the 386 launches and
            # their host work on an idle queue
            run["residual_max_abs"] = max(v.abs().max().item()
                                          for v in tr.residuals.values())
            _, grads, _ = tr._loss_and_grads(x, y)
            times = []
            for _ in range(5):
                torch.cuda.synchronize()
                t0 = time.perf_counter()
                tr._compress(grads)
                torch.cuda.synchronize()
                times.append((time.perf_counter() - t0) * 1e3)
            run["compress_ms"] = float(np.median(times))
            del grads
        for n in per_step:
            total = {k: total.get(k, 0) + v for k, v in n.items()}
        off = [n for n in per_step if n != want]
        if off:
            bad.append(f"{len(off)} {name} steps launched other counts than "
                       f"{want}, the first {off[0]}")
        if not all(np.isfinite(losses)):
            bad.append(f"non-finite {name} loss: {losses}")
        del tr
    for run in runs.values():
        steady = [t for ms in run["step_ms"] for t in ms[1:]]
        run["steady_step_ms"] = float(np.median(steady))
        run["steady_step_ms_quartiles"] = [float(q) for q in np.percentile(
            steady, [25, 75])]
        run["images_per_s"] = B / (run["steady_step_ms"] / 1e3)
    res = {"phase": "resnet_compressed",
           "config": {"model": "resnet50_v1", "classes": RESNET_CLASSES,
                      "layout": "NHWC", "image": [RESNET_HW, RESNET_HW, 3],
                      "B": B, "compute_dtype": "bfloat16",
                      "trainable_parameters": n_params,
                      "elements": sum(v.numel() for v in params.values()),
                      "threshold": TWOBIT_THRESHOLD},
           "lr": RESNET_LR, "momentum": RESNET_MOMENTUM,
           "f32_loss": {"trainer": got, "resnet_step": want_loss,
                        "rel_err": f32_rel, "tolerance": 1e-5},
           "threshold_1e9": blocked, **runs,
           "compression_overhead_ms":
           runs["2bit"]["steady_step_ms"]
           - runs["uncompressed"]["steady_step_ms"],
           "launches": total}
    emit(res)
    if f32_rel > 1e-5:
        bad.append(f"f32 trainer loss {got} vs _resnet_step {want_loss}")
    if len(unchanged) != n_params or len(carried) != n_params:
        bad.append(f"threshold 1e9 step: {blocked}")
    if bad:
        raise SystemExit("resnet_compressed phase failed: " + "; ".join(bad))
    return res


def _gluon_trainable(net):
    return [(n, p) for n, p in net.collect_params().items()
            if p.grad_req != "null"]


def _gluon_one_step(dev):
    """One ``gluon.Trainer`` step (sgd, lr 0.1, momentum 0.9, wd 0, the
    ``device`` kvstore) at f32 B = 32 from ``_resnet(dev)``'s weights,
    against ``_resnet_step`` on the same net's ``block_train_fn`` tensors
    (the same update: the Trainer's 1/B rescale of the summed loss's
    gradient is exact at a power of two), and the reference step on the
    images moved by ~2^-22 (the net's f32 noise floor)."""
    import torch

    import mxnet_tpu_torch as mx
    from mxnet_tpu_torch import autograd, gluon, nd

    net, apply_fn, params, aux = _resnet(dev)
    B = RESNET_F32_BATCH
    x, y = _resnet_batch(dev, B)
    g1 = torch.Generator(device=dev).manual_seed(SEED + 3)
    xp = x + x * 2.0 ** -22 * torch.empty_like(x).uniform_(
        -1.0, 1.0, generator=g1)
    zeros = {k: torch.zeros_like(v) for k, v in params.items()}
    # the reference first: params and aux share the net's storage, which
    # the Trainer's step writes
    lr_, p_ref, _, aux_ref, g_ref = _resnet_step(apply_fn, params, zeros,
                                                 aux, x, y)
    p_floor = _resnet_step(apply_fn, params, zeros, aux, xp, y)[1]
    old = {k: v.clone() for k, v in params.items()}
    trainer = gluon.Trainer(net.collect_params(), "sgd",
                            {"learning_rate": RESNET_LR,
                             "momentum": RESNET_MOMENTUM, "wd": 0.0},
                            kvstore="device")
    loss_fn = gluon.loss.SoftmaxCrossEntropyLoss()
    X, Y = nd.array(x, ctx=mx.gpu(0)), nd.array(y, ctx=mx.gpu(0))
    torch.cuda.synchronize()
    _reset_launches()
    with autograd.record():
        L = loss_fn(net(X), Y)
    L.backward()
    trainer.step(B)
    torch.cuda.synchronize()
    launches = _read_launches()
    loss = L.mean().asscalar().item()
    pd = net.collect_params()
    new = {k: pd[k].data()._data for k in p_ref}
    top = max(v.norm().item() for v in g_ref.values())
    zero = sorted(k for k, v in g_ref.items() if v.norm() < 1e-6 * top)

    def rel(a, keys):
        num = torch.cat([(a[k] - p_ref[k]).flatten() for k in keys]).norm()
        den = torch.cat([(p_ref[k] - old[k]).flatten() for k in keys]).norm()
        return (num / den).item()

    live = [k for k in p_ref if k not in zero]
    each = {k: rel(new, [k]) for k in live}
    floor = {k: rel(p_floor, [k]) for k in live}
    glob, glob_floor = rel(new, live), rel(p_floor, live)
    over = sorted(k for k in live if each[k] > max(1e-4, 10 * floor[k]))
    zero_ok = all(k.endswith("bias") and "conv2d" in k for k in zero) and \
        all((new[k] - old[k]).norm() <= 1e-6 * top * RESNET_LR for k in zero)
    aux_err = max(((pd[k].data()._data - v).abs() - 1e-5 * v.abs()).max()
                  .item() for k, v in aux_ref.items())
    bitwise = all(torch.equal(new[k], p_ref[k]) for k in p_ref)
    worst = max(each, key=each.get)
    res = {"B": B, "loss": loss, "resnet_step_loss": lr_.item(),
           "loss_rel_err": abs(loss - lr_.item()) / abs(lr_.item()),
           "weights_bitwise_equal": bitwise,
           "update_rel_err_global": glob,
           "update_rel_err_floor_global": glob_floor,
           "update_rel_err_max": each[worst], "update_rel_err_worst": worst,
           "update_rel_err_floor_of_worst": floor[worst],
           "updates_beyond_floor": over, "zero_grads": zero,
           "zero_grads_ok": zero_ok,
           "running_stats_err_beyond_rtol": aux_err, "launches": launches,
           "tolerance": {"loss_rel": 1e-6, "update_global": "3 x floor",
                         "update_each": "max(1e-4, 10 x floor)",
                         "running_stats": {"rtol": 1e-5, "atol": 1e-6}}}
    bad = []
    if res["loss_rel_err"] > 1e-6:
        bad.append(f"loss {loss} vs _resnet_step {lr_.item()}")
    if glob > 3 * glob_floor:
        bad.append(f"weights differ by {glob:.3g} of the update, over 3 x "
                   f"the floor {glob_floor:.3g}")
    if over:
        bad.append(f"weights beyond max(1e-4, 10 x their floor): {over}")
    if not zero_ok:
        bad.append(f"zero-gradient parameters moved: {zero}")
    if aux_err > 1e-6:
        bad.append(f"running statistics differ by {aux_err:.3g}")
    want = {k: 0 for k in launches}
    want.update(bn_stats=RESNET_BNS, bn_normalize=RESNET_BNS)
    if launches != want:
        bad.append(f"one step launched {launches}")
    return res, bad


def _sgd_foreach_step(forward, ws, ms, x, y):
    """The Gluon loop's step without the NDArray / autograd tape / kvstore
    / Trainer layer: ``forward(x)``, the gradient of the summed softmax
    cross-entropy (the per-sample loss's head gradients of ones) with
    respect to ``ws``, and the Trainer's SGD pass
    (``optimizer.SGD._update_list``: rescale 1/B, wd 1e-4, lr, momentum)
    as the same ``torch._foreach_*`` ops, in place on ``ws`` and ``ms``."""
    import torch

    out = forward(x)
    loss = -torch.log_softmax(out, dim=-1).gather(1, y[:, None]).sum()
    gs = list(torch.autograd.grad(loss, ws))
    with torch.no_grad():
        g = torch._foreach_mul(gs, 1.0 / x.shape[0])
        torch._foreach_add_(g, torch._foreach_mul(ws, [1e-4] * len(ws)))
        lg = torch._foreach_mul(g, [RESNET_LR] * len(ws))
        torch._foreach_mul_(ms, RESNET_MOMENTUM)
        torch._foreach_sub_(ms, lg)
        torch._foreach_add_(ws, ms)


def _timed_steps(step, batches):
    """``step(x, y)`` over ``batches`` (host wall ms each, ending in a
    sync), then the last batch once more under the profiler."""
    import torch

    ms = []
    for xb, yb in batches:
        xt, yt = xb._data, yb._data.long()
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        step(xt, yt)
        torch.cuda.synchronize()
        ms.append((time.perf_counter() - t0) * 1e3)
    steady = float(np.median(ms[1:]))
    return {"step_ms": ms, "steady_step_ms": steady,
            "images_per_s": xt.shape[0] / (steady / 1e3),
            "profiled_step": _profiled(lambda: step(xt, yt))}


def _gluon_loop(dev):
    """The main path: the user's loop, ten f32 steps at B = 128 from a
    ``DataLoader`` over 1,280 random images (numpy, from SEED), the
    Trainer made before the first forward resolves the shapes.  Steps 2
    and 3 take the first batch again, so that the first two updates are
    each held to lower its loss (as ``resnet_training`` holds them on its
    one batch); the rest take the loader's next batches.  Then the same
    ten batches through ``_sgd_foreach_step`` (the same loss and
    ``_foreach`` SGD pass without the NDArray/Trainer layer), once over
    ``block_train_fn`` and once over the block called with tensors: the
    Gluon step's time less the latter's is that layer's cost."""
    import torch

    import mxnet_tpu_torch as mx
    from mxnet_tpu_torch import autograd, gluon
    from mxnet_tpu_torch.parallel.data_parallel import block_train_fn

    ctx = mx.gpu(0)
    B = RESNET_BATCH
    rs = np.random.default_rng(SEED)
    X = rs.standard_normal((GLUON_SAMPLES, RESNET_HW, RESNET_HW, 3),
                           dtype=np.float32)
    Y = rs.integers(0, RESNET_CLASSES, GLUON_SAMPLES).astype(np.int32)
    torch.manual_seed(SEED)    # the initializer draws from torch's own
    net = gluon.model_zoo.vision.resnet50_v1(classes=RESNET_CLASSES,
                                             layout="NHWC")
    net.initialize(mx.init.Xavier(), ctx=ctx)
    np.random.seed(SEED)       # the shuffle draws from numpy's own
    loader = gluon.data.DataLoader(gluon.data.ArrayDataset(X, Y),
                                   batch_size=B, shuffle=True,
                                   last_batch="discard")
    loss_fn = gluon.loss.SoftmaxCrossEntropyLoss()
    trainer = gluon.Trainer(net.collect_params(), "sgd",
                            {"learning_rate": RESNET_LR,
                             "momentum": RESNET_MOMENTUM, "wd": 1e-4})
    torch.cuda.reset_peak_memory_stats()
    losses, step_ms, data_ms, per_step, batches = [], [], [], [], []
    write_check = None
    it = iter(loader)
    for step in range(GLUON_STEPS):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        if step in (1, 2):
            x, y = batches[0]   # the first batch again (see the doc)
        else:
            x, y = next(it)
            x, y = x.as_in_context(ctx), y.as_in_context(ctx)
        torch.cuda.synchronize()
        t1 = time.perf_counter()
        _reset_launches()
        with autograd.record():
            L = loss_fn(net(x), y)
        if step == GLUON_STEPS - 1:
            # grad_req="write": a second backward over the same graph
            # leaves the one gradient, not their sum
            L.backward(retain_graph=True)
            once = {n: p.grad()._data.clone()
                    for n, p in _gluon_trainable(net)}
        L.backward()
        if step == GLUON_STEPS - 1:
            write_check = {n: (p.grad()._data - once[n]).abs().max().item()
                           / max(once[n].abs().max().item(), 1e-30)
                           for n, p in _gluon_trainable(net)}
            del once
        trainer.step(x.shape[0])
        torch.cuda.synchronize()
        t2 = time.perf_counter()
        per_step.append(_read_launches())
        data_ms.append((t1 - t0) * 1e3)
        step_ms.append((t2 - t1) * 1e3)
        losses.append(L.mean().asscalar().item())
        batches.append((x, y))
    peak = torch.cuda.max_memory_allocated()
    steady = float(np.median(step_ms[1:]))
    loop_ms = float(np.median([a + b for a, b in zip(step_ms[1:],
                                                     data_ms[1:])]))
    launches = {k: sum(n[k] for n in per_step) for k in per_step[0]}
    # one more step under the profiler: every kernel the step launches
    x, y = batches[-1]

    def gluon_step():
        with autograd.record():
            L2 = loss_fn(net(x), y)
        L2.backward()
        trainer.step(x.shape[0])

    prof = _profiled(gluon_step)
    # the same ten batches, and the same _foreach SGD pass, without the
    # NDArray, autograd tape, kvstore or Trainer: through block_train_fn's
    # functional forward, and through the block itself called with tensors
    # (the one forward the Gluon step runs, so the difference is the
    # layer's alone)
    apply_fn, params, aux = block_train_fn(net, is_train=True)
    leaves = {k: v.clone().requires_grad_() for k, v in params.items()}
    box = [{k: v.clone() for k, v in aux.items()}]

    def functional(xt):
        out, new_aux = apply_fn(leaves, box[0], xt)
        box[0] = {k: v.detach() for k, v in new_aux.items()}
        return out

    ws = list(leaves.values())
    ms = [torch.zeros_like(w) for w in ws]
    functional_run = _timed_steps(
        lambda xt, yt: _sgd_foreach_step(functional, ws, ms, xt, yt), batches)
    del leaves, box, ws, ms

    def eager(xt):
        with autograd.train_mode():
            return net(xt)

    ws = [p._tensor() for _, p in _gluon_trainable(net)]
    ms = [torch.zeros_like(w) for w in ws]
    eager_run = _timed_steps(
        lambda xt, yt: _sgd_foreach_step(eager, ws, ms, xt, yt), batches)
    del ws, ms, batches
    n_params = len(_gluon_trainable(net))
    res = {"B": B, "steps": GLUON_STEPS, "samples": GLUON_SAMPLES,
           "trainable_parameters": n_params, "losses": losses,
           "step_ms": step_ms,
           "data_ms": data_ms, "steady_step_ms": steady,
           "images_per_s": B / (steady / 1e3),
           "loop_images_per_s": B / (loop_ms / 1e3), "peak_bytes": peak,
           "profiled_step": prof,
           "block_train_fn": functional_run, "eager_block": eager_run,
           "trainer_layer_ms": steady - eager_run["steady_step_ms"],
           "trainer_layer_device_ms": (
               prof["device_busy_s"]
               - eager_run["profiled_step"]["device_busy_s"]) * 1e3,
           "grad_write_rel_err": max(write_check.values()),
           "launches_per_step": per_step[0], "launches": launches}
    bad = []
    want = {k: 0 for k in per_step[0]}
    want.update(bn_stats=RESNET_BNS, bn_normalize=RESNET_BNS)
    off = [n for n in per_step if n != want]
    if off:
        bad.append(f"{len(off)} loop steps launched other counts than "
                   f"{want}, the first {off[0]}")
    if not all(np.isfinite(losses)):
        bad.append(f"non-finite loss: {losses}")
    if not losses[2] < losses[1] < losses[0]:
        bad.append(f"the first two updates did not each lower the first "
                   f"batch's loss: {losses[:3]}")
    if res["grad_write_rel_err"] > 1e-6:
        bad.append(f"two backwards left {res['grad_write_rel_err']:.3g} "
                   f"relative beyond one gradient (grad_req='write')")
    return net, res, bad


def _gluon_compressed(dev):
    """Three f32 Trainer steps at B = 32 with 2-bit compression through
    the ``device`` kvstore: one pack and one unpack a trainable parameter
    a step.  After step 1, the store's residuals and the gradients it
    pulled back are held, bit for bit, to the 2-bit round trip written out
    plainly here (from a zero residual: q = +-t where the gradient reaches
    +-t, else 0; residual = gradient - q), so that a wrong quantization
    fails as well as a wrong wiring.  (The kernels themselves are held to
    their plain versions in the kernels phase.)"""
    import torch

    import mxnet_tpu_torch as mx
    from mxnet_tpu_torch import autograd, gluon, nd

    net = _resnet(dev)[0]
    comp = {"type": "2bit", "threshold": TWOBIT_THRESHOLD}
    trainer = gluon.Trainer(net.collect_params(), "sgd",
                            {"learning_rate": RESNET_LR,
                             "momentum": RESNET_MOMENTUM, "wd": 1e-4},
                            compression_params=comp)
    loss_fn = gluon.loss.SoftmaxCrossEntropyLoss()
    x, y = _resnet_batch(dev, RESNET_F32_BATCH)
    X, Y = nd.array(x, ctx=mx.gpu(0)), nd.array(y, ctx=mx.gpu(0))
    trainable = _gluon_trainable(net)
    n = len(trainable)
    losses, per_step, raw = [], [], None
    for step in range(GLUON_COMPRESSED_STEPS):
        torch.cuda.synchronize()
        _reset_launches()
        with autograd.record():
            L = loss_fn(net(X), Y)
        L.backward()
        if step == 0:
            raw = [p.grad()._data.clone() for _, p in trainable]
        trainer.step(RESNET_F32_BATCH)
        torch.cuda.synchronize()
        per_step.append(_read_launches())
        losses.append(L.mean().asscalar().item())
        if step == 0:
            t = torch.tensor(TWOBIT_THRESHOLD, device=dev)
            store, idx = trainer._kvstore._residuals, trainer._param2idx
            res_equal = grad_equal = 0
            for (name, p), g in zip(trainable, raw):
                q = t * (g >= t) - t * (g <= -t)
                res_equal += torch.equal(store[(idx[name], 0)], g - q)
                grad_equal += torch.equal(p.grad()._data, q)
            del raw
    launches = {k: sum(s[k] for s in per_step) for k in per_step[0]}
    res = {"B": RESNET_F32_BATCH, "steps": GLUON_COMPRESSED_STEPS,
           "threshold": TWOBIT_THRESHOLD, "trainable_parameters": n,
           "losses": losses, "residuals_bitwise_equal": res_equal,
           "pulled_grads_bitwise_equal": grad_equal,
           "launches_per_step": per_step[0], "launches": launches}
    want = {k: 0 for k in per_step[0]}
    want.update(bn_stats=RESNET_BNS, bn_normalize=RESNET_BNS,
                twobit_pack=n, twobit_unpack=n)
    bad = []
    off = [s for s in per_step if s != want]
    if off:
        bad.append(f"{len(off)} compressed steps launched other counts than "
                   f"{want}, the first {off[0]}")
    if res_equal != n or grad_equal != n:
        bad.append(f"after step 1, {res_equal} residuals and {grad_equal} "
                   f"pulled gradients of {n} bitwise equal to the plain "
                   f"2-bit round trip")
    if not all(np.isfinite(losses)):
        bad.append(f"non-finite compressed loss: {losses}")
    return res, bad


def _gluon_files(dev, net):
    """``save_parameters`` on the card, ``load_parameters`` into a fresh
    net: eval-mode outputs bitwise equal; the file's bytes equal those a
    CPU net holding the same weights writes."""
    import os

    import torch

    import mxnet_tpu_torch as mx
    from mxnet_tpu_torch import gluon, nd

    out_dir = os.path.join(os.path.dirname(os.path.abspath(__file__)),
                           "build", "chip_smoke_files")
    os.makedirs(out_dir, exist_ok=True)
    f_gpu = os.path.join(out_dir, "resnet50_gpu.params")
    f_cpu = os.path.join(out_dir, "resnet50_cpu.params")
    net.save_parameters(f_gpu)
    fresh = gluon.model_zoo.vision.resnet50_v1(classes=RESNET_CLASSES,
                                               layout="NHWC")
    fresh.load_parameters(f_gpu, ctx=mx.gpu(0))
    x = nd.array(_resnet_batch(dev, 8)[0], ctx=mx.gpu(0))
    a, b = net(x), fresh(x)
    equal = torch.equal(a._data, b._data)
    on_cpu = gluon.model_zoo.vision.resnet50_v1(classes=RESNET_CLASSES,
                                                layout="NHWC")
    on_cpu.load_parameters(f_gpu, ctx=mx.cpu())
    on_cpu.save_parameters(f_cpu)
    with open(f_gpu, "rb") as f1, open(f_cpu, "rb") as f2:
        same = f1.read() == f2.read()
    res = {"bytes": os.path.getsize(f_gpu), "outputs_bitwise_equal": equal,
           "cpu_file_bytes_equal": same}
    for f in (f_gpu, f_cpu):
        os.remove(f)
    bad = []
    if not equal:
        bad.append("the reloaded net's eval output differs")
    if not same:
        bad.append("the parameter file written on the card differs from "
                   "the CPU net's")
    return res, bad


def _gluon_card_dataset(dev):
    """A dataset kept on the card, ``ArrayDataset(nd.array(X, ctx=gpu))``:
    its batches are stacked where the samples lie (``nd.stack``, as the
    reference's ``default_batchify_fn`` stacks), so they come out on the
    card, bit for bit the same rows uploaded whole; the labels (a 1-d
    array, which ``ArrayDataset`` reads through numpy, as the reference's
    does) come out equal to the numpy rows."""
    import torch

    import mxnet_tpu_torch as mx
    from mxnet_tpu_torch import gluon, nd

    ctx, n, B = mx.gpu(0), 64, 32
    rs = np.random.default_rng(SEED + 5)
    X = rs.standard_normal((n, RESNET_HW, RESNET_HW, 3), dtype=np.float32)
    Y = rs.integers(0, RESNET_CLASSES, n).astype(np.int32)
    ds = gluon.data.ArrayDataset(nd.array(X, ctx=ctx), nd.array(Y, ctx=ctx))
    batches = list(gluon.data.DataLoader(ds, batch_size=B))
    devices = sorted({str(x.context) for x, _ in batches})
    equal = sum(torch.equal(x._data, torch.from_numpy(X[i * B:(i + 1) * B])
                            .to(dev))
                for i, (x, _) in enumerate(batches))
    labels = sum(np.array_equal(y.asnumpy(), Y[i * B:(i + 1) * B])
                 for i, (_, y) in enumerate(batches))
    res = {"samples": n, "B": B, "batches": len(batches),
           "image_batch_devices": devices, "images_bitwise_equal": equal,
           "labels_equal": labels}
    bad = []
    if devices != [str(ctx)] or len(batches) != n // B:
        bad.append(f"a dataset on the card gave {len(batches)} image "
                   f"batches on {devices}")
    if equal != n // B or labels != n // B:
        bad.append(f"card dataset batches: {equal} image and {labels} "
                   f"label batches of {n // B} equal to the rows")
    return res, bad


def phase_gluon_training(dev):
    """The imperative Gluon training loop through the port's own
    modules — ``NDArray``, ``autograd.record``/``backward``,
    ``gluon.Trainer`` over the ``device`` kvstore, ``DataLoader`` and
    parameter files — on ``resnet50_v1(classes=1000, layout="NHWC")`` at
    224x224x3 in f32 (Gluon's default dtype), cuDNN deterministic, TF32
    off.  ``_gluon_one_step`` holds one Trainer step against
    ``_resnet_step``; ``_gluon_loop`` is the main path (ten steps at B =
    128: 53 + 53 BatchNorm launches a step and no other port kernel,
    losses finite, the first two updates each lowering the first batch's
    loss, ``grad_req="write"`` seen on the card; images/s and peak memory
    beside ``_sgd_foreach_step``'s over ``block_train_fn`` and over the
    block on the same batches, and one profiled step of each); ``_gluon_compressed`` the 2-bit path; ``_gluon_files``
    the parameter files; ``_gluon_card_dataset`` a dataset kept on the
    card."""
    import gc

    import torch

    if torch.backends.cuda.matmul.allow_tf32 or \
            torch.backends.cudnn.allow_tf32:
        raise SystemExit("TF32 is on: the f32 comparison needs full f32")
    gc.collect()   # earlier phases' nets hold marked variables until then
    det = (torch.backends.cudnn.deterministic, torch.backends.cudnn.benchmark)
    torch.backends.cudnn.deterministic, torch.backends.cudnn.benchmark = \
        True, False
    try:
        one, bad = _gluon_one_step(dev)
        gc.collect()
        net, loop, bad_loop = _gluon_loop(dev)
        comp, bad_comp = _gluon_compressed(dev)
        files, bad_files = _gluon_files(dev, net)
        card_ds, bad_ds = _gluon_card_dataset(dev)
    finally:
        torch.backends.cudnn.deterministic, torch.backends.cudnn.benchmark \
            = det
    launches = {k: loop["launches"][k] + comp["launches"][k]
                for k in loop["launches"]}
    res = {"phase": "gluon_training",
           "config": {"model": "resnet50_v1", "classes": RESNET_CLASSES,
                      "layout": "NHWC", "image": [RESNET_HW, RESNET_HW, 3],
                      "dtype": "float32", "optimizer": "sgd",
                      "lr": RESNET_LR, "momentum": RESNET_MOMENTUM,
                      "kvstore": "device"},
           "one_step": one, "loop": loop, "compressed": comp,
           "files": files, "card_dataset": card_ds, "launches": launches}
    emit(res)
    bad += bad_loop + bad_comp + bad_files + bad_ds
    if bad:
        raise SystemExit("gluon_training phase failed: " + "; ".join(bad))
    return res


def phase_profile_resnet(dev):
    """Optional (not in the default run): two chained bf16 ResNet-50
    training steps of the ``resnet_training`` phase's main path under
    ``torch.profiler``, after one unprofiled warm-up step."""
    import torch

    _, apply_fn, params, aux = _resnet(dev)
    x, y = _resnet_batch(dev, RESNET_BATCH)
    state = [params, {k: torch.zeros_like(v) for k, v in params.items()},
             aux]

    def steps(n):
        for _ in range(n):
            _, state[0], state[1], state[2], _ = _resnet_step(
                apply_fn, *state, x, y, torch.bfloat16)

    steps(1)
    torch.cuda.synchronize()
    emit({"phase": "profile_resnet", "steps": 2, "B": RESNET_BATCH,
          **_profiled(lambda: steps(2))})


def _kernel_table(kern, runs):
    """One row per CUDA kernel: its times and bound from the kernels phase
    at the main path's shape (2-bit pack and unpack: the largest of
    ResNet-50's gradients, 2,359,296 elements, with the sum over one
    step's 193 gradients beside it; LayerNorm and paged attention: the serving
    decode shape, f32, with paged attention's T=512 prefill chunk and its
    kernel functions beside it; flash attention: the training shape, bf16, causal —
    the bf16 recipe's; BatchNorm: ResNet-50's stage-1 expansion input,
    (128, 56, 56, 256) bf16), the largest error over all its cases, and its
    launches on each main path run (each counted from 0 just before its
    window).  The flash rows also carry, under ``float32``, the f32 route's
    numbers at the training shape (causal) and its launches in the
    training phase's f32 flash step."""
    flash, flash32 = (next(c for c in kern["flash_attention"]
                           if c["shape"] == "training" and c["dtype"] == d
                           and c["causal"])
                      for d in ("bfloat16", "float32"))
    bnorm = next(c for c in kern["batch_norm"]
                 if c["shape"] == [128, 56, 56, 256]
                 and c["dtype"] == "bfloat16")
    pick = {"layer_norm": lambda r: r["M"] == 8 and not r["gelu"]
            and r["dtype"] == "float32",
            "paged_attention": lambda r: r["case"] == "decode"
            and r["dtype"] == "float32",
            "paged_attention_int8": lambda r: r["case"] == "decode"
            and r["dtype"] == "float32"}
    meta = {"twobit_pack": ("mxnet_tpu_torch/ops/csrc/twobit.cu",
                            "mxnet_tpu/ops/pallas_kernels.py:41"),
            "twobit_unpack": ("mxnet_tpu_torch/ops/csrc/twobit.cu",
                              "mxnet_tpu/ops/pallas_kernels.py:59"),
            "bn_stats": ("mxnet_tpu_torch/ops/csrc/batch_norm.cu",
                         "mxnet_tpu/ops/pallas_kernels.py:190"),
            "bn_normalize": ("mxnet_tpu_torch/ops/csrc/batch_norm.cu",
                             "mxnet_tpu/ops/pallas_kernels.py:222"),
            "layer_norm": ("mxnet_tpu_torch/ops/csrc/layer_norm.cu",
                           "mxnet_tpu/ops/pallas_kernels.py:325"),
            "paged_attention": ("mxnet_tpu_torch/ops/csrc/paged_attention.cu",
                                "mxnet_tpu/ops/paged_attention.py:71"),
            "paged_attention_int8": (
                "mxnet_tpu_torch/ops/csrc/paged_attention.cu",
                "mxnet_tpu/ops/paged_attention.py:121"),
            "flash_attention_fwd": (
                "mxnet_tpu_torch/ops/csrc/flash_attention.cu",
                "mxnet_tpu/ops/flash_attention.py:88"),
            "flash_attention_dq": (
                "mxnet_tpu_torch/ops/csrc/flash_attention.cu",
                "mxnet_tpu/ops/flash_attention.py:207"),
            "flash_attention_dkv": (
                "mxnet_tpu_torch/ops/csrc/flash_attention.cu",
                "mxnet_tpu/ops/flash_attention.py:242")}
    rows = []
    for name, (src, rep) in meta.items():
        extra = {}
        if name.startswith("twobit"):
            r = next(c for c in kern["twobit"] if c["kernel"] == name[7:])
            err = r["max_abs_err"]
            extra = {k: r[k] for k in ("largest_shape", "step_ms",
                                       "step_plain_ms", "step_bound_ms")}
        elif name.startswith("bn_"):
            part = name[3:]
            r = {k: bnorm[k][part] for k in ("ms", "plain_ms", "library_ms",
                                             "bound_ms", "bound_by")}
            outs = ("mean", "var") if part == "stats" else ("out",)
            err = max(c["max_abs_err"][o] for c in kern["batch_norm"]
                      for o in outs)
        elif name.startswith("flash"):
            part = name.rsplit("_", 1)[1]
            outs = {"fwd": ("out", "lse"), "dq": ("dq",),
                    "dkv": ("dk", "dv")}[part]
            r = {"ms": flash["ms"][part], "plain_ms": flash["plain_ms"][part],
                 "bound_ms": flash["bound_ms"][part],
                 "bound_by": flash["bound_by"][part],
                 # one library call computes the forward; none computes
                 # dQ or dK/dV alone (SDPA's backward is in the kernels
                 # phase's sdpa_ms)
                 "library_ms": flash["sdpa_ms"]["fwd"] if part == "fwd"
                 else None}
            err = max(c["max_abs_err"][o] for c in kern["flash_attention"]
                      for o in outs)
            i = ("fwd", "dq", "dkv").index(part)
            extra = {"functions": {d: f[i] for d, f in FLASH_ROUTES.items()}}
            f32_step = runs.get("training", {}).get("f32", {}).get("flash")
            extra["float32"] = {
                **{k: flash32[k][part] for k in ("ms", "plain_ms",
                                                 "bound_ms", "bound_by")},
                "library_ms": flash32["sdpa_ms"]["fwd"] if part == "fwd"
                else None,
                "launches": f32_step["launches"][name] if f32_step
                else None}
        else:
            r = next(c for c in kern[name] if pick[name](c))
            err = max(c["max_abs_err"] for c in kern[name])
            if name.startswith("paged"):
                # the decode call's numbers above; the T=512 prefill
                # chunk's beside them
                pre = next(c for c in kern[name] if c["case"] == "prefill"
                           and c["dtype"] == "float32")
                extra = {"functions": PAGED_ROUTES,
                         **{"prefill_" + k: pre[k] for k in (
                             "ms", "plain_ms", "bound_ms", "bound_by")}}
        by_phase = {ph: res["launches"][name] for ph, res in runs.items()}
        rows.append({"name": name, "route": "cuda", "source": src,
                     "replaces": rep, "launches": sum(by_phase.values()),
                     "launches_by_phase": by_phase, "max_abs_err": err,
                     "ms": r["ms"], "plain_ms": r["plain_ms"],
                     "bound_ms": r["bound_ms"], "bound_by": r["bound_by"],
                     "library_ms": r["library_ms"], **extra})
    return rows


def main(argv) -> int:
    try:
        import torch
    except ImportError:
        print("chip_smoke: torch is not installed", file=sys.stderr)
        return 2
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device", file=sys.stderr)
        return 2
    try:
        import mxnet_tpu_torch  # noqa: F401
    except ImportError as exc:
        print(f"chip_smoke: run from the repository root ({exc})",
              file=sys.stderr)
        return 2
    phases = set(argv[1].split(",")) if len(argv) > 1 else {
        "kernels", "model", "training", "serving", "serving_default",
        "serving_int8", "resnet_training", "resnet_compressed",
        "gluon_training"}
    if "serving_int8" in phases:
        phases.add("serving")   # its float baseline
    t_start = time.perf_counter()
    dev, smi = phase_device()
    phase_build()
    kern = phase_kernels(dev) if "kernels" in phases else None
    runs = {}
    if phases & {"model", "training", "serving", "serving_default",
                 "serving_int8", "profile", "profile_training"}:
        cfg, params = _model(dev)
        if "model" in phases:
            phase_model(dev, cfg, params)
        if "training" in phases:
            runs["training"] = phase_training(dev, cfg, params)
        if "serving" in phases:
            runs["serving"] = phase_serving(dev, cfg, params)
        if "serving_default" in phases:
            runs["serving_default"] = phase_serving_default(dev, cfg,
                                                              params)
        if "serving_int8" in phases:
            runs["serving_int8"] = phase_serving(
                dev, cfg, params, kv_dtype="int8",
                baseline=runs["serving"])
        if "profile" in phases:
            phase_profile(dev, cfg, params)
        if "profile_training" in phases:
            phase_profile_training(dev, cfg, params)
        del params
    if "resnet_training" in phases:
        runs["resnet_training"] = phase_resnet_training(dev)
    if "resnet_compressed" in phases:
        runs["resnet_compressed"] = phase_resnet_compressed(dev)
    if "gluon_training" in phases:
        runs["gluon_training"] = phase_gluon_training(dev)
    if "profile_resnet" in phases:
        phase_profile_resnet(dev)
    if kern is not None and runs:
        emit({"kernels": _kernel_table(kern, runs)})
    emit({"phase": "total", "seconds": time.perf_counter() - t_start})
    print(smi, flush=True)
    emit({"ok": True, "device": {"platform": "gpu",
                                 "kind": torch.cuda.get_device_name(0),
                                 "count": torch.cuda.device_count()}})
    return 0


if __name__ == "__main__":
    sys.exit(main(sys.argv))
