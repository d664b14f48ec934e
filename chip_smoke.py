#!/usr/bin/env python3
"""Drive the PyTorch port (``mxnet_tpu_torch``) once on one NVIDIA GPU.

    python3 chip_smoke.py

Run from the repository root on a machine with a CUDA card, the CUDA
toolkit (``nvcc``) and PyTorch built for CUDA.  Phases, one JSON line each:

1. device   — the card (``nvidia-smi`` name and power limit); TF32 off.
2. build    — compile every ``mxnet_tpu_torch/ops/csrc/*.cu`` (one nvcc
              each, in parallel) and report seconds and ptxas usage.
3. kernels  — each CUDA kernel against its plain PyTorch version on the
              card at the serving path's shapes (paged attention over the
              float pool and over the int8 pool, q in float32 and
              bfloat16), with the error, the kernel's time, the plain
              version's, a library call's where one computes the same
              function, and the least time the card could take (bytes or
              operations over the H100's peak rates).
4. model    — the GPT-2-small-width LM (random weights from a seed): a
              prefill chunk plus T=1 decode steps through the paged KV
              cache and both kernels, against the full-sequence forward;
              the same through an int8 pool, the paged path (the int8
              kernel) against the dequantizing gather path.
5. serving  — ``GenerationService`` on ``cuda`` serves 12 requests (8
              greedy, 4 sampled) through reserve-ahead admission, chunked
              prefill and continuous-batching decode; greedy tokens are
              checked teacher-forced against the full-sequence forward
              and against the same request served alone; both kernels
              must have launched on this path.
6. serving_default — the same model under the reference's default
              ``GenerationConfig`` (incremental allocation with
              preemption, the prefix cache) on a 64-block pool: two waves
              of requests sharing 256-token system prompts; greedy tokens
              checked teacher-forced; preemption, prefix hits and
              copy-on-write copies must all have happened.
7. serving_int8 — the ``serving`` phase's requests with
              ``kv_dtype="int8"``: all complete, only the int8 kernel
              serves attention, and greedy tokens agree with the float
              pool's on >= 75% of positions.

An optional comma-separated argument (``kernels``, ``model``, ``serving``,
``serving_default``, ``serving_int8`` — which also runs ``serving``, its
float baseline — and ``profile``, which is not in the default run: the
serving window once more under ``torch.profiler``) runs only those phases
after device and build.  Then the kernel table line, the ``nvidia-smi``
line and, last, the result line ``{"ok": true, "device": {...}}``.  Any
failure raises: the script exits non-zero and prints no result line.  It
also exits non-zero without a CUDA device or without the rest of the
repository beside it.
"""
from __future__ import annotations

import json
import subprocess
import sys
import time

import numpy as np

# H100 SXM peak rates (NVIDIA data sheet, dense): device memory bandwidth,
# f32 outside the tensor cores, bf16 on the tensor cores
HBM_BYTES_PER_S = 3.35e12
PEAK_FLOPS = {"float32": 67e12, "bfloat16": 989e12}

# kernel vs plain version on the same card
TOL = {"float32": dict(rtol=1e-4, atol=1e-5),
       "bfloat16": dict(rtol=2e-2, atol=1e-3)}

GPT2_SMALL = dict(vocab=50257, d_model=768, n_heads=12, n_layers=12,
                  d_ff=3072, max_len=1024)
SEED = 0
# serving_default's pool: small enough that its two waves preempt
DEFAULT_POOL_BLOCKS = 52


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
def phase_build():
    from mxnet_tpu_torch.ops import _build

    t0 = time.perf_counter()
    info = _build.build_all()
    emit({"phase": "build", "seconds": time.perf_counter() - t0,
          "kernels": {n: {"seconds": v["seconds"],
                          "ptxas": [ln.strip() for ln in
                                    v["ptxas"].splitlines()
                                    if "registers" in ln]}
                      for n, v in info.items()}})


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


def _paged_case(dev, dtype, B, T, lengths, start, table_rows, nb=512,
                bs=32):
    """Inputs for one paged-attention call: row b's queries sit at
    positions start[b] .. start[b]+T-1, of which lengths[b] are valid."""
    import torch

    H, D = GPT2_SMALL["n_heads"], GPT2_SMALL["d_model"] // \
        GPT2_SMALL["n_heads"]
    g = torch.Generator(device=dev).manual_seed(SEED + B * 1000 + T)
    q = torch.randn(B, T, H, D, generator=g, device=dev).to(dtype)
    k_pool = torch.randn(nb, bs, H, D, generator=g, device=dev).to(dtype)
    v_pool = torch.randn(nb, bs, H, D, generator=g, device=dev).to(dtype)
    tables = torch.tensor(table_rows, dtype=torch.int32, device=dev)
    pos = (torch.tensor(start, device=dev)[:, None]
           + torch.arange(T, device=dev)[None, :]).to(torch.int32)
    lens = torch.tensor(lengths, device=dev)
    valid = torch.arange(T, device=dev)[None, :] < lens[:, None]
    max_pos = torch.where(valid, pos, -1).amax(dim=1).to(torch.int32)
    return q, k_pool, v_pool, tables, pos.contiguous(), max_pos, bs


def _paged_bytes_flops(q, k_pool, tables, pos, max_pos, bs):
    """Bytes the call must move (live K/V blocks once — with their two f32
    scales per head for an int8 pool — q, out, indices) and the f32
    operations its unmasked (query, key) pairs need."""
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
        nbytes += len(live) * (2 * bs * H * D * kv_item + scale_bytes)
        ctx = np.concatenate([np.arange(w * bs, (w + 1) * bs)
                              for w in live]) if live else np.zeros(0)
        for t in range(T):
            pairs += int((ctx <= ps[b, t]).sum())
    return nbytes, 4.0 * D * H * pairs


def _paged_cases():
    """The paged-attention call shapes of the serving path, W=32 blocks of
    32 (1024 positions): (kind, B, T, lengths, starts, table rows)."""
    W = 32
    rs = np.random.RandomState(SEED)
    perm = (rs.permutation(511) + 1).tolist()   # physical blocks 1..511
    # decode: 8 slots with ragged contexts, one inactive (max_pos = -1),
    # null entries past each row's blocks and one null entry mid-table
    ctx = [1000, 37, 300, 0, 511, 64, 129, 800]
    tables, starts, lengths = [], [], []
    for b, n in enumerate(ctx):
        row = [0] * W
        if n:
            nblk = -(-(n + 1) // 32)
            row[:nblk] = [perm.pop() for _ in range(nblk)]
        tables.append(row)
        starts.append(n)
        lengths.append(1 if n else 0)
    tables[7][10] = 0   # a null block inside a live range is skipped
    cases = [("decode", 8, 1, lengths, starts, tables)]
    # prefill: one 512-query chunk at offset 256 (a chunked prompt), 400
    # valid queries, so blocks past the last valid position are skipped
    row = [perm.pop() for _ in range(W)]
    cases.append(("prefill", 1, 512, [400], [256], [row]))
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


def _paged_attention_cases(dev, int8: bool = False):
    import torch

    from mxnet_tpu_torch.ops.paged_attention import (attention_scale,
                                                     paged_attention,
                                                     paged_attention_plain)

    W = 32
    out = []
    for kind, B, T, lens, st, tab in _paged_cases():
        for dtype in (torch.float32, torch.bfloat16):
            q, kp, vp, tables_t, pos, mp, bs = _paged_case(
                dev, dtype, B, T, lens, st, tab)
            ks = vs = None
            if int8:
                kp, vp, ks, vs = _int8_pools(dev, kp.shape[0], bs,
                                             q.shape[2], q.shape[3],
                                             SEED + B + T)
            scale = attention_scale(q.shape[-1])
            got = paged_attention(q, kp, vp, tables_t, pos, mp,
                                  k_scale=ks, v_scale=vs)
            want = paged_attention_plain(q, kp, vp, tables_t, pos, mp,
                                         scale, ks, vs)
            torch.cuda.synchronize()
            dname = str(dtype).split(".")[-1]
            ok, err, rel = _close(got, want, dname)
            ok = ok and bool(torch.isfinite(got).all())
            zero_rows = [b for b in range(B) if int(mp[b]) < 0]
            zeros_ok = all(bool((got[b] == 0).all()) for b in zero_rows)
            ms = time_ms(lambda t: paged_attention(
                t, kp, vp, tables_t, pos, mp, k_scale=ks, v_scale=vs), q)
            plain = time_ms(lambda t: paged_attention_plain(
                t, kp, vp, tables_t, pos, mp, scale, ks, vs), q)
            nbytes, flops = _paged_bytes_flops(q, kp, tables_t, pos, mp, bs)
            bms, by = bound_ms(nbytes, flops, dname)
            out.append({"kind": kind, "B": B, "T": T, "W": W, "bs": bs,
                        "dtype": dname, "kv": "int8" if int8 else dname,
                        "ok": ok and zeros_ok,
                        "inactive_rows_zero": zeros_ok,
                        "max_abs_err": err, "max_rel_err": rel, "ms": ms,
                        "plain_ms": plain, "library_ms": None,
                        "bound_ms": bms, "bound_by": by})
    return out


def phase_kernels(dev):
    rows = {"layer_norm": _layer_norm_cases(dev),
            "paged_attention": _paged_attention_cases(dev),
            "paged_attention_int8": _paged_attention_cases(dev, int8=True)}
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
    beside them)."""
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

    def attend(quantized):
        for i in range(cfg.n_layers):
            if quantized:
                paged_attention(q, kq[i], vq[i], t_tab, pos, max_pos, scale,
                                ksq[i], vsq[i])
            else:
                paged_attention(q, k_pool[i], v_pool[i], t_tab, pos,
                                max_pos, scale)

    return {"decode_b8_w16": decode, "sample_b8": sample,
            "prefill_t512": prefill, "decode_int8_b8_w16": decode_q,
            "int8_scatters_b8": median_ms(scatters),
            "int8_attention_b8": median_ms(lambda: attend(True)),
            "float_attention_b8": median_ms(lambda: attend(False))}


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
    from mxnet_tpu_torch.ops.layer_norm import layer_norm_fused
    from mxnet_tpu_torch.ops.paged_attention import paged_attention

    layer_norm_fused.launches = 0
    paged_attention.launches = 0
    paged_attention.launches_int8 = 0


def _read_launches():
    from mxnet_tpu_torch.ops.layer_norm import layer_norm_fused
    from mxnet_tpu_torch.ops.paged_attention import paged_attention

    return {"layer_norm": layer_norm_fused.launches,
            "paged_attention": paged_attention.launches,
            "paged_attention_int8": paged_attention.launches_int8}


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
    prefix cache (f32 pool, a 64-block pool so that preemption fires),
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


def phase_profile(dev, cfg, params):
    """Optional (not in the default run): the serving window once more
    under ``torch.profiler`` — device time by kernel name and the share of
    the window with no kernel running.  The profiler slows the host, so
    this window's wall time is not the serving phase's."""
    import torch
    from torch.profiler import ProfilerActivity, profile

    svc, prompts = _service(dev, cfg, params)
    try:
        svc.warmup()
        with profile(activities=[ProfilerActivity.CPU,
                                 ProfilerActivity.CUDA]) as prof:
            t0 = time.perf_counter()
            _serve(svc, prompts)
            torch.cuda.synchronize()
            wall = time.perf_counter() - t0
    finally:
        svc.stop()
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
    emit({"phase": "profile", "wall_s": wall, "kernels": len(kernels),
          "device_busy_s": busy_us / 1e6,
          "idle_share": 1.0 - busy_us / 1e6 / wall,
          "top": [{"name": n[:80], "count": c, "ms": us / 1e3}
                  for n, (c, us) in top]})


def _kernel_table(kern, served):
    """One row per CUDA kernel: its decode-shape (f32) times and bound
    from the kernels phase, the largest error over all its cases, and its
    launches on the serving paths run (each counted from 0 just before
    its window)."""
    pick = {"layer_norm": lambda r: r["M"] == 8 and not r["gelu"]
            and r["dtype"] == "float32",
            "paged_attention": lambda r: r["kind"] == "decode"
            and r["dtype"] == "float32",
            "paged_attention_int8": lambda r: r["kind"] == "decode"
            and r["dtype"] == "float32"}
    meta = {"layer_norm": ("mxnet_tpu_torch/ops/csrc/layer_norm.cu",
                           "mxnet_tpu/ops/pallas_kernels.py:325"),
            "paged_attention": ("mxnet_tpu_torch/ops/csrc/paged_attention.cu",
                                "mxnet_tpu/ops/paged_attention.py:71"),
            "paged_attention_int8": (
                "mxnet_tpu_torch/ops/csrc/paged_attention.cu",
                "mxnet_tpu/ops/paged_attention.py:121")}
    rows = []
    for name, (src, rep) in meta.items():
        r = next(c for c in kern[name] if pick[name](c))
        by_phase = {ph: res["launches"][name] for ph, res in served.items()}
        rows.append({"name": name, "route": "cuda", "source": src,
                     "replaces": rep, "launches": sum(by_phase.values()),
                     "launches_by_phase": by_phase,
                     "max_abs_err": max(c["max_abs_err"]
                                        for c in kern[name]),
                     "ms": r["ms"], "plain_ms": r["plain_ms"],
                     "bound_ms": r["bound_ms"], "bound_by": r["bound_by"],
                     "library_ms": r["library_ms"]})
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
        "kernels", "model", "serving", "serving_default", "serving_int8"}
    if "serving_int8" in phases:
        phases.add("serving")   # its float baseline
    t_start = time.perf_counter()
    dev, smi = phase_device()
    phase_build()
    kern = phase_kernels(dev) if "kernels" in phases else None
    served = {}
    if phases & {"model", "serving", "serving_default", "serving_int8",
                 "profile"}:
        cfg, params = _model(dev)
        if "model" in phases:
            phase_model(dev, cfg, params)
        if "serving" in phases:
            served["serving"] = phase_serving(dev, cfg, params)
        if "serving_default" in phases:
            served["serving_default"] = phase_serving_default(dev, cfg,
                                                              params)
        if "serving_int8" in phases:
            served["serving_int8"] = phase_serving(
                dev, cfg, params, kv_dtype="int8",
                baseline=served["serving"])
        if "profile" in phases:
            phase_profile(dev, cfg, params)
    if kern is not None and served:
        emit({"kernels": _kernel_table(kern, served)})
    emit({"phase": "total", "seconds": time.perf_counter() - t_start})
    print(smi, flush=True)
    emit({"ok": True, "device": {"platform": "gpu",
                                 "kind": torch.cuda.get_device_name(0),
                                 "count": torch.cuda.device_count()}})
    return 0


if __name__ == "__main__":
    sys.exit(main(sys.argv))
