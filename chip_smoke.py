#!/usr/bin/env python3
"""Drive the PyTorch port (``mxnet_tpu_torch``) once on one NVIDIA GPU.

    python3 chip_smoke.py

Run from the repository root on a machine with a CUDA card, the CUDA
toolkit (``nvcc``) and PyTorch built for CUDA.  Phases, one JSON line each:

1. device   — the card (``nvidia-smi`` name and power limit); TF32 off.
2. build    — compile every ``mxnet_tpu_torch/ops/csrc/*.cu`` (one nvcc
              each, in parallel) and report seconds and ptxas usage.
3. kernels  — each CUDA kernel against its plain PyTorch version on the
              card at the serving path's shapes, with the error, the
              kernel's time, the plain version's, a library call's where
              one computes the same function, and the least time the card
              could take (bytes or operations over the H100's peak rates).
4. model    — the GPT-2-small-width LM (random weights from a seed): a
              prefill chunk plus T=1 decode steps through the paged KV
              cache and both kernels, against the full-sequence forward.
5. serving  — ``GenerationService`` on ``cuda`` serves 12 requests (8
              greedy, 4 sampled) through admission, chunked prefill and
              continuous-batching decode; greedy tokens are checked
              teacher-forced against the full-sequence forward and
              against the same request served alone; both kernels must
              have launched on this path.

An optional comma-separated argument (``kernels``, ``model``, ``serving``,
and ``profile``, which is not in the default run: the serving window once
more under ``torch.profiler``) runs only those phases after device and
build.  Then the kernel table line, the ``nvidia-smi`` line and, last,
the result line ``{"ok": true, "device": {...}}``.  Any failure raises:
the script exits non-zero and prints no result line.  It also exits non-zero without
a CUDA device or without the rest of the repository beside it.
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
    """Bytes the call must move (live K/V blocks once, q, out, indices) and
    the f32 operations its unmasked (query, key) pairs need."""
    B, T, H, D = q.shape
    item = q.element_size()
    tab = tables.cpu().numpy()
    mp = max_pos.cpu().numpy()
    ps = pos.cpu().numpy()
    W = tab.shape[1]
    nbytes = 2 * q.numel() * item + tables.numel() * 4 + pos.numel() * 4
    pairs = 0
    for b in range(B):
        live = [w for w in range(W) if tab[b, w] != 0 and w * bs <= mp[b]]
        nbytes += 2 * len(live) * bs * H * D * item
        ctx = np.concatenate([np.arange(w * bs, (w + 1) * bs)
                              for w in live]) if live else np.zeros(0)
        for t in range(T):
            pairs += int((ctx <= ps[b, t]).sum())
    return nbytes, 4.0 * D * H * pairs


def _paged_attention_cases(dev):
    import torch

    from mxnet_tpu_torch.ops.paged_attention import (attention_scale,
                                                     paged_attention,
                                                     paged_attention_plain)

    W = 32  # 1024 positions at block_size 32
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
    out = []
    for kind, B, T, lens, st, tab in cases:
        for dtype in (torch.float32, torch.bfloat16):
            q, kp, vp, tables_t, pos, mp, bs = _paged_case(
                dev, dtype, B, T, lens, st, tab)
            got = paged_attention(q, kp, vp, tables_t, pos, mp)
            want = paged_attention_plain(q, kp, vp, tables_t, pos, mp,
                                         attention_scale(q.shape[-1]))
            torch.cuda.synchronize()
            dname = str(dtype).split(".")[-1]
            ok, err, rel = _close(got, want, dname)
            zero_rows = [b for b in range(B) if int(mp[b]) < 0]
            zeros_ok = all(bool((got[b] == 0).all()) for b in zero_rows)
            ms = time_ms(lambda t: paged_attention(t, kp, vp, tables_t, pos,
                                                   mp), q)
            plain = time_ms(lambda t: paged_attention_plain(
                t, kp, vp, tables_t, pos, mp, attention_scale(t.shape[-1])),
                q)
            nbytes, flops = _paged_bytes_flops(q, kp, tables_t, pos, mp, bs)
            bms, by = bound_ms(nbytes, flops, dname)
            out.append({"kind": kind, "B": B, "T": T, "W": W, "bs": bs,
                        "dtype": dname, "ok": ok and zeros_ok,
                        "inactive_rows_zero": zeros_ok,
                        "max_abs_err": err, "max_rel_err": rel, "ms": ms,
                        "plain_ms": plain, "library_ms": None,
                        "bound_ms": bms, "bound_by": by})
    return out


def phase_kernels(dev):
    ln = _layer_norm_cases(dev)
    pa = _paged_attention_cases(dev)
    emit({"phase": "kernels", "tolerance": TOL, "layer_norm": ln,
          "paged_attention": pa})
    bad = [r for r in ln + pa if not r["ok"]]
    if bad:
        raise SystemExit(f"kernel disagrees with its plain version: {bad}")
    return ln, pa


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
    emit({"phase": "model", "config": GPT2_SMALL, "prompt": n_prompt,
          "prefill_bucket": T, "decode_steps": n_dec, "ok": ok,
          "max_abs_err": diff.max().item(), "tolerance":
          {"rtol": 1e-3, "atol": 1e-4}, "launches": launches,
          "step_ms": _step_times(dev, cfg, params)})
    if not ok:
        raise SystemExit("paged model step disagrees with the full forward")


def _step_times(dev, cfg, params):
    """Host wall time (ending in a device sync) of the serving step's
    parts, eager as the engine runs them: a decode model step at
    max_slots=8 (contexts of 300 positions, table width 16), the sampler
    over its (8, vocab) logits, and a T=512 prefill chunk."""
    import torch

    from mxnet_tpu_torch.ops.sampling import sample_logits
    from mxnet_tpu_torch.parallel.transformer import transformer_lm_decode

    B, bs, W, ctx = 8, 32, 16, 300
    shape = (cfg.n_layers, 1 + B * W, bs, cfg.n_heads, cfg.d_head)
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
    return {"decode_b8_w16": decode, "sample_b8": sample,
            "prefill_t512": prefill}


# -- phase 5 ------------------------------------------------------------------------
def _service(dev, cfg, params):
    """The serving configuration and its 12 requests: prompt lengths
    16..512 from a numpy seed (the largest rung, 512, is the longest
    prompt submit() accepts; prompts past the smallest rung, 64, prefill
    in chunks), 8 greedy and 4 sampled."""
    from mxnet_tpu_torch.serving.generation import (GenerationConfig,
                                                    GenerationService)

    gcfg = GenerationConfig(max_slots=8, block_size=32, num_blocks=2048,
                            seq_buckets=[64, 128, 256, 512],
                            max_new_tokens=32, preemption=False,
                            prefix_cache=False)
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


def phase_serving(dev, cfg, params):
    import torch

    from mxnet_tpu_torch.ops.layer_norm import layer_norm_fused
    from mxnet_tpu_torch.ops.paged_attention import paged_attention
    from mxnet_tpu_torch.parallel.transformer import transformer_lm_apply

    svc, prompts = _service(dev, cfg, params)
    lens = [len(p) for p in prompts]
    try:
        t0 = time.perf_counter()
        warmed = svc.warmup()
        warm_s = time.perf_counter() - t0
        steps0 = svc.stats()["step_seconds"]
        layer_norm_fused.launches = 0
        paged_attention.launches = 0
        t0 = time.perf_counter()
        streams, outs = _serve(svc, prompts)
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
        launches = {"layer_norm": layer_norm_fused.launches,
                    "paged_attention": paged_attention.launches}
        stats = svc.stats()
        # batch-composition independence: each greedy request once more,
        # alone in the engine (decode still runs at all 8 slots' shape)
        alone = [svc.submit(p).result(timeout=600) for p in prompts[:8]]
    finally:
        svc.stop()
    # model-step time of the served window, by kind (warmup excluded)
    steps = {k: {"steps": v["steps"] - steps0[k]["steps"],
                 "seconds": v["seconds"] - steps0[k]["seconds"]}
             for k, v in stats["step_seconds"].items()}
    # greedy check, teacher-forced against the full-sequence forward; a
    # request served alone must emit the batched tokens up to the first
    # near-tie of the oracle (top-2 gap < 1e-3)
    mismatches, near_ties, alone_diverged = [], 0, []
    for i in range(8):
        seq = np.concatenate([prompts[i], outs[i]])
        logits = transformer_lm_apply(
            params, torch.as_tensor(seq[None, :-1], device=dev),
            torch.arange(len(seq) - 1, device=dev), cfg)[0]
        tail = logits[len(prompts[i]) - 1:]
        top2 = torch.topk(tail, 2, dim=-1).values
        gap = (top2[:, 0] - top2[:, 1]).cpu().numpy()
        pred = tail.argmax(dim=-1).cpu().numpy()
        for j, (a, b) in enumerate(zip(pred, outs[i])):
            if int(a) != int(b):
                if gap[j] < 1e-3:
                    near_ties += 1
                else:
                    mismatches.append((i, j, int(a), int(b), float(gap[j])))
        if alone[i] != outs[i]:
            j = next(j for j, (a, b) in enumerate(zip(alone[i], outs[i]))
                     if a != b)
            alone_diverged.append((i, j, float(gap[j])))
            if gap[j] >= 1e-3:
                mismatches.append((i, j, "alone", alone[i][j], outs[i][j]))
    n_tokens = sum(len(o) for o in outs)
    ttft = sorted(s.ttft_ms for s in streams)
    sampled_ok = all(len(o) == 32 and all(0 <= t < cfg.vocab for t in o)
                     for o in outs[8:])
    res = {"phase": "serving", "requests": 12, "succeeded": len(outs),
           "failed": 0, "prompt_lens": [int(n) for n in lens],
           "tokens": n_tokens, "wall_s": wall,
           "tokens_per_s": n_tokens / wall,
           "ttft_ms": {"p50": float(np.percentile(ttft, 50)),
                       "p99": float(np.percentile(ttft, 99))},
           "warmup_s": warm_s, "warmup_signatures": warmed,
           "iterations": stats["iterations"],
           "prefill_tokens": stats["counts"]["prefill_tokens"],
           "steps": steps,
           "greedy_mismatches": mismatches,
           "greedy_near_tie_mismatches": near_ties,
           "greedy_alone_identical": 8 - len(alone_diverged),
           "greedy_alone_diverged": alone_diverged,
           "sampled_in_support": sampled_ok, "launches": launches}
    emit(res)
    if mismatches or not sampled_ok:
        raise SystemExit("served tokens disagree with the oracle")
    if not all(launches.values()):
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
        "kernels", "model", "serving"}
    t_start = time.perf_counter()
    dev, smi = phase_device()
    phase_build()
    kern = phase_kernels(dev) if "kernels" in phases else None
    if phases & {"model", "serving", "profile"}:
        cfg, params = _model(dev)
        if "model" in phases:
            phase_model(dev, cfg, params)
        if "serving" in phases:
            serving = phase_serving(dev, cfg, params)
        if "profile" in phases:
            phase_profile(dev, cfg, params)
    if kern is not None and "serving" in phases:
        ln, pa = kern
        # the decode shapes carry most launches on the serving path
        pick = {"layer_norm": next(r for r in ln if r["M"] == 8
                                   and r["dtype"] == "float32"
                                   and not r["gelu"]),
                "paged_attention": next(r for r in pa
                                        if r["kind"] == "decode"
                                        and r["dtype"] == "float32")}
        meta = {
            "layer_norm": ("cuda", "mxnet_tpu_torch/ops/csrc/layer_norm.cu",
                           "mxnet_tpu/ops/pallas_kernels.py:325", ln),
            "paged_attention": (
                "cuda", "mxnet_tpu_torch/ops/csrc/paged_attention.cu",
                "mxnet_tpu/ops/paged_attention.py:71", pa),
        }
        rows = []
        for name, (route, src, rep, cases) in meta.items():
            r = pick[name]
            rows.append({"name": name, "route": route, "source": src,
                         "replaces": rep,
                         "launches": serving["launches"][name],
                         "max_abs_err": max(c["max_abs_err"]
                                            for c in cases),
                         "ms": r["ms"], "plain_ms": r["plain_ms"],
                         "bound_ms": r["bound_ms"],
                         "bound_by": r["bound_by"],
                         "library_ms": r["library_ms"]})
        emit({"kernels": rows})
    emit({"phase": "total", "seconds": time.perf_counter() - t_start})
    print(smi, flush=True)
    emit({"ok": True, "device": {"platform": "gpu",
                                 "kind": torch.cuda.get_device_name(0),
                                 "count": torch.cuda.device_count()}})
    return 0


if __name__ == "__main__":
    sys.exit(main(sys.argv))
