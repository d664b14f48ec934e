#!/usr/bin/env python3
"""Time variants of the bf16 tensor-core flash kernels on one NVIDIA GPU.

    python3 chip_flash_sweep.py

Run from the repository root on a machine with a CUDA card, the CUDA
toolkit and PyTorch built for CUDA.  Each variant is an edited copy of
``mxnet_tpu_torch/ops/csrc/flash_attention.cu`` built with the port's nvcc
flags into ``build/flash_sweep/`` (one nvcc each, in parallel), bound in
place of the port's library, checked against the plain versions (the LM's
training shape, a ragged T and D = 128, causal and not, at chip_smoke.py's
bf16 tolerance) and timed at the training shape (B=8, T=1024, H=12, D=64,
causal; CUDA graph of chained calls), dQ also at D = 128 (B=8, T=1024,
H=6), in turns with the unedited source first and last.  Variants:

- ``base``: the source as it is;
- ``no_split``: p and ds rounded once to bf16 (one product, not hi + lo)
  in all four split products (P V, P^T g, dS^T q, dS K); expected to fail
  the tolerance, it prices the split;
- ``dq_cuda_cores``: bf16 dQ routed to the CUDA-core ``flash_dq_kernel``
  (the design the tensor-core dQ replaced), for its time in the same run;
- ``dq_qg_regs``: dQ holding its q and g A-fragments in registers
  (loaded once by ldmatrix) instead of reading them from shared memory at
  every product;
- ``fwd_4_blocks``: the forward capped at 128 registers (4 blocks an SM);
- ``dkv_q32``: dK/dV with 32-query tiles at D = 64;
- ``dkv_kv_smem``: dK/dV reading k and v from shared memory at every
  product instead of holding them in registers;
- ``dkv_q32_kv_smem``: both.

One JSON line a variant (registers and spills of the bf16 kernels at
D = 64 and of dQ at D = 128, ``ok``, ms of the forward, dQ and dK/dV, and
of dQ at D = 128), then the ``nvidia-smi`` line.
"""
from __future__ import annotations

import ctypes
import json
import os
import re
import subprocess
import sys

SRC = "mxnet_tpu_torch/ops/csrc/flash_attention.cu"
OUT_DIR = os.path.join("build", "flash_sweep")
_BOUNDS = "__global__ void __launch_bounds__(kTcThreads)\n"
# bf16 kernel functions whose registers each variant reports: every
# tensor-core kernel at D = 64, dQ at D = 128, and the CUDA-core dQ in bf16
_REPORTED = re.compile(r"flash_(\w+?_tc_kernel)ILi(64)E|flash_(dq_tc_kernel)"
                       r"ILi(128)E|flash_(dq_kernel)I13__nv_bfloat16Li(64)E")


def _edit(text, old, new):
    if text.count(old) != 1:
        raise SystemExit(f"variant anchor not found once: {old!r}")
    return text.replace(old, new)


def _variants(src):
    q32 = lambda s: _edit(s, "kRows = D <= 64 ? 64 : 32",  # noqa: E731
                          "kRows = 32")
    smem = lambda s: _edit(s, "kKvInRegs = D <= 64",  # noqa: E731
                           "kKvInRegs = false")
    return {
        "base": src,
        "no_split": _edit(src, "  mma_bf16(d, lo, b0, b1);\n", ""),
        "fwd_4_blocks": _edit(
            src, _BOUNDS + "flash_fwd_tc_kernel",
            "__global__ void __launch_bounds__(kTcThreads, 4)\n"
            "flash_fwd_tc_kernel"),
        "dkv_q32": q32(src),
        "dkv_kv_smem": smem(src),
        "dkv_q32_kv_smem": q32(smem(src)),
        "dq_cuda_cores": _edit(
            src, "std::is_same_v<T, bf16>) {\n    return dq_tc<D>",
            "false) {\n    return dq_tc<D>"),
        "dq_qg_regs": _edit(
            _edit(src, "  const bf16* Gw = Gs + warp * 16 * LDS + at.a;\n",
                  "  const bf16* Gw = Gs + warp * 16 * LDS + at.a;\n"
                  "  unsigned qf[KD][4], gf[KD][4];\n"),
            "      unsigned aq[4], ag[4];\n"
            "      ldsm_x4(aq, Qw + kk * 16);\n"
            "      ldsm_x4(ag, Gw + kk * 16);\n",
            "      if (kt == 0) {\n"
            "        ldsm_x4(qf[kk], Qw + kk * 16);\n"
            "        ldsm_x4(gf[kk], Gw + kk * 16);\n"
            "      }\n"
            "      const unsigned(&aq)[4] = qf[kk];\n"
            "      const unsigned(&ag)[4] = gf[kk];\n"),
    }


def main() -> int:
    import torch
    if not torch.cuda.is_available():
        print("chip_flash_sweep: no CUDA device", file=sys.stderr)
        return 2
    if not os.path.exists(SRC):
        print("chip_flash_sweep: run from the repository root",
              file=sys.stderr)
        return 2
    import chip_smoke as cs
    from mxnet_tpu_torch.ops import _build
    from mxnet_tpu_torch.ops import flash_attention as fa

    dev, smi = cs.phase_device()
    with open(SRC) as f:
        variants = _variants(f.read())
    os.makedirs(OUT_DIR, exist_ok=True)
    procs = {}
    for name, text in variants.items():
        cu = os.path.join(OUT_DIR, name + ".cu")
        with open(cu, "w") as f:
            f.write(text)
        procs[name] = subprocess.Popen(
            [_build._nvcc(), *_build.NVCC_FLAGS, "-o",
             os.path.join(OUT_DIR, name + ".so"), cu],
            stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True)
    libs, regs = {}, {}
    for name, proc in procs.items():
        out, _ = proc.communicate()
        if proc.returncode != 0:
            raise SystemExit(f"{name}: nvcc failed\n{out[-3000:]}")
        regs[name] = {}
        for f, r in cs._ptxas_functions(out).items():
            m = _REPORTED.search(f)
            if m:
                fn, d = [x for x in m.groups() if x]
                regs[name][f"{fn}<{d}>"] = r
        libs[name] = ctypes.CDLL(os.path.join(OUT_DIR, name + ".so"))

    g = torch.Generator(device=dev).manual_seed(cs.SEED)
    B, T, H, D = cs.FLASH_SHAPES["training"]
    qkv = torch.randn(B, T, 3 * H * D, generator=g, device=dev).bfloat16()
    q, k, v = (t.reshape(B, T, H, D) for t in qkv.split(H * D, dim=-1))
    go = torch.randn(B, T, H, D, generator=g, device=dev).bfloat16()
    small = [[torch.randn(*cs.FLASH_SHAPES[s], generator=g,
                          device=dev).bfloat16() for _ in range(4)]
             for s in ("ragged", "d128")]

    def backward_args(q, k, v, go, causal):
        w_out, w_lse = fa.flash_attention_forward_reference(q, k, v, causal)
        return w_out, (q, k, v, go, w_lse, fa.flash_delta(w_out, go), causal)

    def agrees(q, k, v, go, causal):
        scale = 1.0 / q.shape[-1] ** 0.5
        out, _ = fa.flash_attention_forward(q, k, v, causal)
        w_out, args = backward_args(q, k, v, go, causal)
        got = (out, fa.flash_attention_dq(*args),
               *fa.flash_attention_dkv(*args))
        want = (w_out, fa.flash_attention_dq_reference(*args, scale),
                *fa.flash_attention_dkv_reference(*args, scale))
        return all(cs._close(a, b, "bfloat16")[0]
                   for a, b in zip(got, want))

    _, bwd = backward_args(q, k, v, go, True)
    # dQ at D = 128: the training shape's tokens and width, 6 heads
    d128 = [torch.randn(B, T, H // 2, 2 * D, generator=g,
                        device=dev).bfloat16() for _ in range(4)]
    _, bwd128 = backward_args(*d128, True)
    for name in [*variants, "base"]:
        _build._libs["flash_attention"] = libs[name]
        ok = agrees(q, k, v, go, True) and all(
            agrees(*x, c) for x in small for c in (True, False))
        row = {"variant": name, "ok": ok,
               "fwd_ms": cs.time_ms(lambda _: fa.flash_attention_forward(
                   q, k, v, True)[0], q),
               "dq_ms": cs.time_ms(
                   lambda _: fa.flash_attention_dq(*bwd), q),
               "dkv_ms": cs.time_ms(
                   lambda _: fa.flash_attention_dkv(*bwd)[0], q),
               "dq_d128_ms": cs.time_ms(
                   lambda _: fa.flash_attention_dq(*bwd128), q),
               "kernels": regs[name]}
        print(json.dumps(row), flush=True)
    print(smi, flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
