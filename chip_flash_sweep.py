#!/usr/bin/env python3
"""Time variants of the tensor-core flash kernels on one NVIDIA GPU.

    python3 chip_flash_sweep.py [BASELINE.cu]

Run from the repository root on a machine with a CUDA card, the CUDA
toolkit and PyTorch built for CUDA.  Each variant is an edited copy of
``mxnet_tpu_torch/ops/csrc/flash_attention.cu`` built with the port's nvcc
flags into ``build/flash_sweep/`` (one nvcc each, in parallel), bound in
place of the port's library, checked against the plain versions in bf16
and in f32 (the LM's training shape, a ragged T and D = 128, causal and
not, at chip_smoke.py's tolerance of each dtype) and timed at the
training shape (B=8, T=1024, H=12, D=64, causal; CUDA graph of chained
calls) and at D = 128 (B=8, T=1024, H=6), in turns with the unedited
source first and last: the bf16 forward, dQ and dK/dV and bf16 dQ at
D = 128; the f32 forward, dQ and dK/dV at both shapes.  Variants:

- ``base``: the source as it is;
- ``no_split``: bf16 p and ds rounded once to bf16 (one product, not hi +
  lo) in all four split products (P V, P^T g, dS^T q, dS K); expected to
  fail the bf16 tolerance, it prices that split;
- ``dq_qg_regs``: bf16 dQ holding its q and g A-fragments in registers
  (loaded once by ldmatrix) instead of reading them from shared memory at
  every product;
- ``fwd_4_blocks``: the bf16 forward capped at 128 registers (4 blocks an
  SM);
- ``dkv_q32``: bf16 dK/dV with 32-query tiles at D = 64;
- ``dkv_kv_smem``: bf16 dK/dV reading k and v from shared memory at every
  product instead of holding them in registers;
- ``dkv_q32_kv_smem``: both;
- ``f32_fwd_k32``: the f32 forward with 32-key tiles at D <= 64 (the
  source takes 64);
- ``f32_fwd_q_regs``: the f32 forward at D <= 64 splitting its scaled q
  once into registers (at the first key tile) instead of at every
  fragment read;
- ``f32_split_staged``: the f32 3xTF32 kernels (forward, dQ and dK/dV)
  splitting each tile once, after it lands in shared memory, into big
  parts (in place) and small parts (a mirror in the second half of twice
  the shared memory), instead of splitting at every fragment read;
- ``f32_single_tf32``: the f32 products taken as one TF32 product (big *
  big) instead of three; expected to fail the f32 tolerance, it prices
  the split;
- ``f32_rna_small``: small rounded to nearest as big is (``+ 0x1000``)
  instead of truncated by the tensor cores; a NaN then drops out of the
  sums (the carry turns the card's NaN into -0), so this form is wrong
  and only prices the rounding;
- ``f32_guard_both``: big and small each rounded to nearest with a test
  that keeps a NaN's or an infinity's pattern (CUTLASS's
  ``round_half_ulp_truncate``); prices that test against the source's
  truncated small;
- ``baseline``: with a BASELINE.cu argument, that source as it is (for
  example the parent commit's ``flash_attention.cu``, unpacked by ``git
  archive``: its f32 route then times that commit's f32 kernels in the
  same run).

A variant whose edit no longer finds its text in the source prints a
``skipped`` line and the others run.  One JSON line a variant
(registers and spills of each flash kernel function at D = 64 and 128,
``ok`` per dtype and ms of each timed call), then the ``nvidia-smi``
line.
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
# a flash kernel function in ptxas's report: its name and D
_FUNC = re.compile(r"flash_(\w+?)_kernelILi(\d+)E")

# f32_split_staged: tiles split once in shared memory
_STAGED_SPLIT = r'''
// the small halves sit in the second half of the dynamic shared memory
__device__ __forceinline__ unsigned mirror_floats() {
  unsigned bytes;
  asm("mov.u32 %0, %%dynamic_smem_size;\n" : "=r"(bytes));
  return bytes / 8;
}
__device__ __forceinline__ void lds_split(unsigned& big, unsigned& small,
                                          const float* p, float) {
  big = __float_as_uint(p[0]);
  small = __float_as_uint(p[mirror_floats()]);
}
// R rows of D floats (rows of D + kF32Pad) times mul, split in place
template <int R, int D>
__device__ __forceinline__ void split_tile(float* p, float mul) {
  for (int i = threadIdx.x; i < R * D; i += kTcThreads) {
    float* e = p + (i / D) * (D + kF32Pad) + i % D;
    unsigned b, sm;
    split_tf32(b, sm, *e * mul);
    e[0] = __uint_as_float(b);
    e[mirror_floats()] = __uint_as_float(sm);
  }
}
'''


class _Stale(Exception):
    """A variant's anchor text is not in the source exactly once."""

# the f32 kernels' split, and f32_guard_both's
_SMALL = "  small = __float_as_uint(x - __uint_as_float(big & 0xffffe000u));\n"
_SPLIT = "  big = __float_as_uint(x) + 0x1000u;\n" + _SMALL
_GUARDED_SPLIT = r'''  const unsigned b = __float_as_uint(x);
  big = (b & 0x7f800000u) == 0x7f800000u ? b : b + 0x1000u;
  const unsigned c = __float_as_uint(x - __uint_as_float(big & 0xffffe000u));
  small = (c & 0x7f800000u) == 0x7f800000u ? c : c + 0x1000u;
'''


def _edit(text, old, new):
    if text.count(old) != 1:
        raise _Stale(f"anchor not found once: {old!r}")
    return text.replace(old, new)


def _staged(src):
    s = _edit(src, '''__device__ __forceinline__ void lds_split(unsigned& big, unsigned& small,
                                          const float* p, float mul) {
  split_tf32(big, small, *p * mul);
}
''', _STAGED_SPLIT)
    for head in ("(kTile + 4 * FwdTf32", "(2 * kTile + 4 * DqTf32",
                 "((2 * kTile + 4 * BQ)"):
        s = _edit(s, "  return sizeof(float) * " + head,
                  "  return 2 * sizeof(float) * " + head)
    s = _edit(s, "    const float* Vt = Vs + (kt & 1) * kKvElems;\n",
              "    const float* Vt = Vs + (kt & 1) * kKvElems;\n"
              "    if (kt == 0) split_tile<kTile, D>(Qs, scale);\n"
              "    split_tile<BK, D>(Ks + (kt & 1) * kKvElems, 1.f);\n"
              "    split_tile<BK, D>(Vs + (kt & 1) * kKvElems, 1.f);\n"
              "    __syncthreads();\n")
    s = _edit(s, "    const float* Vt = Vs + (kt & 1) * kKElems;\n",
              "    const float* Vt = Vs + (kt & 1) * kKElems;\n"
              "    if (kt == 0) {\n"
              "      split_tile<kTile, D>(Qs, scale);\n"
              "      split_tile<kTile, D>(Gs, 1.f);\n"
              "    }\n"
              "    split_tile<BK, D>(Ks + (kt & 1) * kKElems, 1.f);\n"
              "    split_tile<BK, D>(Vs + (kt & 1) * kKElems, 1.f);\n"
              "    __syncthreads();\n")
    return _edit(s, "    const float* Gt = Gs + (it & 1) * kQElems;\n",
                 "    const float* Gt = Gs + (it & 1) * kQElems;\n"
                 "    if (it == 0) {\n"
                 "      split_tile<kTile, D>(Ks, 1.f);\n"
                 "      split_tile<kTile, D>(Vs, 1.f);\n"
                 "    }\n"
                 "    split_tile<BQ, D>(Qs + (it & 1) * kQElems, scale);\n"
                 "    split_tile<BQ, D>(Gs + (it & 1) * kQElems, 1.f);\n"
                 "    __syncthreads();\n")


def _variants(src, baseline=None):
    q32 = lambda s: _edit(s, "kRows = D <= 64 ? 64 : 32",  # noqa: E731
                          "kRows = 32")
    smem = lambda s: _edit(s, "kKvInRegs = D <= 64",  # noqa: E731
                           "kKvInRegs = false")
    edits = {
        "base": lambda s: s,
        "no_split": lambda s: _edit(s, "  mma_bf16(d, lo, b0, b1);\n", ""),
        "fwd_4_blocks": lambda s: _edit(
            s, _BOUNDS + "flash_fwd_tc_kernel",
            "__global__ void __launch_bounds__(kTcThreads, 4)\n"
            "flash_fwd_tc_kernel"),
        "dkv_q32": q32,
        "dkv_kv_smem": smem,
        "dkv_q32_kv_smem": lambda s: q32(smem(s)),
        "dq_qg_regs": lambda s: _edit(
            _edit(s, "  const bf16* Gw = Gs + warp * 16 * LDS + at.a;\n",
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
        "f32_fwd_k32": lambda s: _edit(
            s, "struct FwdTf32 {\n  static constexpr int kOther = D <= 64 ? 64",
            "struct FwdTf32 {\n  static constexpr int kOther = D <= 64 ? 32"),
        "f32_fwd_q_regs": lambda s: _edit(
            _edit(s, "  const float* Qw = Qs + warp * 16 * LD + at.d;\n\n",
                  "  const float* Qw = Qs + warp * 16 * LD + at.d;\n"
                  "  FragA qf[D <= 64 ? KD : 1];\n\n"),
            "        FragA aq;\n"
            "        lds_a<LD>(aq, Qw + kk * 8, scale);\n",
            "        FragA aq;\n"
            "        if constexpr (D <= 64) {\n"
            "          if (kt == 0) lds_a<LD>(qf[kk], Qw + kk * 8, scale);\n"
            "          aq = qf[kk];\n"
            "        } else {\n"
            "          lds_a<LD>(aq, Qw + kk * 8, scale);\n"
            "        }\n"),
        "f32_split_staged": _staged,
        "f32_single_tf32": lambda s: _edit(
            s, "  mma_tf32(d, a.big, b.small[0], b.small[1]);\n"
            "  mma_tf32(d, a.small, b.big[0], b.big[1]);\n", ""),
        "f32_rna_small": lambda s: _edit(
            s, _SMALL, _SMALL[:-2] + " + 0x1000u;\n"),
        "f32_guard_both": lambda s: _edit(s, _SPLIT, _GUARDED_SPLIT),
    }
    out = {}
    for name, edit in edits.items():
        try:
            out[name] = edit(src)
        except _Stale as e:
            print(json.dumps({"variant": name, "skipped": str(e)}),
                  flush=True)
    if baseline is not None:
        out["baseline"] = baseline
    return out


def _registers(report):
    """ptxas's numbers for each flash kernel function at D = 64 and 128,
    keyed ``name<D>``."""
    import chip_smoke as cs

    regs = {}
    for f, r in cs._ptxas_functions(report).items():
        m = _FUNC.search(f)
        if m and m.group(2) in ("64", "128"):
            name, d = m.groups()
            regs[f"{name}<{d}>"] = r
    return regs


def main(argv) -> int:
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
        src = f.read()
    baseline = None
    if len(argv) > 1:
        with open(argv[1]) as f:
            baseline = f.read()
    variants = _variants(src, baseline)
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
        regs[name] = _registers(out)
        libs[name] = ctypes.CDLL(os.path.join(OUT_DIR, name + ".so"))

    g = torch.Generator(device=dev).manual_seed(cs.SEED)
    B, T, H, D = cs.FLASH_SHAPES["training"]
    qkv = torch.randn(B, T, 3 * H * D, generator=g, device=dev)
    go = torch.randn(B, T, H, D, generator=g, device=dev)
    # the training shape's tokens and width at D = 128, 6 heads
    wide = [torch.randn(B, T, H // 2, 2 * D, generator=g, device=dev)
            for _ in range(4)]
    small = [[torch.randn(*cs.FLASH_SHAPES[s], generator=g, device=dev)
              for _ in range(4)] for s in ("ragged", "d128")]

    def backward_args(q, k, v, go, causal):
        w_out, w_lse = fa.flash_attention_forward_reference(q, k, v, causal)
        return w_out, (q, k, v, go, w_lse, fa.flash_delta(w_out, go), causal)

    def agrees(q, k, v, go, causal, dname):
        scale = 1.0 / q.shape[-1] ** 0.5
        out, _ = fa.flash_attention_forward(q, k, v, causal)
        w_out, args = backward_args(q, k, v, go, causal)
        got = (out, fa.flash_attention_dq(*args),
               *fa.flash_attention_dkv(*args))
        want = (w_out, fa.flash_attention_dq_reference(*args, scale),
                *fa.flash_attention_dkv_reference(*args, scale))
        return all(cs._close(a, b, dname)[0] for a, b in zip(got, want))

    sets = {}
    for dtype in (torch.bfloat16, torch.float32):
        dname = str(dtype).split(".")[-1]
        q, k, v = (t.reshape(B, T, H, D).to(dtype)
                   for t in qkv.split(H * D, dim=-1))
        x = go.to(dtype)
        w = [t.to(dtype) for t in wide]
        sets[dname] = {
            "checks": [(q, k, v, x, True)] + [
                (*(t.to(dtype) for t in s), c) for s in small
                for c in (True, False)],
            "fwd": (q, k, v), "bwd": backward_args(q, k, v, x, True)[1],
            "fwd128": tuple(w[:3]), "bwd128": backward_args(*w, True)[1]}

    def timed(dname, what, x0):
        wide = "128" if what.endswith("d128") else ""
        args = sets[dname]["bwd" + wide]
        fn = {"fwd": lambda _: fa.flash_attention_forward(
                  *sets[dname]["fwd" + wide], True)[0],
              "dq": lambda _: fa.flash_attention_dq(*args),
              "dkv": lambda _: fa.flash_attention_dkv(*args)[0]}
        return cs.time_ms(fn[what.split("_")[0]], x0)

    timings = {"bfloat16": ("fwd", "dq", "dkv", "dq_d128"),
               "float32": ("fwd", "dq", "dkv", "fwd_d128", "dq_d128",
                           "dkv_d128")}
    for name in [*variants, "base"]:
        _build._libs["flash_attention"] = libs[name]
        row = {"variant": name, "ok": {}, "ms": {}}
        for dname, whats in timings.items():
            row["ok"][dname] = all(agrees(*c, dname)
                                   for c in sets[dname]["checks"])
            x0 = sets[dname]["fwd"][0]
            for what in whats:
                row["ms"][f"{dname}_{what}"] = timed(dname, what, x0)
        row["kernels"] = regs[name]
        print(json.dumps(row), flush=True)
    print(smi, flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main(sys.argv))
