"""Where the B.V sweep's wide shape (``csrc/b_matmat.cu``'s ``sweep_tc``,
K > 32) spends its time, on the card.

Builds copies of ``csrc/b_matmat.cu`` with parts of ``sweep_tc`` taken out
(:data:`VARIANTS`, plain text substitutions, each of which must match the
source) and times each at one sweep shape beside the kernel itself; holds
the kernel and the one-accumulator variant against the float64 product at
two small shapes; and measures ``mma.sync`` m16n8k16 bf16 alone
(:data:`MMA_PEAK_SOURCE`: independent accumulators, operands in registers).
The variants give wrong answers on purpose: they time, nothing else uses
them.  Prints one line per measurement and a JSON line at the end, beside
``nvidia-smi``'s name and power limit.

Usage (on the card): python -m oisat_tpu_torch.utils.sweep_ablation
[--cells 64512] [--block 1024] [--k 2048]
"""

from __future__ import annotations

import argparse
import ctypes
import json
import sys
from concurrent.futures import ThreadPoolExecutor

import numpy as np
import torch

from oisat_tpu_torch._device import resolve_device
from oisat_tpu_torch.ops.kernels import _build
from oisat_tpu_torch.ops.kernels import b_matmat as BM
from oisat_tpu_torch.utils.roofline import b_matmat_bound, cuda_ms, smi_line

__all__ = ["VARIANTS", "MMA_PEAK_SOURCE", "variant_source", "main"]

_BUILD_A = (
    "      {\n        const int j = 16 * ks + 2 * tq;",
    "split3(c[6], c[7], a[0][3], a[1][3], a[2][3]);  // row i + 8\n      }")
_CONST_A = ("      for (int p = 0; p < 3; ++p)\n        for (int r = 0; r < 4; ++r)"
            " a[p][r] = (lane + 7 * s) * 0x00010001u + p + r;")
_LDMATRIX = ("if (kFull || h < pairs) ldmatrix_x4_trans(smem_addr(bs + 32 * h), b[h]);",
             "for (int r = 0; r < 4; ++r) b[h][r] = (threadIdx.x + bs[0]) * 0x00010001u + r;")
_LOADS = ("if (s + 2 < steps) load_stage(", "if (false) load_stage(")
_ONE_ACC = ("across<kFull>(lo, ", "across<kFull>(hi, ")

# name: [(text, replacement, times it occurs in csrc/b_matmat.cu)]; a
# (start, end) pair as the text replaces everything from start to end
VARIANTS = {
    "kernel": [],
    "one_accumulator": [(_ONE_ACC[0], _ONE_ACC[1], 5)],
    "no_build": [(_BUILD_A, _CONST_A, 1)],
    "no_build_no_ldmatrix": [(_BUILD_A, _CONST_A, 1), (*_LDMATRIX, 1)],
    "mma_only": [(_BUILD_A, _CONST_A, 1), (*_LDMATRIX, 1), (*_LOADS, 1)],
}

MMA_PEAK_SOURCE = r"""
#include <cuda_runtime.h>
#include <cstdint>

template <int TILES>
__global__ void peak(int iters, float* out) {
  float acc[TILES][4] = {};
  uint32_t a[4];
  for (int r = 0; r < 4; ++r) a[r] = 0x3f803f80u ^ (threadIdx.x * 7 + r);
  uint32_t b0 = 0x3f803f80u ^ threadIdx.x, b1 = b0 ^ 1u;
  for (int i = 0; i < iters; ++i) {
#pragma unroll
    for (int t = 0; t < TILES; ++t)
      asm("mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 {%0, %1, %2, %3}, "
          "{%4, %5, %6, %7}, {%8, %9}, {%0, %1, %2, %3};\n"
          : "+f"(acc[t][0]), "+f"(acc[t][1]), "+f"(acc[t][2]), "+f"(acc[t][3])
          : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
    b0 += 0x00010001u;
  }
  float s = 0.f;
  for (int t = 0; t < TILES; ++t) s += acc[t][0] + acc[t][1] + acc[t][2] + acc[t][3];
  if (s == 1.2345f) out[threadIdx.x] = s;  // keeps the products alive
}

// milliseconds of `iters` rounds of 32 independent m16n8k16 products per
// warp, `warps` warps a block, one block per SM; 0 on success
extern "C" int mma_peak_ms(int warps, int sms, int iters, float* ms) {
  float* out;
  if (cudaMalloc(&out, 4096) != cudaSuccess) return 1;
  cudaEvent_t e0, e1;
  cudaEventCreate(&e0);
  cudaEventCreate(&e1);
  peak<32><<<sms, 32 * warps>>>(16, out);
  cudaEventRecord(e0);
  peak<32><<<sms, 32 * warps>>>(iters, out);
  cudaEventRecord(e1);
  cudaEventSynchronize(e1);
  cudaEventElapsedTime(ms, e0, e1);
  const int err = static_cast<int>(cudaGetLastError());
  cudaEventDestroy(e0);
  cudaEventDestroy(e1);
  cudaFree(out);
  return err;
}
"""
_MMA_PEAK_TILES = 32


def variant_source(name: str, source: str) -> str:
    """``source`` (csrc/b_matmat.cu's text) with variant ``name``'s
    substitutions; raises if one does not occur as often as it should."""
    for old, new, times in VARIANTS[name]:
        if isinstance(old, tuple):
            start, end = old
            if source.count(start) != 1 or source.count(end) != 1:
                raise ValueError(f"{name}: the span to replace is not in the source once")
            i = source.index(start)
            source = source[:i] + new + source[source.index(end, i) + len(end):]
            continue
        if source.count(old) != times:
            raise ValueError(f"{name}: {old!r} occurs {source.count(old)} times, not {times}")
        source = source.replace(old, new)
    return source


def _build_all(names) -> dict:
    """Each variant's library and the peak benchmark's, built in parallel
    into ``_build/ablation/``."""
    out_dir = _build.BUILD_DIR / "ablation"
    out_dir.mkdir(parents=True, exist_ok=True)
    source = (_build.CSRC_DIR / "b_matmat.cu").read_text()
    jobs = {name: variant_source(name, source) for name in names}
    jobs["mma_peak"] = MMA_PEAK_SOURCE
    for name, text in jobs.items():
        (out_dir / f"{name}.cu").write_text(text)

    def build(name):
        lib = out_dir / f"lib{name}.so"
        _build._build(out_dir / f"{name}.cu", lib)
        return name, ctypes.CDLL(str(lib))

    with ThreadPoolExecutor(len(jobs)) as pool:
        libs = dict(pool.map(build, jobs))
    for name in names:
        BM.declare_abi(libs[name])
    return libs


def _sweep(lib, u3, dv, block) -> torch.Tensor:
    """One full-range wide sweep through a variant's library (dv's K a
    multiple of 16 and above 32), as b_matmat_kernel launches it."""
    n, k = dv.shape
    out = torch.empty_like(dv)
    scratch = torch.empty((3, n, k), dtype=torch.bfloat16, device=dv.device)
    rc = lib.b_matmat_f32(u3.data_ptr(), dv.data_ptr(), n, k, block, 0, n // block,
                          BM.neg_half_kappa(300.0), out.data_ptr(),
                          torch.cuda.current_stream(dv.device).cuda_stream, scratch.data_ptr())
    if rc:
        raise RuntimeError(f"sweep variant launch failed: CUDA error {rc}")
    return out


def _small_case(n, block, k, dev):
    rng = np.random.default_rng(n + k)
    from oisat_tpu_torch.ops.oi_full_matfree import _unit_vectors

    u3 = _unit_vectors(rng.uniform(20, 60, n), rng.uniform(-140, -60, n), dev).contiguous()
    sb = torch.as_tensor(np.abs(rng.normal(1.0, 0.3, n)).astype(np.float32), device=dev)
    dv = sb[:, None] * torch.as_tensor(rng.standard_normal((n, k)).astype(np.float32),
                                       device=dev)
    return u3, dv


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--cells", type=int, default=64512)
    ap.add_argument("--block", type=int, default=1024)
    ap.add_argument("--k", type=int, default=2048)
    args = ap.parse_args(argv)
    dev = resolve_device("cuda")
    if args.k <= 32 or args.k % 16 or args.cells % args.block:
        raise ValueError("--k must be a multiple of 16 above 32, --cells a multiple of --block")
    libs = _build_all(list(VARIANTS))
    smi = smi_line()
    result = {"device": torch.cuda.get_device_name(dev), "nvidia_smi": smi,
              "cells": args.cells, "block": args.block, "k": args.k, "ms": {},
              "f64_distance_over_plain": {}}

    # accuracy: the kernel and one accumulator for all six products
    for n, block, k in ((2048, 128, 144), (4096, 2048, 2048)):
        u3, dv = _small_case(n, block, k, dev)
        plain = BM.b_matmat_plain(u3, dv, 300.0, block, 0, n // block)
        ref = BM.b_matmat_reference(u3, dv, 300.0, block, 0, n // block)
        dp = float((plain.double() - ref).abs().max())
        for name in ("kernel", "one_accumulator"):
            got = _sweep(libs[name], u3, dv, block)
            ratio = float((got.double() - ref).abs().max()) / dp
            result["f64_distance_over_plain"][f"{name} n={n} block={block} k={k}"] = ratio
            print(f"{name}: n={n}, block {block}, K={k}: distance from float64 {ratio:.2f}x "
                  "the plain engine's", flush=True)

    # times: the bench's geometry (bench.matfree_inputs) cut to --cells
    from oisat_tpu_torch.bench import matfree_inputs
    from oisat_tpu_torch.ops.oi_full_matfree import _unit_vectors

    _, _, _, _, lat, lon, _ = matfree_inputs()
    pad = max(0, args.cells - lat.size)
    lat, lon = (np.concatenate([a, np.zeros(pad)])[:args.cells] for a in (lat, lon))
    u3 = _unit_vectors(lat, lon, dev).contiguous()
    dv = torch.as_tensor(np.random.default_rng(0).standard_normal(
        (args.cells, args.k)).astype(np.float32), device=dev)
    for name in VARIANTS:
        ms = cuda_ms(lambda lib=libs[name]: _sweep(lib, u3, dv, args.block), reps=3)
        result["ms"][name] = ms
        print(f"{name}: {ms:.2f} ms at N={args.cells}, block {args.block}, K={args.k}; {smi}",
              flush=True)
    result["bound_ms"] = b_matmat_bound(args.cells, args.k)[0]

    # mma.sync alone
    peak = libs["mma_peak"]
    peak.mma_peak_ms.argtypes = [ctypes.c_int, ctypes.c_int, ctypes.c_int,
                                 ctypes.POINTER(ctypes.c_float)]
    sms = torch.cuda.get_device_properties(dev).multi_processor_count
    result["mma_sync_tflops"] = {}
    for warps in (4, 8):  # 16 warps of 32 accumulator tiles exceed the SM's registers
        ms = ctypes.c_float()
        iters = 20000
        if peak.mma_peak_ms(warps, sms, iters, ctypes.byref(ms)):
            raise RuntimeError("mma_peak_ms failed")
        flops = 2.0 * 16 * 8 * 16 * _MMA_PEAK_TILES * iters * warps * sms
        tflops = flops / ms.value / 1e9
        result["mma_sync_tflops"][f"{warps} warps an SM"] = tflops
        print(f"mma.sync m16n8k16 bf16 alone, {warps} warps an SM: {tflops:.1f} TFLOP/s; {smi}",
              flush=True)
    print(json.dumps(result), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
