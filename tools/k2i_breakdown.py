#!/usr/bin/env python3
"""Where the time of K2i (the int8 prune-tier join counts) goes, on one
CUDA card.

    python3 tools/k2i_breakdown.py

Builds edited copies of ``src/repro_torch/kernels/csrc/pairwise_l2.cu`` with
nvcc into ``build/k2i_breakdown/`` and times K2i's two kernels, the
cooperative prep (``int8_prep_kernel``) and the join
(``prune_int8_kernel``), one by one with torch.profiler at K2's path shape
(8, 2880, 64) with its live lengths (2779, 2876, six empty) and at (8, 512,
2304) with lengths (512, 500, 257, 64, 63, 1, 0, 0), seeded. The copies:

  * ``as built``: the source unchanged;
  * ``no epilogue``: the join's threshold comparisons never run;
  * ``no products``: the join issues no ``wgmma``;
  * ``two blocks an SM``: the join built for two blocks an SM (three
    stages a ring), which ptxas gives 96 registers a thread;
  * ``no max pass``: the prep skips its pass over the largest magnitudes;
  * ``no grid barrier``: the prep's grid-wide barrier is gone;
  * ``no row pass``: the prep stops after its barrier;
  * ``stamped``: as built, with clock stamps (``clock64``) at the join's
    steps, read back per block: the set-up (barriers, the walk's table, the
    producer's first unit and copies, the first panel's arrival) and the
    end of each of a block's first tiles, in cycles from the block's start
    (medians and maxima over the blocks, at the path shape).

The edited copies compute wrong counts or skip work: only their times mean
anything. Prints the card's name and power limit, ptxas' registers and
spills of each copy's join, one line per copy and shape, then the stamps.
"""
from __future__ import annotations

import concurrent.futures
import ctypes
import inspect
import pathlib
import subprocess
import sys

import numpy as np
import torch

ROOT = pathlib.Path(__file__).resolve().parents[1]
sys.path.insert(0, str(ROOT / "src"))

from repro_torch.kernels import build  # noqa: E402
from repro_torch.kernels.pairwise_l2 import int8_layout  # noqa: E402

CSRC = ROOT / "src" / "repro_torch" / "kernels" / "csrc"
OUT = ROOT / "build" / "k2i_breakdown"


def _edit(src: str, old: str, new: str) -> str:
    if old not in src:
        raise SystemExit(f"the source no longer holds {old!r}")
    return src.replace(old, new)


INTERIOR = ("      int c4[4] = {0, 0, 0, 0};\n"
            "      if (interior) {                          // the threshold alone")
EDGE = ("      } else {\n"
        "        const unsigned long long cl[2] = {")
PRODUCTS = ("        for (int kk = 0; kk < QI_K / QI_KSTEP; ++kk)\n"
            "          wgmma_s8_n128(acc, desc_k_major(da + kk * QI_KSTEP),\n"
            "                        desc_k_major(db + kk * QI_KSTEP), 1);")
BARRIER = "  cooperative_groups::this_grid().sync();\n"
MAX_PASS = "  for (int u = blockIdx.x; u < per_s * S; u += gridDim.x) {"

# Clock stamps of the join, slot by slot: 0 the block's start, 1 its barriers
# initialised, 2 the walk's table and thresholds in place, 3 the producer's
# first copies issued, 4 the first panel arrived, 5 its products retired,
# 6.. the end of each of the block's first tiles, 15 the tiles it took.
STAMPS = [
    ("namespace {\n\n__device__ __forceinline__ bool elig_bit",
     "namespace {\n__device__ long long g_stamp[1024][16];\n"
     "#define STAMP(i) (g_stamp[blockIdx.x][i] = clock64())\n\n"
     "__device__ __forceinline__ bool elig_bit"),
    ("  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;\n"
     "  const float sqrtd",
     "  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;\n"
     "  if (tid == 0) STAMP(0);\n  const float sqrtd"),
    ("  __syncthreads();\n\n  const int nt = (P + QI_T - 1) / QI_T;",
     "  __syncthreads();\n  if (tid == 0) STAMP(1);\n\n"
     "  const int nt = (P + QI_T - 1) / QI_T;"),
    ("  int ia = 0, ib = 0;                 // panels taken from each ring",
     "  if (tid == 0) STAMP(2);\n"
     "  int ia = 0, ib = 0;                 // panels taken from each ring"),
    ("            ++it;\n          }\n        }\n        held = keeps_column",
     "            ++it;\n            if (ia + ib == 1) STAMP(3);\n"
     "          }\n        }\n        held = keeps_column"),
    ("        mbar_wait(full(0, sa), (ia / QI_STAGES) & 1);\n        ++ia;",
     "        mbar_wait(full(0, sa), (ia / QI_STAGES) & 1);\n"
     "        if (tid == 0 && ia == 0) STAMP(4);\n        ++ia;"),
    ("        fence_regs(acc);\n        if (k + 1 < panels) {",
     "        fence_regs(acc);\n"
     "        if (tid == 0 && ia == panels) STAMP(5);\n"
     "        if (k + 1 < panels) {"),
    ("      if (!diag && !held) release(empty(1, sb));\n"
     "      if (cur.t + 1 >= cur.end) break;",
     "      if (!diag && !held) release(empty(1, sb));\n"
     "      if (tid == 0) {\n"
     "        const long long n = ++g_stamp[blockIdx.x][15];\n"
     "        if (n <= 9) g_stamp[blockIdx.x][5 + n] = clock64();\n"
     "      }\n"
     "      if (cur.t + 1 >= cur.end) break;"),
    ("int join_square_tile() { return ST; }",
     "int join_square_tile() { return ST; }\n"
     "int read_stamps(void* dst) {\n"
     "  return (int)cudaMemcpyFromSymbol(dst, g_stamp, sizeof(g_stamp));\n}\n"
     "int clear_stamps() {\n  static long long z[1024][16];\n"
     "  return (int)cudaMemcpyToSymbol(g_stamp, z, sizeof(z));\n}"),
]

EDITS = {
    "as built": [],
    "no epilogue": [(INTERIOR, "      int c4[4] = {acc[0], acc[63], 0, 0};\n"
                     "      if (false) {"),
                    (EDGE, "      } else if (false) {\n"
                     "        const unsigned long long cl[2] = {")],
    "no products": [(PRODUCTS, "")],
    "two blocks an SM": [("constexpr int QI_MIN_BLOCKS = 1;",
                          "constexpr int QI_MIN_BLOCKS = 2;"),
                         ("constexpr int QI_STAGES = 4;",
                          "constexpr int QI_STAGES = 3;")],
    "no max pass": [(MAX_PASS, "  for (int u = blockIdx.x; u < 0; u += gridDim.x) {")],
    "no grid barrier": [(BARRIER, "")],
    "no row pass": [(BARRIER, BARRIER + "  if (S > 0) return;\n")],
    "stamped": STAMPS,
}


def compile_copy(name: str) -> tuple[str, pathlib.Path, list[str]]:
    src = (CSRC / "pairwise_l2.cu").read_text()
    for old, new in EDITS[name]:
        src = _edit(src, old, new)
    stem = name.replace(" ", "_").replace("-", "_")
    cu = OUT / f"{stem}.cu"
    cu.write_text(src)
    lib = OUT / f"lib{stem}.so"
    res = subprocess.run(
        [build.nvcc_path(), *build.ARCH_FLAGS, *build.NVCC_FLAGS,
         "-I", str(CSRC), "-o", str(lib), str(cu)],
        capture_output=True, text=True, timeout=600)
    if res.returncode:
        raise SystemExit(f"nvcc failed on {name}: {res.stderr[-2000:]}")
    report, kernel = [], False
    for line in (res.stdout + res.stderr).splitlines():
        if "Compiling entry function" in line:
            kernel = "prune_int8_kernel" in line
        elif kernel and ("registers" in line or "spill" in line):
            report.append(line.split(":", 1)[-1].strip())
    return name, lib, report


def device_ms(fn, reps: int = 20) -> dict:
    """Device time per call of K2i's two kernels by torch.profiler."""
    from torch.profiler import ProfilerActivity, profile
    for _ in range(3):
        fn()
    torch.cuda.synchronize()
    kw = {"acc_events": True} \
        if "acc_events" in inspect.signature(profile).parameters else {}
    with profile(activities=[ProfilerActivity.CUDA], **kw) as prof:
        for _ in range(reps):
            fn()
        torch.cuda.synchronize()
    out = {"prep": 0.0, "join": 0.0}
    for ev in prof.key_averages():
        name = "prep" if "int8_prep_kernel" in ev.key else \
            "join" if "prune_int8_kernel" in ev.key else None
        if name:
            total = getattr(ev, "device_time_total", None)
            if total is None:
                total = ev.cuda_time_total
            out[name] += total / reps / 1e3
    return out


def main() -> int:
    if not torch.cuda.is_available():
        print("k2i_breakdown: no CUDA device", file=sys.stderr)
        return 2
    card = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                           "--format=csv,noheader"], capture_output=True,
                          text=True, timeout=60).stdout.strip()
    print(f"card: {card}", flush=True)
    OUT.mkdir(parents=True, exist_ok=True)
    with concurrent.futures.ThreadPoolExecutor() as pool:
        built = list(pool.map(compile_copy, EDITS))

    gen = torch.Generator(device="cuda").manual_seed(0)
    shapes = {
        "path": (torch.randn((8, 2880, 64), generator=gen, device="cuda")
                 * 10.0,
                 [2779, 2876, 0, 0, 0, 0, 0, 0], 110.0),
        "d2304": (torch.randn((8, 512, 2304), generator=gen, device="cuda"),
                  [512, 500, 257, 64, 63, 1, 0, 0], 62.0),
    }
    p, i = ctypes.c_void_p, ctypes.c_int
    stream = torch.cuda.current_stream().cuda_stream
    for name, path_so, report in built:
        lib = ctypes.CDLL(str(path_so))
        lib.join_batched_prune_int8.argtypes = [p, p, p, p, i, i, i, i, i,
                                                p, p, p, p, p]
        lib.join_batched_prune_int8.restype = i
        for shape, (x, lens, r) in shapes.items():
            s, n, d = x.shape
            lengths = torch.tensor(lens, dtype=torch.int32, device="cuda")
            radii = torch.full((s,), r, device="cuda")
            pitch, pn, q_bytes = int8_layout(s, n, d)
            scratch = torch.empty(q_bytes + s * pn * 4, dtype=torch.uint8,
                                  device="cuda")
            zeroed = torch.zeros(2 * s, dtype=torch.int32, device="cuda")

            def call():
                zeroed.zero_()
                err = lib.join_batched_prune_int8(
                    x.data_ptr(), lengths.data_ptr(), radii.data_ptr(), None,
                    s, n, d, pitch, pn, scratch.data_ptr(),
                    scratch.data_ptr() + q_bytes, zeroed.data_ptr() + 4 * s,
                    zeroed.data_ptr(), stream)
                if err:
                    raise SystemExit(f"{name}: launch failed ({err})")
            t = device_ms(call)
            print(f"{name} {shape}: prep {t['prep']:.5f} ms, join "
                  f"{t['join']:.5f} ms (device, profiler); join "
                  f"{'; '.join(report)}", flush=True)
            if name == "stamped" and shape == "path":
                lib.clear_stamps()
                call()
                torch.cuda.synchronize()
                st = np.zeros((1024, 16), dtype=np.int64)
                lib.read_stamps(ctypes.c_void_p(st.ctypes.data))
                st = st[:int((st[:, 15] > 0).sum())]
                rel = st[:, :15] - st[:, :1]
                steps = ["start", "barriers initialised", "table in place",
                         "first copies issued", "first panel arrived",
                         "first products retired"]
                for k, label in enumerate(steps[1:], start=1):
                    print(f"  stamp {label}: median {int(np.median(rel[:, k]))}"
                          f" max {int(rel[:, k].max())} cycles", flush=True)
                for k in range(int(st[:, 15].max())):
                    sel = st[:, 15] > k
                    v = rel[sel, 6 + k]
                    print(f"  stamp tile {k} done: median {int(np.median(v))} "
                          f"max {int(v.max())} cycles ({int(sel.sum())} "
                          f"blocks)", flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
