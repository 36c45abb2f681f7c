#!/usr/bin/env python3
"""Where the time of the K3/K4 join engine goes, on one CUDA card.

    python3 tools/join_breakdown.py

Builds edited copies of ``src/repro_torch/kernels/csrc/pairwise_l2.cu`` with
nvcc into ``build/join_breakdown/`` and times each with CUDA events at the
path shapes: K3 at (4096, 4096, 64), K4 at (8, 2880, 64) with K1's path
lengths (2779, 2876, six empty) and dense (every length 2880), 128 x 128
count tiles. The copies:

  * ``as built``: the source unchanged;
  * ``no epilogue``: the tile's epilogue never runs (staging, norms, the
    FMA loop and K4's fill stay);
  * ``no count``: the epilogue without the join counts;
  * ``no store``: the epilogue without the sq stores;
  * ``8 x 8 tile``: 256 threads of 8 x 8 register tiles in place of 128 of
    16 x 8 (128 registers a thread, so it spills).

The edited copies compute wrong counts or skip outputs: only their times
mean anything. Prints the card's name and power limit, ptxas' registers and
spills of each copy, and one line per copy.
"""
from __future__ import annotations

import concurrent.futures
import ctypes
import pathlib
import subprocess
import sys

import torch

ROOT = pathlib.Path(__file__).resolve().parents[1]
sys.path.insert(0, str(ROOT / "src"))

from repro_torch.kernels import build  # noqa: E402

CSRC = ROOT / "src" / "repro_torch" / "kernels" / "csrc"
OUT = ROOT / "build" / "join_breakdown"


def _edit(src: str, old: str, new: str) -> str:
    if old not in src:
        raise SystemExit(f"the source no longer holds {old!r}")
    return src.replace(old, new)


EPILOGUE = "    epi(walk.tile(u), acc, smem + ((g - 1) & 1) * RT_STAGE);"
# never true on the timed inputs (coordinates in [0, 100), r = 150)
NEVER = "v.x == 1.2345f"
EDITS = {
    "as built": [],
    "no epilogue": [(EPILOGUE, "    if (acc[0][0] == 1.2345f && acc[1][1] == 1.f)\n"
                     + EPILOGUE)],
    "no count": [("    if (cnt.single) {                        // warp-uniform\n"
                  "      joined += p0 + p1 + p2 + p3;\n    } else {",
                  f"    if ({NEVER}) {{\n      joined += p0 + p1 + p2 + p3;\n"
                  f"    }} else if ({NEVER}) {{")],
    "no store": [("    if (vec_out && gc + 3 < nc) {\n"
                  "      __stcs(reinterpret_cast<float4*>(dst), v);\n"
                  "    } else {",
                  f"    if ({NEVER}) {{\n"
                  "      __stcs(reinterpret_cast<float4*>(dst), v);\n"
                  f"    }} else if ({NEVER}) {{")],
    "8 x 8 tile": [("constexpr int RT_RG = 8;", "constexpr int RT_RG = 16;")],
}


def compile_copy(name: str) -> tuple[str, pathlib.Path, list[str]]:
    src = (CSRC / "pairwise_l2.cu").read_text()
    for old, new in EDITS[name]:
        src = _edit(src, old, new)
    stem = name.replace(" ", "_")
    cu = OUT / f"{stem}.cu"
    cu.write_text(src)
    lib = OUT / f"lib{stem}.so"
    res = subprocess.run(
        [build.nvcc_path(), *build.ARCH_FLAGS, *build.NVCC_FLAGS,
         "-I", str(CSRC), "-o", str(lib), str(cu)],
        capture_output=True, text=True, timeout=600)
    if res.returncode:
        raise SystemExit(f"nvcc failed on {name}: {res.stderr[-2000:]}")
    report, kernel = [], None
    for line in (res.stdout + res.stderr).splitlines():
        if "Compiling entry function" in line:
            kernel = next((k for k in ("pairwise_join_kernel",
                                       "batched_tiles_kernel") if k in line),
                          None)
        elif kernel and ("registers" in line or "spill" in line):
            report.append(f"{kernel}: {line.strip()}")
    return name, lib, report


def events_ms(fn, reps: int = 20) -> float:
    for _ in range(3):
        fn()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    torch.cuda.synchronize()
    start.record()
    for _ in range(reps):
        fn()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / reps


def main() -> int:
    if not torch.cuda.is_available():
        print("join_breakdown: no CUDA device", file=sys.stderr)
        return 2
    card = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                           "--format=csv,noheader"], capture_output=True,
                          text=True, timeout=60).stdout.strip()
    print(f"card: {card}", flush=True)
    OUT.mkdir(parents=True, exist_ok=True)
    with concurrent.futures.ThreadPoolExecutor() as pool:
        built = list(pool.map(compile_copy, EDITS))

    gen = torch.Generator(device="cuda").manual_seed(0)
    a = torch.rand((4096, 64), generator=gen, device="cuda") * 100
    b = torch.rand((4096, 64), generator=gen, device="cuda") * 100
    x = torch.rand((8, 2880, 64), generator=gen, device="cuda") * 100
    path = torch.tensor([2779, 2876, 0, 0, 0, 0, 0, 0], dtype=torch.int32,
                        device="cuda")
    dense = torch.full((8,), 2880, dtype=torch.int32, device="cuda")
    radii = torch.full((8,), 150.0, device="cuda")
    sq3 = torch.empty((4096, 4096), device="cuda")
    n3 = torch.zeros((32, 32), dtype=torch.int32, device="cuda")
    sq4 = torch.empty((8, 2880, 2880), device="cuda")
    n4 = torch.zeros((8, 23, 23), dtype=torch.int32, device="cuda")
    p, i = ctypes.c_void_p, ctypes.c_int
    stream = torch.cuda.current_stream().cuda_stream
    for name, path_so, report in built:
        lib = ctypes.CDLL(str(path_so))
        lib.pairwise_join.argtypes = [p, p, i, i, i, ctypes.c_float, i, i,
                                      p, p, p]
        lib.join_batched_tiles.argtypes = [p, p, p, i, i, i, i, i, p, p, p]
        lib.pairwise_join.restype = lib.join_batched_tiles.restype = i

        def k3():
            n3.zero_()
            lib.pairwise_join(a.data_ptr(), b.data_ptr(), 4096, 4096, 64,
                              float("inf"), 128, 128, sq3.data_ptr(),
                              n3.data_ptr(), stream)

        def k4(lengths):
            def run():
                n4.zero_()
                lib.join_batched_tiles(x.data_ptr(), lengths.data_ptr(),
                                       radii.data_ptr(), 8, 2880, 64, 128,
                                       128, sq4.data_ptr(), n4.data_ptr(),
                                       stream)
            return run
        times = [events_ms(k3), events_ms(k4(path)), events_ms(k4(dense))]
        print(f"{name}: K3 {times[0]:.4f} ms, K4 path {times[1]:.4f} ms, "
              f"K4 dense {times[2]:.4f} ms (events, with the counts' "
              f"zeroing); {'; '.join(report)}", flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
