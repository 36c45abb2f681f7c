#!/usr/bin/env python3
"""How the split of K6's neighbour stage into units moves its time, on one
CUDA card.

    python3 tools/k6_split.py [--source FILE.cu]

Builds edited copies of ``src/repro_torch/kernels/csrc/diameter.cu`` with
nvcc into ``build/k6_split/`` and times the fused anchor-star kernel
(``anchor_star``: the neighbour and diameter launches) by torch.profiler at
the device tier's served inputs, seeded: q=9 (9, 40192, 64) with 40,129
valid anchors and groups of 2,961, 23, 4, 2, 2, 1, 2 and 1 valid points,
whole and at shard 1 of 8's anchor range (anchors 5,024..10,047); q=3
(3, 5632, 64) with 5,621 valid anchors and groups of 4 and 4 points, whole
and at shard 1 of 8; and (3, 512, 2304) with 432 valid anchors and groups
of 3 and 1. Valid points are packed first, as the engine packs them. The
copies:

  * ``as built``: the source unchanged;
  * ``one part a run``: S = 1, each unit walks every live tile of its run
    of 32 column tiles (the kernel before the split);
  * ``two units a block`` / ``eight units a block``: the split aims at 2
    or 8 live units a resident block in place of 4;
  * with ``--source``, ``given source``: that file as it is (a kernel with
    the same C interface, such as an earlier version of this one).

Every copy's outputs must equal the first copy's bit for bit (the split
changes no result). Prints the card's name and power limit, ptxas'
registers and spills of each copy's neighbour kernel, and one line per
copy and input.
"""
from __future__ import annotations

import argparse
import concurrent.futures
import ctypes
import inspect
import pathlib
import subprocess
import sys

import torch

ROOT = pathlib.Path(__file__).resolve().parents[1]
sys.path.insert(0, str(ROOT / "src"))

from repro_torch.kernels import build  # noqa: E402

CSRC = ROOT / "src" / "repro_torch" / "kernels" / "csrc"
OUT = ROOT / "build" / "k6_split"

SPLIT = "  int S = 1;\n  if (table) {"
UNITS = "constexpr int NN_UNITS_PER_BLOCK = 4;"
EDITS = {
    "as built": [],
    "one part a run": [(SPLIT, "  int S = 1;\n  if (false) {")],
    "two units a block": [(UNITS, UNITS.replace("4", "2"))],
    "eight units a block": [(UNITS, UNITS.replace("4", "8"))],
}

# label: (q, R, d, valid anchors, valid points of groups 1.., shard or None)
INPUTS = {
    "q9": (9, 40192, 64, 40129, [2961, 23, 4, 2, 2, 1, 2, 1], None),
    "q9 shard 1 of 8": (9, 40192, 64, 40129, [2961, 23, 4, 2, 2, 1, 2, 1],
                        (1, 8)),
    "q3": (3, 5632, 64, 5621, [4, 4], None),
    "q3 shard 1 of 8": (3, 5632, 64, 5621, [4, 4], (1, 8)),
    "d2304": (3, 512, 2304, 432, [3, 1], None),
}


def _edit(src: str, old: str, new: str) -> str:
    if old not in src:
        raise SystemExit(f"the source no longer holds {old!r}")
    return src.replace(old, new)


def compile_copy(job: tuple[str, str]) -> tuple[str, pathlib.Path, list[str]]:
    name, src = job
    for old, new in EDITS.get(name, []):
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
    report, kernel = [], False
    for line in (res.stdout + res.stderr).splitlines():
        if "Compiling entry function" in line:
            kernel = "anchor_star_nn_kernel" in line
        elif kernel and ("registers" in line or "spill" in line):
            report.append(line.split(":", 1)[-1].strip())
    return name, lib, report


def device_ms(fn, reps: int = 30) -> float:
    """Device time per call of the fused kernel's two launches by
    torch.profiler (the memset of its keys left out)."""
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
    total = 0.0
    for ev in prof.key_averages():
        if "anchor_star_" in ev.key:
            t = getattr(ev, "device_time_total", None)
            total += (ev.cuda_time_total if t is None else t) / reps / 1e3
    return total


def make_input(q, r, d, n_anchor, valid):
    gen = torch.Generator(device="cuda").manual_seed(q * r + d)
    groups = torch.randn((q, r, d), generator=gen, device="cuda") * 10.0
    mask = torch.zeros((q, r), dtype=torch.bool, device="cuda")
    for j, n in enumerate([n_anchor, *valid]):
        mask[j, :n] = True
    return groups.masked_fill_(~mask[..., None], 0.0), mask


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--source", help="a .cu file to time as it is beside "
                    "the copies")
    args = ap.parse_args()
    if not torch.cuda.is_available():
        print("k6_split: no CUDA device", file=sys.stderr)
        return 2
    card = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                           "--format=csv,noheader"], capture_output=True,
                          text=True, timeout=60).stdout.strip()
    print(f"card: {card}", flush=True)
    OUT.mkdir(parents=True, exist_ok=True)
    src = (CSRC / "diameter.cu").read_text()
    jobs = [(name, src) for name in EDITS]
    if args.source:
        jobs.append(("given source", pathlib.Path(args.source).read_text()))
    with concurrent.futures.ThreadPoolExecutor() as pool:
        built = list(pool.map(compile_copy, jobs))

    p, i = ctypes.c_void_p, ctypes.c_int
    stream = torch.cuda.current_stream().cuda_stream
    inputs = {label: make_input(*spec[:5]) for label, spec in INPUTS.items()}
    first: dict = {}
    for name, path_so, report in built:
        lib = ctypes.CDLL(str(path_so))
        lib.anchor_star.argtypes = [p, p, i, i, i, i, i, i, p, p, p, p, p]
        lib.anchor_star.restype = i
        for label, (q, r, d, _, _, shard) in INPUTS.items():
            groups, mask = inputs[label]
            a0, count = (0, r) if shard is None \
                else (shard[0] * r // shard[1], r // shard[1])
            keys = torch.empty((count, q - 1), dtype=torch.int64,
                               device="cuda")
            nn = torch.empty((count, q), dtype=torch.int32, device="cuda")
            worst = torch.empty(count, device="cuda")
            diam = torch.empty(count, device="cuda")

            def call():
                err = lib.anchor_star(
                    groups.data_ptr(), mask.data_ptr(), q, r, d, a0, count,
                    0, keys.data_ptr(), nn.data_ptr(), worst.data_ptr(),
                    diam.data_ptr(), stream)
                if err:
                    raise SystemExit(f"{name} {label}: launch failed ({err})")
            call()
            torch.cuda.synchronize()
            out = [t.clone() for t in (nn, worst, diam)]
            want = first.setdefault(label, out)
            same = all(torch.equal(a, b) for a, b in zip(out, want))
            if not same:
                raise SystemExit(f"{name} {label}: outputs differ from "
                                 f"{built[0][0]}'s")
            t = device_ms(call)
            print(f"{name} {label} (q, R, d) ({q}, {r}, {d}), anchors "
                  f"{a0}..{a0 + count - 1}: {t:.5f} ms (device, profiler); "
                  f"outputs equal {built[0][0]}'s; neighbour kernel "
                  f"{'; '.join(report)}", flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
