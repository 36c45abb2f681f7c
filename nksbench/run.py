"""Runs one cell of the benchmark of ``repro_torch`` on this machine's card.

    python3 nksbench/run.py --workload NAME --seed N --seconds S --trace 0|1

from the root of a checkout. The cell, its configuration, traffic mix,
limits and metrics are found by name from ``BENCHMARK.json``
(``harness/spec.py``). With ``--trace 0`` the result line holds the
cell's end-to-end metrics, with ``--trace 1`` its per-layer metrics, read
under ``torch.profiler``. The last line on standard output is the result,
one JSON object; the last lines on standard error are the numbers the
check compared, each beside its limit, after a line of what the host did
in the window (``host {...}``: its calls, phase timers and, in an open
loop, the client's lateness), for reading a run's noise.

Exits 2, printing no result, if there is no CUDA card or fewer than the
cell asks for. Kernel builds go to ``build/`` inside the checkout, at
fixed paths, so that only a checkout's first run builds them.
"""
from __future__ import annotations

import time

T_START = time.perf_counter()

import argparse  # noqa: E402
import json  # noqa: E402
import os  # noqa: E402
import pathlib  # noqa: E402
import sys  # noqa: E402

HERE = pathlib.Path(__file__).resolve().parent
ROOT = HERE.parent


def cache_env(root: pathlib.Path) -> None:
    """Build and kernel caches inside the checkout, at fixed paths."""
    os.environ["REPRO_TORCH_BUILD_DIR"] = str(root / "build" / "kernels")
    os.environ["TORCH_EXTENSIONS_DIR"] = str(root / "build" / "torch_ext")
    os.environ["TRITON_CACHE_DIR"] = str(root / "build" / "triton")


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seed", type=int, required=True)
    ap.add_argument("--seconds", type=float, required=True)
    ap.add_argument("--trace", type=int, choices=(0, 1), default=0)
    args = ap.parse_args(argv)
    cache_env(ROOT)
    sys.path[:0] = [str(HERE), str(ROOT / "src")]

    import torch

    from harness.bench import run_cell
    from harness.spec import cell, load_bench

    the_cell = cell(load_bench(ROOT), args.workload)
    if not torch.cuda.is_available():
        print("no CUDA device: this benchmark measures the card",
              file=sys.stderr)
        return 2
    if torch.cuda.device_count() < the_cell.chips:
        print(f"{args.workload} needs {the_cell.chips} cards, this machine "
              f"has {torch.cuda.device_count()}", file=sys.stderr)
        return 2
    torch.set_num_threads(4)
    out = run_cell(the_cell, args.seed, args.seconds, bool(args.trace),
                   device="cuda", t_start=T_START)
    sys.stdout.flush()
    print("host " + json.dumps(out.pop("host")), file=sys.stderr)
    for name, c in out["checks"].items():
        print(f"check {name} {c['value']!r} limit {c['limit']!r}",
              file=sys.stderr)
    sys.stderr.flush()
    print(json.dumps(out), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
