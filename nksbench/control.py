"""The control of a cell's check, and faults planted in the reference put
in the program's place, read at the cell's own size.

    python3 nksbench/control.py --workload NAME --seeds 1,2,3 \
        [--seconds S] [--device cuda|cpu] [--out FILE]

For each seed it makes the cell's corpus and traffic as a run does, takes
the requests a run of ``--seconds`` would check (the same sample, drawn
from the seed among a run's answered requests: all of an open loop's, the
window's batches of a closed loop's), and answers each of them in the
program's place in these ways (:data:`FAULTS`):

* ``tf32``: the control, ``reference.search(precision="tf32")``, the plain
  search one precision below the configuration's fp32;
* ``second_best``: the float64 stars ranked 2 to k + 1, the best left out;
* ``not_nearest``: every star's neighbour of each tag the second-nearest
  point of that tag, the stars then ranked by their float64 diameters;
* ``repeat_first``: the float64 best star k times.

It compares each by the cell's check and prints one JSON line a seed and
way: the numbers compared, and which of them exceed the cell's limits
(``nksbench/limits/<workload>.json``). The control and each fault have to
fail one of them; their readings set the upper end of each limit. Needs
the card unless ``--device cpu``. The benchmark's own runs do not run it.
"""
from __future__ import annotations

import argparse
import json
import pathlib
import sys
import time

HERE = pathlib.Path(__file__).resolve().parent
ROOT = HERE.parent

FAULTS = ("tf32", "second_best", "not_nearest", "repeat_first")


def _second_nearest(anchors, group, block_bytes: int):
    """(A,) index in ``group`` of each anchor's second-nearest point (its
    nearest where the group has one point), float64."""
    import torch

    g_sq = group.square().sum(-1)
    rows = max(1, block_bytes // (group.element_size() * max(len(group), 1)))
    out = torch.empty(len(anchors), dtype=torch.int64, device=anchors.device)
    for lo in range(0, len(anchors), rows):
        s = torch.addmm(g_sq[None, :], anchors[lo:lo + rows], group.T,
                        alpha=-2.0)
        first = s.argmin(dim=1)
        if len(group) > 1:
            s.scatter_(1, first[:, None], torch.inf)
            first = s.argmin(dim=1)
        out[lo:lo + rows] = first
        del s
    return out


def fault_answers(qr, ref, k: int) -> dict:
    """One query's answer in each of :data:`FAULTS`'s ways, as a run
    records answers (``[(ids, diameter)]``); ``ref`` is its
    ``reference.reference``."""
    import torch

    from harness.reference import (BLOCK_BYTES, _answer, search,
                                   star_diameters)

    def pairs(ans):
        return list(zip(ans.ids, ans.diams))

    if ref.members is None:
        return {f: [] for f in FAULTS}
    members, diams = ref.members, ref.diams
    order = torch.sort(diams, stable=True).indices
    rest = order[1:]
    anchors = qr.pts[0]
    far = torch.stack(
        [torch.arange(len(anchors), device=anchors.device)]
        + [_second_nearest(anchors, g, BLOCK_BYTES) for g in qr.pts[1:]],
        dim=1)
    best = pairs(ref.answer)[:1]
    return {
        "tf32": pairs(search(qr, k, precision="tf32")),
        "second_best": pairs(_answer(qr, members[rest], diams[rest], k)),
        "not_nearest": pairs(_answer(qr, far, star_diameters(qr, far), k)),
        "repeat_first": best * min(k, len(diams)),
    }


def control_numbers(cell, seed: int, seconds: float, device: str) -> dict:
    """``{way: numbers}`` for one seed: the check's numbers of each way of
    answering (:data:`FAULTS`) over the sample a run would check."""
    import torch

    from harness.reference import gather_query, reference
    from harness.spec import BENCH, load_module, system_module
    from harness.traffic import check_sample, make_traffic

    system = system_module(cell.config)
    check = load_module(BENCH / "checks" / f"{cell.config['check']}.py")
    corpus = system.make_data(cell.config, seed)
    traffic = make_traffic(cell.mix, corpus, seed, seconds)
    if hasattr(traffic, "due_s"):
        queries = traffic.queries
    else:
        batches = max(1, round(seconds * cell.mix["batches_per_s"]))
        queries = [q for i in range(batches) for q in traffic.batch_at(i)]
    sample = check_sample(len(queries), int(cell.mix["check_sample"]), seed)
    exact = set(check.EXACT)
    out = {f: dict.fromkeys(check.NUMBERS, 0.0) for f in FAULTS}
    points = corpus.points(device)
    with torch.no_grad():
        for s in sample:
            query = queries[int(s)]
            qr = gather_query(points, corpus.posting, query)
            ref = reference(qr, cell.mix["k"])
            ways = fault_answers(qr, ref, int(cell.mix["k"]))
            ref.members = ref.diams = None
            numbers = check.compare_sets(
                corpus, [query], {f: [ways[f]] for f in FAULTS},
                int(cell.mix["k"]), [0], device, refs={0: ref})
            for f in FAULTS:
                for name, v in numbers[f].items():
                    out[f][name] = out[f][name] + v if name in exact \
                        else max(out[f][name], v)
    del points
    return out


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seeds", required=True)
    ap.add_argument("--seconds", type=float, default=None)
    ap.add_argument("--device", default="cuda")
    ap.add_argument("--out", default=None)
    args = ap.parse_args()
    sys.path[:0] = [str(HERE), str(ROOT / "src")]
    from harness.spec import cell, load_bench

    bench = load_bench(ROOT)
    the_cell = cell(bench, args.workload)
    seconds = args.seconds or bench["run_seconds"]
    rows = []
    for seed in (int(s) for s in args.seeds.split(",")):
        t0 = time.perf_counter()
        by_way = control_numbers(the_cell, seed, seconds, args.device)
        for way, numbers in by_way.items():
            fails = [k for k, v in numbers.items()
                     if k in the_cell.limits and v > the_cell.limits[k]]
            row = {"workload": args.workload, "seed": seed, "way": way,
                   "numbers": numbers, "fails": fails,
                   "seconds": time.perf_counter() - t0}
            rows.append(row)
            print(json.dumps(row), flush=True)
    if args.out:
        pathlib.Path(args.out).write_text(
            "".join(json.dumps(r) + "\n" for r in rows))
    return 0


if __name__ == "__main__":
    sys.exit(main())
