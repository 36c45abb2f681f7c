"""``BENCHMARK.json`` and the files it names, found by name.

Everything that belongs to one configuration, one traffic mix, one cell or
one metric sits in a file of its own, which the harness finds from the
names in ``BENCHMARK.json`` (all paths relative to the checkout's root):

* a configuration: its ``file`` (JSON), which names the system under test
  (``nksbench/systems/<system>.py``: builds it from the seed's data,
  instruments it, names its kernels and counts its work), its data's
  generator (``nksbench/corpora/<generator>.py``) and its answer check
  (``nksbench/checks/<check>.py``);
* a traffic mix: ``nksbench/mixes/<traffic>.json``, which names its loop
  (``nksbench/loops/<loop>.py``);
* a cell's limits on the numbers its check compares:
  ``nksbench/limits/<workload>.json``;
* a metric, end to end or per layer: ``nksbench/metrics/<name>.py``, whose
  ``read(ctx)`` returns its value, or None where it finds nothing to read;
  a metric split by cell (``pack_ms.stream``, ``pack_ms.batch``) may share
  one reader, ``nksbench/metrics/<stem>.py``, the name before its first
  dot, where it has no file of its own.

A later cell or metric adds files and entries; no file here changes.
"""
from __future__ import annotations

import dataclasses
import importlib.util
import json
import pathlib
import sys

BENCH = pathlib.Path(__file__).resolve().parents[1]
ROOT = BENCH.parent

_MODULES: dict = {}


def load_module(path: pathlib.Path):
    """The Python file ``path`` as a module (once a process); its name may
    hold dots, as a metric's does."""
    path = pathlib.Path(path)
    mod = _MODULES.get(path)
    if mod is None:
        if not path.is_file():
            raise FileNotFoundError(f"no file {path}")
        name = "nksbench_" + "_".join(path.relative_to(BENCH).with_suffix(
            "").parts).replace(".", "_").replace("-", "_")
        spec = importlib.util.spec_from_file_location(name, path)
        mod = importlib.util.module_from_spec(spec)
        sys.modules[name] = mod
        spec.loader.exec_module(mod)
        _MODULES[path] = mod
    return mod


@dataclasses.dataclass
class Cell:
    """One workload of ``BENCHMARK.json`` with everything it names."""

    name: str
    chips: int
    config_name: str
    config: dict
    traffic: str
    mix: dict
    limits: dict
    end_to_end: list[dict]
    per_layer: list[dict]

    def metrics(self, trace: bool) -> list[dict]:
        return self.per_layer if trace else self.end_to_end

    def reader(self, metric: dict):
        return load_module(reader_path(metric["name"])).read


def reader_path(name: str) -> pathlib.Path:
    """The reader of metric ``name``: its own file, else its stem's."""
    own = BENCH / "metrics" / f"{name}.py"
    return own if own.is_file() \
        else BENCH / "metrics" / f"{name.split('.')[0]}.py"


def system_module(config: dict):
    """The system under test that a configuration names."""
    return load_module(BENCH / "systems" / f"{config['system']}.py")


def _reports(metric: dict, cell: str, e2e_names: set[str]) -> bool:
    if "workloads" in metric:
        return cell in metric["workloads"]
    return "moves" not in metric or metric["moves"] in e2e_names


def load_bench(root: pathlib.Path = ROOT) -> dict:
    return json.loads((root / "BENCHMARK.json").read_text())


def cell(bench: dict, workload: str, root: pathlib.Path = ROOT) -> Cell:
    """The cell named ``workload``, its files read."""
    by_name = {w["name"]: w for w in bench["workloads"]}
    if workload not in by_name:
        raise KeyError(f"no workload {workload!r} in BENCHMARK.json "
                       f"(have {sorted(by_name)})")
    w = by_name[workload]
    conf = {c["name"]: c for c in bench["configs"]}[w["config"]]
    config = json.loads((root / conf["file"]).read_text())
    mix = json.loads((root / "nksbench" / "mixes"
                      / f"{w['traffic']}.json").read_text())
    limits = json.loads((root / "nksbench" / "limits"
                         / f"{workload}.json").read_text())
    e2e = [m for m in bench["end_to_end"]
           if _reports(m, workload, set())]
    names = {m["name"] for m in e2e}
    per_layer = [m for m in bench["per_layer"]
                 if _reports(m, workload, names)]
    return Cell(workload, int(w["chips"]), w["config"], config,
                w["traffic"], mix, limits, e2e, per_layer)
