"""``BENCHMARK.json`` against the benchmark's contract, and the discovery
of each cell's files by name."""
from __future__ import annotations

import json
import re

import pytest

from harness.spec import (BENCH, ROOT, cell, load_bench, load_module,
                          reader_path, system_module)

NAME = re.compile(r"^[A-Za-z0-9_][A-Za-z0-9_.-]{0,63}$")
UNIT = re.compile(r"^[A-Za-z0-9_/%.-]{1,16}$")
PATH = re.compile(r"^[A-Za-z0-9_./-]{1,200}$")
TEXT = re.compile(r"^[^\t\n\r]{1,200}$")
SOURCES_E2E = {"host_clock", "device_trace"}
SOURCES = SOURCES_E2E | {"program_span", "program_counter"}

B = load_bench()


def test_top_level_and_size():
    assert set(B) == {"command", "paths", "run_seconds", "configs",
                      "workloads", "end_to_end", "per_layer"}
    assert (ROOT / "BENCHMARK.json").stat().st_size <= 64 * 1024
    assert 1 <= len(B["paths"]) <= 16
    for p in B["paths"]:
        assert PATH.match(p) and not p.startswith("/") and ".." not in p
        assert not p.endswith("_torch") and (ROOT / p).is_dir()
    cmd = B["command"]
    assert 1 <= len(cmd) <= 32 and all(TEXT.match(w) for w in cmd)
    for w in cmd:
        if "/" in w or w.endswith(".py"):
            assert any(w.startswith(p + "/") for p in B["paths"])
            assert (ROOT / w).is_file()


def test_run_seconds_fit_the_check_with_24_cells():
    rs = B["run_seconds"]
    assert isinstance(rs, int) and 1 <= rs <= 51
    runs = 2 + 14 * 24
    assert runs * (rs + 60) + 24 * 2 * 90 + 1200 <= 43200


def test_configs():
    names = [c["name"] for c in B["configs"]]
    assert len(names) == len(set(names)) and 1 <= len(names) <= 24
    files = [c["file"] for c in B["configs"]]
    assert len(files) == len(set(files))
    used = {w["config"] for w in B["workloads"]}
    for c in B["configs"]:
        assert set(c) == {"name", "source", "file", "reduced", "why"}
        assert NAME.match(c["name"]) and c["name"] in used
        assert TEXT.match(c["source"]) and TEXT.match(c["why"])
        assert c["source"].startswith("https://")
        assert any(c["file"].startswith(p + "/") for p in B["paths"])
        conf = json.loads((ROOT / c["file"]).read_text())
        assert len(c["reduced"]) <= 16
        assert sorted(c["reduced"]) == sorted(conf["reduced"])
        assert all(NAME.match(k) for k in c["reduced"])
        assert (BENCH / "corpora"
                / f"{conf['corpus']['generator']}.py").is_file()
        assert (BENCH / "checks" / f"{conf['check']}.py").is_file()
        system = system_module(conf)
        assert callable(system.make_data) and callable(system.build)
        assert callable(system.work) and set(system.KERNELS) \
            == set(system.launches())
        assert conf["precision"] == "fp32"


def test_workloads():
    names = [w["name"] for w in B["workloads"]]
    assert len(names) == len(set(names)) and 1 <= len(names) <= 24
    pairs = [(w["config"], w["traffic"]) for w in B["workloads"]]
    assert len(pairs) == len(set(pairs))
    assert sum(w["chips"] == 4 for w in B["workloads"]) <= max(
        1, len(names) // 4)
    for w in B["workloads"]:
        assert set(w) == {"name", "config", "traffic", "chips", "why"}
        assert NAME.match(w["name"]) and NAME.match(w["traffic"])
        assert w["chips"] in (1, 4) and TEXT.match(w["why"])
        mix = json.loads((BENCH / "mixes" / f"{w['traffic']}.json")
                         .read_text())
        assert (BENCH / "loops" / f"{mix['loop']}.py").is_file()


def test_metrics_and_what_each_cell_reports():
    e2e = {m["name"]: m for m in B["end_to_end"]}
    per = {m["name"]: m for m in B["per_layer"]}
    assert "setup_s" in e2e and 1 <= len(e2e) <= 16
    assert 1 <= len(per) <= 128 and not set(e2e) & set(per)
    for m in B["end_to_end"]:
        assert set(m) - {"workloads"} == {"name", "unit", "better", "bound",
                                          "source"}
        assert m["source"] in SOURCES_E2E
        assert 0.01 <= m["bound"] <= 0.25
    for m in B["per_layer"]:
        assert set(m) - {"workloads"} == {"name", "unit", "better", "source",
                                          "layer", "moves"}
        assert m["source"] in SOURCES and m["moves"] in e2e
        assert TEXT.match(m["layer"])
    for m in list(e2e.values()) + list(per.values()):
        assert NAME.match(m["name"]) and UNIT.match(m["unit"])
        assert m["better"] in ("lower", "higher")
        assert reader_path(m["name"]).is_file()
    layers = {}
    for m in B["per_layer"]:
        layers.setdefault(m["name"].split(".")[0], set()).add(m["layer"])
    assert all(len(v) == 1 for v in layers.values())
    for w in B["workloads"]:
        c = cell(B, w["name"])
        reported = {m["name"] for m in c.end_to_end}
        assert "setup_s" in reported and len(reported) >= 2
        assert c.per_layer
        for m in c.per_layer:
            assert m["moves"] in reported
        for m in B["per_layer"]:
            if w["name"] in m.get("workloads", ()):
                assert m["moves"] in reported


def test_cells_are_found_by_name():
    for w in B["workloads"]:
        c = cell(B, w["name"])
        assert c.config["name"] == w["config"] and c.traffic == w["traffic"]
        check = load_module(BENCH / "checks" / f"{c.config['check']}.py")
        assert set(check.EXACT) <= set(c.limits) <= set(check.NUMBERS)
        assert all(c.limits[k] == 0 for k in check.EXACT)
        for m in c.metrics(True) + c.metrics(False):
            assert callable(c.reader(m))
    with pytest.raises(KeyError):
        cell(B, "no-such-cell")


def test_load_module_takes_dotted_names_once():
    a = load_module(BENCH / "metrics" / "mfu.batch.py")
    assert a is load_module(BENCH / "metrics" / "mfu.batch.py")
    assert callable(a.read)


def test_a_split_metric_shares_its_stem_reader():
    assert reader_path("pack_ms.stream") == reader_path("pack_ms.batch") \
        == BENCH / "metrics" / "pack_ms.py"
    assert reader_path("mfu.stream") == BENCH / "metrics" / "mfu.stream.py"
