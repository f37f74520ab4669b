"""BENCHMARK.json against the rules its driver checks before any run."""

import json
import re

import pytest

from port_bench.lib.cell import BENCH_DIR

ROOT = BENCH_DIR.parent
BENCH = json.loads((ROOT / "BENCHMARK.json").read_text())
NAME = re.compile(r"^[A-Za-z0-9_][A-Za-z0-9_.\-]{0,63}$")
UNIT = re.compile(r"^[A-Za-z0-9_/%.\-]{1,16}$")
KEYS = {
    "configs": {"name", "source", "file", "reduced", "why"},
    "workloads": {"name", "config", "traffic", "chips", "why"},
    "end_to_end": {"name", "unit", "better", "bound", "source"},
    "per_layer": {"name", "unit", "better", "source", "layer", "moves"},
}


def line_ok(text):
    return 1 <= len(text) <= 200 and "\n" not in text and "\t" not in text


def test_top_level():
    assert set(BENCH) == {"command", "paths", "run_seconds", "configs", "workloads",
                          "end_to_end", "per_layer"}
    assert BENCH["paths"] == ["port_bench"] and BENCH["command"][1] == "port_bench/run.py"
    assert len(json.dumps(BENCH)) <= 64 * 1024
    rs = BENCH["run_seconds"]
    assert isinstance(rs, int) and 1 <= rs <= 51
    # a full check of 24 cells fits: 2 + 14 cells runs, each run_seconds + 60,
    # 180 s a cell to compile, 1200 s spare
    assert (2 + 14 * 24) * (rs + 60) + 24 * 180 + 1200 <= 43200


@pytest.mark.parametrize("section", list(KEYS))
def test_entries(section):
    names = [e["name"] for e in BENCH[section]]
    assert len(names) == len(set(names))
    for e in BENCH[section]:
        extra = {"workloads"} if section in ("end_to_end", "per_layer") else set()
        assert KEYS[section] <= set(e) <= KEYS[section] | extra, e
        assert NAME.match(e["name"]), e["name"]
        for k in ("why", "layer", "source"):
            if k in e:
                assert line_ok(e[k]), e
        if "unit" in e:
            assert UNIT.match(e["unit"]) and e["better"] in ("lower", "higher")


def test_cells_and_metrics_agree():
    configs = {c["name"]: c for c in BENCH["configs"]}
    cells = {w["name"]: w for w in BENCH["workloads"]}
    assert {w["config"] for w in cells.values()} == set(configs)
    assert len({(w["config"], w["traffic"]) for w in cells.values()}) == len(cells)
    assert all(w["chips"] == 1 for w in cells.values())
    for c in configs.values():
        model = json.loads((ROOT / c["file"]).read_text())
        assert model["reduced"] == c["reduced"] == []
        assert c["source"].startswith("https://")
    e2e = {m["name"]: m for m in BENCH["end_to_end"]}
    assert e2e["setup_s"]["bound"] <= 0.25 and "workloads" not in e2e["setup_s"]
    for m in e2e.values():
        assert 0.01 <= m["bound"] <= 0.25 and m["source"] in ("host_clock", "device_trace")
    for name in cells:
        reported = [m for m in e2e.values() if name in m.get("workloads", [name])]
        assert len(reported) >= 2, name
        assert any(name in m["workloads"] for m in BENCH["per_layer"]), name
    layers = {}
    for m in BENCH["per_layer"]:
        assert m["moves"] in e2e and set(m["workloads"]) <= set(cells)
        # every cell listed reports the metric the layer metric moves
        assert set(m["workloads"]) <= set(e2e[m["moves"]].get("workloads", cells))
        if m["unit"] == "%" and ("roofline" in m["name"] or "mfu" in m["name"]):
            assert m["better"] == "higher"
        layers.setdefault(m["name"].split(".")[0], set()).add(m["layer"])
    assert all(len(v) == 1 for v in layers.values())
