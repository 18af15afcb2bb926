"""``BENCHMARK.json`` against the benchmark contract, and every file a cell
is found by."""

import json
import re

import pytest

from benchmark.harness import spec

BENCH = spec.load_benchmark()
NAME = re.compile(r"^[A-Za-z0-9_][A-Za-z0-9_.-]{0,63}$")
UNIT = re.compile(r"^[A-Za-z0-9_/%.-]{1,16}$")
SOURCES = {"device_trace", "program_span", "program_counter", "host_clock"}
E2E_SOURCES = {"device_trace", "host_clock"}


def _line(s: str) -> bool:
    return 1 <= len(s) <= 200 and "\n" not in s and "\t" not in s


def test_top_level_keys_and_size():
    assert set(BENCH) == {"command", "paths", "run_seconds", "configs",
                          "workloads", "end_to_end", "per_layer"}
    assert len(json.dumps(BENCH)) <= 64 * 1024
    assert isinstance(BENCH["run_seconds"], int)
    assert 1 <= BENCH["run_seconds"] <= 51
    assert 1 <= len(BENCH["command"]) <= 32
    assert all(_line(w) and not w.startswith("/") and ".." not in w
               for w in BENCH["command"])
    assert BENCH["paths"] == ["benchmark"]
    assert (spec.ROOT / BENCH["command"][1]).is_file()


def test_run_seconds_fits_a_check_of_24_cells():
    runs = 2 + 14 * 24
    assert runs * (BENCH["run_seconds"] + 60) + 24 * 2 * 90 + 1200 <= 43200


def test_configs():
    used = {w["config"] for w in BENCH["workloads"]}
    files = set()
    for c in BENCH["configs"]:
        assert set(c) == {"name", "source", "file", "reduced", "why"}
        assert NAME.match(c["name"]) and _line(c["why"])
        assert _line(c["source"]) and c["source"].startswith("https://")
        assert c["file"].startswith("benchmark/configs/")
        assert c["file"] not in files
        files.add(c["file"])
        assert len(c["reduced"]) <= 16
        assert all(NAME.match(k) for k in c["reduced"])
        body = json.loads((spec.ROOT / c["file"]).read_text())
        assert body["name"] == c["name"] and body["source"] == c["source"]
        assert body["reduced"] == c["reduced"]
        assert (spec.BENCH_DIR / "reference"
                / f"{body['generator']}.py").is_file()
        assert c["name"] in used


@pytest.mark.parametrize("cell", [w["name"] for w in BENCH["workloads"]])
def test_cell_is_found_and_well_formed(cell):
    entry = next(w for w in BENCH["workloads"] if w["name"] == cell)
    assert set(entry) == {"name", "config", "traffic", "chips", "why"}
    assert NAME.match(cell) and NAME.match(entry["traffic"])
    assert entry["chips"] == 1 and _line(entry["why"])
    c = spec.find_cell(cell)
    assert (spec.BENCH_DIR / "clients"
            / f"{c.traffic['client']}.py").is_file()
    assert c.traffic["precision"] in ("f32", "bf16", "dd")
    assert c.traffic["control"] != c.traffic["precision"]
    assert c.limits and all(v > 0 for v in c.limits.values())
    body = json.loads((spec.BENCH_DIR / "workloads"
                       / f"{cell}.json").read_text())
    for name, limit in body["limits"].items():
        assert limit["lower"] < limit["limit"] < limit["upper"], name
    assert "setup_s" in {m["name"] for m in c.end_to_end}
    assert len(c.end_to_end) >= 2 and c.per_layer


def test_cells_are_distinct_pairs():
    pairs = [(w["config"], w["traffic"]) for w in BENCH["workloads"]]
    assert len(set(pairs)) == len(pairs)
    names = [w["name"] for w in BENCH["workloads"]]
    assert len(set(names)) == len(names) and 1 <= len(names) <= 24


def test_metrics():
    cells = {w["name"] for w in BENCH["workloads"]}
    names = [m["name"] for m in BENCH["end_to_end"] + BENCH["per_layer"]]
    assert len(set(names)) == len(names)
    e2e = {m["name"]: m for m in BENCH["end_to_end"]}
    assert "setup_s" in e2e and e2e["setup_s"]["bound"] <= 0.25
    for m in BENCH["end_to_end"]:
        assert set(m) <= {"name", "unit", "better", "bound", "source",
                          "workloads"}
        assert m["source"] in E2E_SOURCES
        assert 0.01 <= m["bound"] <= 0.25
    for m in BENCH["per_layer"]:
        assert set(m) <= {"name", "unit", "better", "source", "layer",
                          "moves", "workloads"}
        assert m["source"] in SOURCES and _line(m["layer"])
        assert m["moves"] in e2e
        for w in m.get("workloads", ()):
            reported = e2e[m["moves"]].get("workloads", cells)
            assert w in reported, (m["name"], w)
    for m in BENCH["end_to_end"] + BENCH["per_layer"]:
        assert NAME.match(m["name"]) and UNIT.match(m["unit"])
        assert m["better"] in ("lower", "higher")
        assert set(m.get("workloads", cells)) <= cells
        assert spec.reader_path(m["name"]).is_file(), m["name"]


def test_roofline_metrics_are_named_as_such():
    for m in BENCH["per_layer"]:
        if "roofline" in m["name"]:
            assert m["name"].endswith("_roofline") and m["unit"] == "%"
            assert m["source"] == "device_trace"


def test_every_cell_reports_an_end_to_end_and_a_per_layer_metric():
    for w in BENCH["workloads"]:
        c = spec.find_cell(w["name"])
        assert [m for m in c.end_to_end if m["name"] != "setup_s"]
        assert c.per_layer


def test_unknown_cell_raises():
    with pytest.raises(KeyError):
        spec.find_cell("no_such.cell")
