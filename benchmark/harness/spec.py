"""``BENCHMARK.json`` and the files each cell is found by."""

from __future__ import annotations

import json
from dataclasses import dataclass
from pathlib import Path

BENCH_DIR = Path(__file__).resolve().parent.parent
ROOT = BENCH_DIR.parent


def load_benchmark() -> dict:
    return json.loads((ROOT / "BENCHMARK.json").read_text())


def _json(path: Path) -> dict:
    return json.loads(path.read_text())


@dataclass
class Cell:
    """One entry of ``workloads`` with its configuration, traffic mix and
    limits read from their files, and the metrics it reports."""

    name: str
    entry: dict
    config: dict       # configs/<config>.json
    traffic: dict      # traffic/<traffic>.json
    limits: dict       # workloads/<cell>.json "limits": name -> limit
    end_to_end: list   # BENCHMARK.json metric entries this cell reports
    per_layer: list

    @property
    def chips(self) -> int:
        return int(self.entry["chips"])


def _reports(metric: dict, cell: str) -> bool:
    return cell in metric.get("workloads", (cell,))


def find_cell(name: str) -> Cell:
    """The cell ``name`` of ``BENCHMARK.json``; raises KeyError when the
    file has no such cell."""
    bench = load_benchmark()
    entries = {w["name"]: w for w in bench["workloads"]}
    if name not in entries:
        raise KeyError(f"no cell {name!r} in BENCHMARK.json: "
                       f"{sorted(entries)}")
    entry = entries[name]
    configs = {c["name"]: c for c in bench["configs"]}
    config = _json(ROOT / configs[entry["config"]]["file"])
    traffic = _json(BENCH_DIR / "traffic" / f"{entry['traffic']}.json")
    limits = _json(BENCH_DIR / "workloads" / f"{name}.json")["limits"]
    e2e = [m for m in bench["end_to_end"] if _reports(m, name)]
    reported = {m["name"] for m in e2e}
    per_layer = [m for m in bench["per_layer"]
                 if (name in m["workloads"] if "workloads" in m
                     else m["moves"] in reported)]
    return Cell(name, entry, config, traffic,
                {k: float(v["limit"]) for k, v in limits.items()}, e2e,
                per_layer)


def reader_path(metric: str) -> Path:
    """The reader of metric ``metric``: ``metrics/<name>.py``, or
    the reader of the part before its first dot (``idle_pct.solve`` ->
    ``metrics/idle_pct.py``)."""
    exact = BENCH_DIR / "metrics" / f"{metric}.py"
    if exact.exists():
        return exact
    return BENCH_DIR / "metrics" / f"{metric.split('.', 1)[0]}.py"
