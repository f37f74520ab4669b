"""Finding a cell's files by the names in ``BENCHMARK.json``.

A cell ``<config>.<traffic>`` reads ``BENCHMARK.json``'s entry of that
name, the configuration file the entry's ``config`` names, the traffic mix
``port_bench/mixes/<traffic>.json`` and the driver the mix names,
``port_bench/entries/<entry>.py``.  A per-layer metric ``<name>`` is read by
``port_bench/layer_metrics/<name>.py``.  Adding a configuration, a mix or a
metric adds files and entries; no file here changes.
"""

from __future__ import annotations

import dataclasses
import importlib.util
import json
import typing as tp
from pathlib import Path

BENCH_DIR = Path(__file__).resolve().parents[1]
ROOT = BENCH_DIR.parent


@dataclasses.dataclass
class Cell:
    """One workload: its entry in ``BENCHMARK.json``, the configuration's
    sizes, the mix's parameters and the metrics it reports."""

    name: str
    model: dict
    mix: dict
    end_to_end: tp.List[dict]
    per_layer: tp.List[dict]
    chips: int

    @property
    def dims(self) -> tp.Tuple[int, int, int, int]:
        m = self.model
        return (m["input_size"], m["hidden_size"], m["hidden2_size"], m["output_size"])


def load_module(path: Path, name: str):
    """The module in the file ``path``, loaded under ``name``."""
    spec = importlib.util.spec_from_file_location(name, path)
    if spec is None or spec.loader is None:
        raise FileNotFoundError(path)
    module = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(module)
    return module


def _reports(metric: dict, cell: str) -> bool:
    return "workloads" not in metric or cell in metric["workloads"]


def load_cell(name: str, root: Path = ROOT) -> Cell:
    """The cell ``name`` of ``<root>/BENCHMARK.json``."""
    bench = json.loads((root / "BENCHMARK.json").read_text())
    work = {w["name"]: w for w in bench["workloads"]}
    if name not in work:
        raise KeyError(f"no workload {name!r} in BENCHMARK.json")
    w = work[name]
    configs = {c["name"]: c for c in bench["configs"]}
    model = json.loads((root / configs[w["config"]]["file"]).read_text())
    mix = json.loads((root / "port_bench" / "mixes" / f"{w['traffic']}.json").read_text())
    return Cell(
        name=name, model=model, mix=mix, chips=int(w["chips"]),
        end_to_end=[m for m in bench["end_to_end"] if _reports(m, name)],
        per_layer=[m for m in bench["per_layer"] if _reports(m, name)],
    )


def entry_module(cell: Cell, root: Path = ROOT):
    """The driver of the cell's mix: ``port_bench/entries/<entry>.py``."""
    entry = cell.mix["entry"]
    return load_module(root / "port_bench" / "entries" / f"{entry}.py",
                       f"port_bench_entry_{entry}")


def metric_reader(name: str, root: Path = ROOT):
    """The reader of the per-layer metric ``name``, or None without a file."""
    path = root / "port_bench" / "layer_metrics" / f"{name}.py"
    if not path.is_file():
        return None
    return load_module(path, "port_bench_metric_" + name.replace(".", "_"))
