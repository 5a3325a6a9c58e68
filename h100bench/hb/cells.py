"""Cells, configurations, traffic mixes and metric readers, found by name.

``BENCHMARK.json`` at the checkout's root lists the cells. A cell
``<config>.<traffic>`` joins the configuration's file (the ``file`` of its
entry) and ``h100bench/traffic/<traffic>.json``. A metric named ``m`` is
read by ``h100bench/metrics/<m>.py``. Adding a cell, a mix or a metric
adds files and entries and edits none.
"""

from __future__ import annotations

import dataclasses
import importlib
import importlib.util
import json
import re
from pathlib import Path

BENCH_DIR = Path(__file__).resolve().parents[1]
ROOT = BENCH_DIR.parent

NAME_RE = re.compile(r"^[A-Za-z0-9_][A-Za-z0-9_.\-]{0,63}$")
UNIT_RE = re.compile(r"^[A-Za-z0-9_/%.\-]{1,16}$")
SOURCES = ("device_trace", "program_span", "program_counter", "host_clock")


class CellError(ValueError):
    """A cell, file or metric that does not meet the benchmark's rules."""


def check_name(name: str, what: str) -> str:
    if not isinstance(name, str) or not NAME_RE.match(name):
        raise CellError(f"bad {what} name: {name!r}")
    return name


def check_metric(entry: dict, kind: str) -> dict:
    check_name(entry.get("name"), f"{kind} metric")
    unit = entry.get("unit")
    if not isinstance(unit, str) or not UNIT_RE.match(unit):
        raise CellError(f"bad unit of {entry['name']}: {unit!r}")
    if entry.get("better") not in ("lower", "higher"):
        raise CellError(f"bad 'better' of {entry['name']}")
    if entry.get("source") not in SOURCES:
        raise CellError(f"bad source of {entry['name']}")
    if kind == "end_to_end" and entry["source"] not in ("host_clock",
                                                        "device_trace"):
        raise CellError(f"end-to-end {entry['name']} from the program")
    return entry


@dataclasses.dataclass
class Cell:
    name: str
    chips: int
    config: dict
    traffic: dict
    end_to_end: list
    per_layer: list

    def argv(self, seed: int, seconds: float) -> list[str]:
        """The renderer's command line for this cell: the canvas, the band,
        each file's ``flags``, the seed and the time box."""
        cv, band = self.config["canvas"], self.traffic["band"]
        argv = ["-w", str(cv["width"]), "-h", str(cv["height"]),
                "--min-real", repr(float(cv["min_real"])),
                "--max-real", repr(float(cv["max_real"])),
                "--min-imag", repr(float(cv["min_imag"])),
                "--max-imag", repr(float(cv["max_imag"])),
                "-m", str(band["max_escape"]), "-c", str(band["min_escape"])]
        for flags in (self.config.get("flags", {}),
                      self.traffic.get("flags", {})):
            for k, v in flags.items():
                argv += [k, str(v)]
        return argv + ["--seed", str(int(seed)), "-t", repr(float(seconds))]


def load_benchmark(root: Path = ROOT) -> dict:
    path = root / "BENCHMARK.json"
    if not path.is_file():
        raise CellError(f"{path} is missing")
    bench = json.loads(path.read_text())
    for kind in ("end_to_end", "per_layer"):
        for entry in bench[kind]:
            check_metric(entry, kind)
    for w in bench["workloads"]:
        check_name(w["name"], "cell")
        check_name(w["config"], "config")
        check_name(w["traffic"], "traffic")
    return bench


def _applies(metric: dict, cell: str) -> bool:
    return "workloads" not in metric or cell in metric["workloads"]


def load_cell(name: str, root: Path = ROOT) -> Cell:
    bench = load_benchmark(root)
    entry = next((w for w in bench["workloads"] if w["name"] == name), None)
    if entry is None:
        raise CellError(f"no cell named {name!r} in BENCHMARK.json")
    conf = next((c for c in bench["configs"]
                 if c["name"] == entry["config"]), None)
    if conf is None:
        raise CellError(f"cell {name}: no configuration {entry['config']}")
    config = json.loads((root / conf["file"]).read_text())
    traffic_path = BENCH_DIR / "traffic" / f"{entry['traffic']}.json"
    if not traffic_path.is_file():
        raise CellError(f"cell {name}: no traffic file {traffic_path.name}")
    traffic = json.loads(traffic_path.read_text())
    e2e = [m for m in bench["end_to_end"] if _applies(m, name)]
    e2e_names = {m["name"] for m in e2e}
    layers = [m for m in bench["per_layer"]
              if _applies(m, name) and m.get("moves") in e2e_names]
    return Cell(name=name, chips=int(entry["chips"]), config=config,
                traffic=traffic, end_to_end=e2e, per_layer=layers)


def reader(metric: str):
    """The ``read`` function of ``h100bench/metrics/<metric>.py``."""
    check_name(metric, "metric")
    path = BENCH_DIR / "metrics" / f"{metric}.py"
    if not path.is_file():
        raise CellError(f"no reader for metric {metric}: {path.name}")
    spec = importlib.util.spec_from_file_location(
        "h100bench_metric_" + metric.replace(".", "_").replace("-", "_"),
        path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod.read


def reference(config: dict):
    """The plain reference module the configuration names."""
    name = check_name(config["reference"], "reference")
    return importlib.import_module(f"reference.{name}")
