"""``BENCHMARK.json`` and the files it names.

The harness is driven by data: a cell names a configuration and a traffic
mix, and each is found by its name alone, as ``configs/<name>.json`` and
``traffic/<name>.json`` beside this file; each per-layer metric is read by
``metrics/<name>.py``.  A later change adds a cell or a metric by adding
such files and entries, and edits none that exists.
"""

from __future__ import annotations

import importlib.util
import json
import re
from pathlib import Path

HERE = Path(__file__).resolve().parent
ROOT = HERE.parent
NAME = re.compile(r"^[A-Za-z0-9_][A-Za-z0-9_.\-]{0,63}$")
UNIT = re.compile(r"^[A-Za-z0-9_/%.\-]{1,16}$")


def load_benchmark(path: Path = ROOT / "BENCHMARK.json") -> dict:
    return json.loads(Path(path).read_text())


def cell(bench: dict, name: str) -> dict:
    for w in bench["workloads"]:
        if w["name"] == name:
            return w
    raise SystemExit(f"no workload {name!r} in BENCHMARK.json")


def config_file(name: str) -> Path:
    return HERE / "configs" / f"{name}.json"


def traffic_file(name: str) -> Path:
    return HERE / "traffic" / f"{name}.json"


def metric_file(name: str) -> Path:
    return HERE / "metrics" / f"{name}.py"


def load_config(name: str) -> dict:
    """The configuration's file: ``config`` (the port's SuPerConfig as a
    dict, as it is run), ``source``, ``assumed``, ``reduced`` and
    ``limits`` (the comparison's limit on each number)."""
    return json.loads(config_file(name).read_text())


def load_traffic(name: str) -> dict:
    return json.loads(traffic_file(name).read_text())


def load_metric(name: str):
    """The reader module of a per-layer metric: ``read(stretch) -> float or
    None``."""
    path = metric_file(name)
    spec = importlib.util.spec_from_file_location(f"bench_metric_{name}",
                                                  path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def cell_metrics(bench: dict, workload: str, trace: bool) -> list:
    """The metric entries that ``workload`` reports: the end-to-end ones
    without ``trace``, the per-layer ones with it (an entry with a
    ``workloads`` key only in the cells it lists)."""
    key = "per_layer" if trace else "end_to_end"
    return [m for m in bench[key]
            if workload in m.get("workloads", [workload])]


def check_names(bench: dict) -> list:
    """The names, units and files in ``bench`` that break the benchmark's
    rules of form; empty when all hold."""
    bad = []
    names = [c["name"] for c in bench["configs"]]
    names += [w["name"] for w in bench["workloads"]]
    names += [w[k] for w in bench["workloads"] for k in ("config",
                                                          "traffic")]
    names += [m["name"] for k in ("end_to_end", "per_layer")
              for m in bench[k]]
    names += [r for c in bench["configs"] for r in c["reduced"]]
    bad += [f"name {n!r}" for n in names if not NAME.match(n)]
    bad += [f"unit {m['unit']!r}" for k in ("end_to_end", "per_layer")
            for m in bench[k] if not UNIT.match(m["unit"])]
    for c in bench["configs"]:
        if (ROOT / c["file"]).resolve() != config_file(c["name"]):
            bad.append(f"config {c['name']} is not in "
                       f"{config_file(c['name'])}")
    for w in bench["workloads"]:
        if not traffic_file(w["traffic"]).exists():
            bad.append(f"no traffic file for {w['traffic']}")
    for m in bench["per_layer"]:
        if not metric_file(m["name"]).exists():
            bad.append(f"no reader for {m['name']}")
    return bad
