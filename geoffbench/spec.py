"""``BENCHMARK.json`` and the files it names. A cell, configuration,
traffic mix or per-layer metric is found by its name alone, so a later
change adds one by adding its files and its entry, and edits none."""
from __future__ import annotations

import importlib.util
import json
import re
from pathlib import Path

HERE = Path(__file__).resolve().parent
ROOT = HERE.parent


def load_benchmark() -> dict:
    path = ROOT / "BENCHMARK.json"
    if not path.is_file():
        raise FileNotFoundError(f"no BENCHMARK.json at {ROOT}")
    return json.loads(path.read_text())


def _named(entries: list, name: str, what: str) -> dict:
    for e in entries:
        if e["name"] == name:
            return e
    raise KeyError(f"no {what} named {name!r}; have {[e['name'] for e in entries]}")


def workload(bench: dict, name: str) -> dict:
    return _named(bench["workloads"], name, "workload")


def config(bench: dict, name: str) -> dict:
    """The configuration's file: published keys, ``port`` (the sizes as
    the program runs them) and the notes beside them."""
    entry = _named(bench["configs"], name, "config")
    return json.loads((ROOT / entry["file"]).read_text())


def traffic(name: str) -> dict:
    return json.loads((HERE / "traffic" / f"{name}.json").read_text())


def limits(workload_name: str) -> dict:
    """{number: {"limit": x, ...}} that ``correct`` is judged by."""
    return json.loads((HERE / "limits" / f"{workload_name}.json").read_text())


def metrics(bench: dict, workload_name: str, kind: str) -> list:
    """The ``end_to_end`` or ``per_layer`` entries the cell reports: those
    without ``workloads`` and those that list it."""
    return [m for m in bench[kind]
            if "workloads" not in m or workload_name in m["workloads"]]


def reader(metric_name: str):
    """``metrics/<name>.py``'s ``read(run)``: the metric's value, or None
    where the run holds nothing for it to read."""
    path = HERE / "metrics" / f"{metric_name}.py"
    mod_name = "geoffbench_metric_" + re.sub(r"\W", "_", metric_name)
    spec = importlib.util.spec_from_file_location(mod_name, path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod.read


def patterns(group: str) -> list:
    """Every regular expression in ``metrics/patterns/<group>/*.txt``, one a
    line (``#`` starts a comment): the kernel names of one kind of work,
    whatever implements it."""
    out = []
    for f in sorted((HERE / "metrics" / "patterns" / group).glob("*.txt")):
        for line in f.read_text().splitlines():
            line = line.split("#", 1)[0].strip()
            if line:
                out.append(re.compile(line))
    return out
