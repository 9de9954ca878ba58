"""``BENCHMARK.json`` and the files it names. A cell, configuration,
model module, traffic mix or per-layer metric is found by its name alone,
so a later change adds one by adding its files and its entry, and edits
none."""
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


def _load(path: Path, prefix: str):
    mod_name = prefix + re.sub(r"\W", "_", path.stem)
    spec = importlib.util.spec_from_file_location(mod_name, path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def reader(metric_name: str):
    """``metrics/<name>.py``'s ``read(run)``: the metric's value, or None
    where the run holds nothing for it to read."""
    return _load(HERE / "metrics" / f"{metric_name}.py", "geoffbench_metric_").read


def model(conf: dict):
    """The configuration's model module, ``models/<conf["model"]>.py``
    (``dense`` where the file names none): its weight layout, plain
    reference, operation counts and kernel bounds (``models/__init__.py``)."""
    name = conf.get("model", "dense")
    path = HERE / "models" / f"{name}.py"
    if not path.is_file():
        have = sorted(p.stem for p in (HERE / "models").glob("*.py")
                      if p.stem != "__init__")
        raise KeyError(f"no model module named {name!r}; have {have}")
    return _load(path, "geoffbench_model_")


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
