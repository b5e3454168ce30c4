"""Finding a cell's parts by name: BENCHMARK.json at the checkout's root,
configs/<config>.json, traffic/<mix>.json, limits/<cell>.json and one
reader module metrics/<metric>.py per per-layer metric. A later cell,
configuration, mix or metric is a new file and a new entry; nothing here
changes for it."""

from __future__ import annotations

import dataclasses
import importlib.util
import json
import os

BENCH_DIR = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


@dataclasses.dataclass
class Cell:
    name: str
    chips: int
    config: dict
    mix: dict
    limits: dict
    end_to_end: list  # the BENCHMARK.json entries this cell reports
    per_layer: list


def load_json(path: str) -> dict:
    with open(path) as fh:
        return json.load(fh)


def find_cell(bench: dict, name: str, root: str = BENCH_DIR) -> Cell:
    """The cell `name` of the parsed BENCHMARK.json, with its files."""
    cells = {w["name"]: w for w in bench["workloads"]}
    if name not in cells:
        raise KeyError(f"no workload {name!r} in BENCHMARK.json ({sorted(cells)})")
    w = cells[name]
    conf = {c["name"]: c for c in bench["configs"]}[w["config"]]
    repo = os.path.dirname(root)
    config = load_json(os.path.join(repo, conf["file"]))
    mix = load_json(os.path.join(root, "traffic", f"{w['traffic']}.json"))
    limits = load_json(os.path.join(root, "limits", f"{name}.json"))

    def applies(m):
        return name in m.get("workloads", [name])

    return Cell(name, int(w["chips"]), config, mix, limits,
                [m for m in bench["end_to_end"] if applies(m)],
                [m for m in bench["per_layer"] if applies(m)])


def metric_reader(name: str, root: str = BENCH_DIR):
    """The `read(window) -> float | None` of metrics/<name>.py."""
    path = os.path.join(root, "metrics", f"{name}.py")
    spec = importlib.util.spec_from_file_location(f"portbench_metric_{name.replace('.', '_')}",
                                                  path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod.read
