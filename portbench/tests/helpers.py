"""Tiny cells for the CPU tests: the shipped configurations and mixes,
with the genome and the pass cut to a test's size."""

import json
import os

from harness import cells

BENCH = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
TINY_GENOME = [300_000, 200_000]


def tiny_cell(name: str, families: int, check: int) -> cells.Cell:
    """`name` is a cell of BENCHMARK.json, or `<config>.<mix>` of files
    that no cell names yet (the lowpass mix: PERF.md, Open questions)."""
    bench = cells.load_json(os.path.join(os.path.dirname(BENCH), "BENCHMARK.json"))
    if name not in {w["name"] for w in bench["workloads"]}:
        config, mix = name.split(".", 1)
        bench["workloads"].append({"name": name, "config": config, "traffic": mix, "chips": 1})
    cell = cells.find_cell(bench, name)
    cell.config["genome_lengths"] = TINY_GENOME
    cell.mix["families_per_pass"] = families
    cell.mix["check_families"] = check
    return cell


def load(path: str) -> dict:
    with open(path) as fh:
        return json.load(fh)
