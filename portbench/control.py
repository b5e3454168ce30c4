"""Readings behind a cell's limits: for each seed, one pass of the program
at the cell's own size (the window's entry, on the card) checked against
the reference, and the control — the reference computed in bfloat16 put
in the program's place — checked the same way. One JSON line per seed.

    python3 portbench/control.py --workload <cell> --seeds 1,2,3

The benchmark's own runs never run this; the limits in
portbench/limits/<cell>.json were set from its readings (PERF.md)."""

from __future__ import annotations

import json
import os
import shutil
import sys
import tempfile
import time

HERE = os.path.dirname(os.path.abspath(__file__))
ROOT = os.path.dirname(HERE)


def main(argv=None) -> int:
    import argparse

    p = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    p.add_argument("--workload", required=True)
    p.add_argument("--seeds", required=True)
    args = p.parse_args(argv)
    sys.path[:0] = [HERE, ROOT]
    import run as runner

    runner._fixed_caches()
    import torch

    from harness import cells, chain, check, genome as genome_mod, traffic

    bench = cells.load_json(os.path.join(ROOT, "BENCHMARK.json"))
    cell = cells.find_cell(bench, args.workload)
    dev = "cuda:0"
    for seed in (int(s) for s in args.seeds.split(",")):
        work = tempfile.mkdtemp(prefix="portbench-control-")
        try:
            t0 = time.monotonic()
            genome = genome_mod.make_genome(torch, cell.config["genome_lengths"], seed, dev)
            inp = traffic.make_pass(cell.config, cell.mix, genome, seed,
                                    os.path.join(work, "input.bam"),
                                    sample=int(cell.mix["check_families"]))
            prog = chain.Chain(cell.config, genome, dev)
            res = prog.run_pass(inp.path, work, "p")
            del prog
            t1 = time.monotonic()
            line = {"workload": cell.name, "seed": seed,
                    "program": check.check_pass(inp, res, genome, cell.config),
                    "reference_s": time.monotonic() - t1}
            t2 = time.monotonic()
            line["control"] = check.control_numbers(inp, genome, cell.config)
            line["control_s"] = time.monotonic() - t2
            line["seconds"] = time.monotonic() - t0
            print(json.dumps(line), flush=True)
        finally:
            shutil.rmtree(work, ignore_errors=True)
            torch.cuda.empty_cache()
    return 0


if __name__ == "__main__":
    sys.exit(main())
