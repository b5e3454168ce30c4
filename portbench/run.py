"""The port's benchmark: one cell, one run.

    python3 portbench/run.py --workload <cell> --seed <n> --seconds <s> --trace <0|1>

from the root of a checkout. Set-up makes the cell's genome and one
pass's grouped BAM from the seed, uploads the genome and runs one warm
pass; the window then runs passes of the program's molecular -> duplex
chain back to back (a closed loop) until the first pass boundary past
--seconds. The last line of standard output is the result: the cell's
end-to-end metrics (--trace 0) or its per-layer metrics read from the
program's spans and counters and a profiler trace held in memory
(--trace 1), and `correct`, the last pass's records against the plain
reference in portbench/reference for a sample of its families.

Exits non-zero, printing no result, without CUDA or with fewer cards than
the cell asks for, or when JAX or the JAX package is loaded.
"""

from __future__ import annotations

import os
import sys
import time


def _process_start() -> float:
    """time.monotonic() at which this process started (/proc clocks)."""
    with open("/proc/self/stat") as fh:
        start_ticks = int(fh.read().rsplit(")", 1)[1].split()[19])
    with open("/proc/uptime") as fh:
        uptime = float(fh.read().split()[0])
    return time.monotonic() - (uptime - start_ticks / os.sysconf("SC_CLK_TCK"))


T_PROCESS = _process_start()
HERE = os.path.dirname(os.path.abspath(__file__))
ROOT = os.path.dirname(HERE)
FORBIDDEN = ("jax", "jaxlib", "flax", "bsseqconsensusreads_tpu")
PORT = "bsseqconsensusreads_tpu_torch"


def _fixed_caches() -> None:
    """Every build and kernel cache at a fixed path inside the checkout."""
    build = os.path.join(ROOT, "build")
    os.environ["BSSEQ_TPU_COMPILE_CACHE_DIR"] = os.path.join(build, "torch_kernels")
    os.environ["TORCH_EXTENSIONS_DIR"] = os.path.join(build, "portbench", "torch_extensions")
    os.environ["TRITON_CACHE_DIR"] = os.path.join(build, "portbench", "triton")
    os.environ["USE_FLAX"] = "0"
    for var in ("BSSEQ_TPU_STATS", "BSSEQ_TPU_TRACE", "BSSEQ_TPU_FAILPOINTS"):
        os.environ.pop(var, None)


def parse(argv):
    import argparse

    p = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    p.add_argument("--workload", required=True)
    p.add_argument("--seed", type=int, required=True)
    p.add_argument("--seconds", type=float, required=True)
    p.add_argument("--trace", type=int, choices=(0, 1), default=0)
    return p.parse_args(argv)


def loaded_forbidden() -> list:
    tops = {name.split(".", 1)[0] for name in list(sys.modules)}
    return sorted(tops & set(FORBIDDEN))


def main(argv=None) -> int:
    args = parse(argv)
    _fixed_caches()
    sys.path[:0] = [HERE, ROOT]
    import torch

    from harness import cells
    from harness.run_cell import run_cell

    bench_path = os.path.join(ROOT, "BENCHMARK.json")
    bench = cells.load_json(bench_path)
    cell = cells.find_cell(bench, args.workload)
    if not torch.cuda.is_available() or torch.cuda.device_count() < cell.chips:
        n = torch.cuda.device_count() if torch.cuda.is_available() else 0
        print(f"portbench: the cell needs {cell.chips} CUDA device(s), found {n}", file=sys.stderr)
        return 2
    try:
        __import__(PORT)
    except ImportError as exc:
        print(f"portbench: the program under test ({PORT}) is not importable: {exc}",
              file=sys.stderr)
        return 2
    result, checks = run_cell(torch, cell, args.seed, args.seconds, bool(args.trace), "cuda",
                              T_PROCESS)
    found = loaded_forbidden()
    if found:
        print(f"portbench: loaded in this process: {', '.join(found)}", file=sys.stderr)
        return 3
    import json

    for name, c in checks.items():
        print(f"check {name} = {c['value']!r} (limit {c['limit']!r})", file=sys.stderr)
    print(json.dumps(result))
    return 0


if __name__ == "__main__":
    sys.exit(main())
