"""One run of one cell: set-up, the measured window, the readings, and
the check of the last pass against the plain reference."""

from __future__ import annotations

import dataclasses
import os
import shutil
import tempfile
import time

from harness import cells, chain, check, genome as genome_mod, traffic
from harness import trace as tr


@dataclasses.dataclass
class WindowRecord:
    """What the per-layer readers read: the window's work and time, the
    program's spans and counters summed over both stages and every pass,
    the harness's batch gaps, and the device trace (None untraced)."""

    seconds: float
    passes: int
    reads: int
    phase_s: dict
    counters: dict
    used_cells: int
    gaps_s: list
    device: dict | None
    launches: dict  # the program's kernel launches and seg_vote calls by route


def _accumulate(acc: dict, stats) -> None:
    for st in stats.values():
        for k, v in st.metrics.seconds.items():
            acc["phase_s"][k] = acc["phase_s"].get(k, 0.0) + v
        for k, v in st.metrics.counters.items():
            acc["counters"][k] = acc["counters"].get(k, 0) + v
        acc["used_cells"] += st.used_cells
        acc["skipped"] += st.skipped_families + st.leftover_records


def card(torch, device: str, chips: int) -> dict:
    if device == "cpu":
        return {"platform": "cpu", "kind": "cpu", "count": 0, "memory_peak_bytes": 0}
    return {"platform": "gpu", "kind": torch.cuda.get_device_name(0), "count": chips,
            "memory_peak_bytes": int(torch.cuda.max_memory_allocated())}


def run_cell(torch, cell: cells.Cell, seed: int, seconds: float, traced: bool, device: str,
             t_process: float):
    """(result dict, checks) of one run; see portbench/run.py."""
    cfg, mix = cell.config, cell.mix
    work = tempfile.mkdtemp(prefix="portbench-")
    try:
        gen_device = "cuda:0" if device == "cuda" else device
        genome = genome_mod.make_genome(torch, cfg["genome_lengths"], seed, gen_device)
        inp = traffic.make_pass(cfg, mix, genome, seed, os.path.join(work, "input.bam"),
                                sample=int(mix["check_families"]))
        prog = chain.Chain(cfg, genome, gen_device)
        warm = prog.run_pass(inp.path, work, "warm")
        for p in (warm.mid, warm.out):
            os.remove(p)
        if device == "cuda":
            torch.cuda.synchronize()
        acc = {"phase_s": {}, "counters": {}, "used_cells": 0, "skipped": 0}
        gaps: list = []
        spans: list = []
        chain.reset_launch_counts()
        prof = None
        if traced and device == "cuda":
            prof = torch.profiler.profile(activities=[torch.profiler.ProfilerActivity.CUDA])
        passes = 0
        pass_s: list = []
        last = None
        with tr.PeakMemory() as peak:
            if prof is not None:
                prof.__enter__()
            t0 = time.monotonic()
            while True:
                tp = time.monotonic()
                res = prog.run_pass(inp.path, work, f"p{passes}")
                pass_s.append(time.monotonic() - tp)
                passes += 1
                _accumulate(acc, res.stats)
                gaps.extend(res.gaps_s)
                spans.extend(res.stage_spans)
                if last is not None:
                    os.remove(last.mid)
                    os.remove(last.out)
                last = res
                if time.monotonic() - t0 >= seconds:
                    break
            t1 = time.monotonic()
            if prof is not None:
                torch.cuda.synchronize()
                prof.__exit__(None, None, None)
        window_s = t1 - t0
        print(f"portbench: window {passes} passes, {passes * inp.reads} input reads, "
              f"{window_s!r} s, {passes * inp.reads / window_s!r} reads/s", flush=True)
        dev = card(torch, device, cell.chips)
        device_summary = None
        launches = chain.vote_launch_counts()
        if prof is not None:
            def label_at(t):
                at = t0 + t
                for stage, a, b in spans:
                    if a <= at < b:
                        return stage
                return "between passes"

            device_summary = tr.summarize(tr.device_events(torch, prof), window_s, label_at)
            device_summary["window_s"] = window_s
            del prof
        rec = WindowRecord(window_s, passes, passes * inp.reads, acc["phase_s"], acc["counters"],
                           acc["used_cells"], gaps, device_summary, launches)
        del prog
        if device == "cuda":
            torch.cuda.empty_cache()
        numbers = check.check_pass(inp, last, genome, cfg)
        checks = {k: {"value": v, "limit": cell.limits[k]} for k, v in numbers.items()}
        correct = all(v <= cell.limits[k] for k, v in numbers.items())
        metrics = {}
        if not traced:
            values = {"setup_s": t0 - t_process,
                      "input_reads_per_s": rec.reads / window_s,
                      "peak_host_rss_gib": peak.host_gib}
            for m in cell.end_to_end:
                metrics[m["name"]] = {"value": values[m["name"]], "unit": m["unit"]}
        else:
            for m in cell.per_layer:
                v = cells.metric_reader(m["name"])(rec)
                if v is not None:
                    metrics[m["name"]] = {"value": v, "unit": m["unit"]}
            print(f"portbench: launches {launches}", flush=True)
            print(f"portbench: phase seconds {acc['phase_s']}", flush=True)
        if device_summary is not None:
            dev["busy_s"] = device_summary["busy_s"]
            dev["window_s"] = window_s
        result = {"correct": bool(correct), "attempted": passes * inp.families,
                  "failed": int(acc["skipped"]), "metrics": metrics, "device": dev}
        if device_summary is not None:
            result["breakdown"] = {"device_ops": device_summary["device_ops"],
                                   "idle_gaps": device_summary["idle_gaps"]}
        result["passes_s"] = pass_s
        result["checks"] = checks
        return result, checks
    finally:
        shutil.rmtree(work, ignore_errors=True)
