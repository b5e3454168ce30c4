"""One traced window of a cell with the program's span timeline armed, laid
against the device trace: where the device's idle time goes, by the span
the dispatch thread had open. One JSON line on standard output, last.

    python3 portbench/timeline.py --workload <cell> --seed <n> --seconds <s> [--timeline 0|1]

Set-up and the window are the benchmark's (run.py; no check of the last
pass); --timeline 0 runs the same traced window without the timeline, for
its cost. The line holds the window's reads per second, the program's
phase seconds, its span entries a pass (every timer call; 'ingest' the
group stream's pulls), the timeline's records and bytes, kernel_us_per_read and
stall_encode_pct (the benchmark's readers), retire_gap_ms_p95,
host_span_cpu_pct (and the CPU share of each span name; ingest's pulls
carry no CPU time) and
idle_unattributed_pct (harness/timeline.py), the
device-idle seconds by label and the ten longest idle gaps, labelled, and,
sampled every 5 ms, the dispatch thread's innermost frame in the
checkout's code while no program span was open on it (the unattributed
share's parts); armed, also each stage's 'ingest' intervals against their
pulls' seconds, and what a timer call costs on the host (timer_cost_us).
The benchmark's own runs never run this. It repeats run_cell's set-up and
window loop because run_cell does not arm the timeline yet; once
harness/run_cell.py arms it in the traced window (PERF.md, Open
questions), its readers move there and this tool is deleted."""

from __future__ import annotations

import json
import os
import shutil
import sys
import tempfile
import time

HERE = os.path.dirname(os.path.abspath(__file__))
ROOT = os.path.dirname(HERE)


def record_bytes(records) -> int:
    """The records' own memory: each tuple, its id and path strings and its
    integers (names, stages and thread names are shared)."""
    total = 0
    for r in records:
        total += sys.getsizeof(r) + sys.getsizeof(r.span) + sys.getsizeof(r.path)
        total += sum(sys.getsizeof(v) for v in (r.batch, r.t0_ns, r.t1_ns, r.wall_ns, r.cpu_ns)
                     if v is not None)
    return total


class MainSampler:
    """The main thread's innermost frame in the checkout's code, sampled
    every `period_s` on the wall clock (time.time_ns) by a daemon thread,
    to name what the dispatch thread does while no program span is open."""

    def __init__(self, period_s: float = 0.005):
        import threading

        self.period_s = period_s
        self.samples: list = []
        self._done = threading.Event()
        self._main = threading.main_thread().ident
        self._thread = threading.Thread(target=self._run, daemon=True)

    def _where(self, frame) -> str:
        while frame is not None:
            path = frame.f_code.co_filename
            if path.startswith(ROOT) and path != __file__:
                return f"{os.path.relpath(path, ROOT)}:{frame.f_code.co_name}:{frame.f_lineno}"
            frame = frame.f_back
        return "(outside the checkout)"

    def _run(self):
        while not self._done.wait(self.period_s):
            frame = sys._current_frames().get(self._main)
            self.samples.append((time.time_ns(), self._where(frame)))

    def __enter__(self):
        self._thread.start()
        return self

    def __exit__(self, *exc):
        self._done.set()
        self._thread.join()
        return False


def timer_cost_us(observe, n: int = 100_000) -> dict:
    """Microseconds a call of the program's timers costs on this host,
    against a bare next(): a `timed` span and a group-stream pull
    (`Metrics.pulls`), each with the timeline off and armed."""
    def run(fn, armed):
        import contextlib

        with observe.timeline() if armed else contextlib.nullcontext():
            t0 = time.perf_counter()
            fn()
            return (time.perf_counter() - t0) / n * 1e6

    def bare():
        it = iter(range(n))
        for _ in range(n):
            next(it)

    def spans():
        m, it = observe.Metrics(), iter(range(n))
        for _ in range(n):
            with m.timed("ingest"):
                next(it)

    def pulls():
        p = observe.Metrics().pulls(range(n), "ingest")
        for _ in range(n):
            next(p)
        p.book()

    out = {"bare": run(bare, False)}
    for name, fn in (("timed", spans), ("pull", pulls)):
        out[f"{name}_off"] = run(fn, False)
        out[f"{name}_armed"] = run(fn, True)
    return out


def main(argv=None) -> int:
    import argparse

    p = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    p.add_argument("--workload", required=True)
    p.add_argument("--seed", type=int, required=True)
    p.add_argument("--seconds", type=float, required=True)
    p.add_argument("--timeline", type=int, choices=(0, 1), default=1)
    args = p.parse_args(argv)
    sys.path[:0] = [HERE, ROOT]
    import run as runner

    runner._fixed_caches()
    import contextlib

    import torch

    from bsseqconsensusreads_tpu_torch.utils import observe
    from harness import cells, chain, genome as genome_mod, traffic
    from harness import timeline as htl
    from harness.run_cell import WindowRecord, _accumulate

    if not torch.cuda.is_available():
        print("portbench timeline: no CUDA device", file=sys.stderr)
        return 2
    bench = cells.load_json(os.path.join(ROOT, "BENCHMARK.json"))
    cell = cells.find_cell(bench, args.workload)
    work = tempfile.mkdtemp(prefix="portbench-timeline-")
    try:
        dev = "cuda:0"
        genome = genome_mod.make_genome(torch, cell.config["genome_lengths"], args.seed, dev)
        inp = traffic.make_pass(cell.config, cell.mix, genome, args.seed,
                                os.path.join(work, "input.bam"))
        prog = chain.Chain(cell.config, genome, dev)
        warm = prog.run_pass(inp.path, work, "warm")
        for f in (warm.mid, warm.out):
            os.remove(f)
        torch.cuda.synchronize()
        acc = {"phase_s": {}, "counters": {}, "used_cells": 0, "skipped": 0}
        armed = observe.timeline() if args.timeline else contextlib.nullcontext()
        sampler = MainSampler() if args.timeline else contextlib.nullcontext()
        prof = torch.profiler.profile(activities=[torch.profiler.ProfilerActivity.CUDA])
        passes, last = 0, None
        calls = {"span_calls": 0, "ingest_calls": 0}
        with armed as tl, prof, sampler as samples:
            w0 = time.time_ns()
            t0 = time.monotonic()
            while True:
                res = prog.run_pass(inp.path, work, f"p{passes}")
                passes += 1
                _accumulate(acc, res.stats)
                for st in res.stats.values():
                    calls["span_calls"] += sum(c for _s, c in st.metrics.spans.values())
                    calls["ingest_calls"] += st.metrics.spans.get("ingest", [0, 0])[1]
                if last is not None:
                    os.remove(last.mid)
                    os.remove(last.out)
                last = res
                if time.monotonic() - t0 >= args.seconds:
                    break
            window_s = time.monotonic() - t0
            w1 = time.time_ns()
            torch.cuda.synchronize()
        rec = WindowRecord(window_s, passes, passes * inp.reads, acc["phase_s"], acc["counters"],
                           acc["used_cells"], [], None, {})
        line = {"workload": cell.name, "seed": args.seed, "timeline": args.timeline,
                "card": torch.cuda.get_device_name(0), "passes": passes,
                "window_s": window_s, "window_reads_per_s": rec.reads / window_s,
                "phase_s": acc["phase_s"],
                **{f"{k}_per_pass": v / passes for k, v in calls.items()}}
        for name in ("kernel_us_per_read", "stall_encode_pct"):
            line[name] = cells.metric_reader(name)(rec)
        busy = htl.device_busy_ns(torch, prof)
        gaps = htl.idle_gaps(busy, w0, w1)
        line["device_idle_pct"] = 100.0 * sum(b - a for a, b in gaps) / (w1 - w0)
        if tl is not None:
            t = htl.Timeline(tl.records)
            line.update({
                "records": len(tl.records), "records_per_pass": len(tl.records) / passes,
                "record_bytes": record_bytes(tl.records), "dropped": tl.dropped,
                "retire_gap_ms_p95": t.retire_gap_ms_p95(),
                "host_span_cpu_pct": t.host_span_cpu_pct(),
                "cpu_pct_by_span": t.cpu_pct_by_name(),
                "idle_unattributed_pct": t.idle_unattributed_pct(gaps),
                "idle_s_by_label": t.idle_by_label(gaps),
                "idle_gaps": [[t.label(a, b), (b - a) / 1e9]
                              for a, b in sorted(gaps, key=lambda g: g[0] - g[1])[:10]],
            })
            import collections

            ingest = collections.defaultdict(lambda: [0, 0])
            for r in tl.records:
                if r.name == "ingest":
                    ingest[r.stage][0] += r.t1_ns - r.t0_ns
                    ingest[r.stage][1] += r.wall_ns
            line["ingest_interval_vs_pull_s"] = {k: [a / 1e9, b / 1e9] for k, (a, b) in
                                                 ingest.items()}
            loose = collections.Counter(where for ts, where in samples.samples
                                        if w0 <= ts < w1 and t.unattributed(ts))
            n = sum(loose.values())
            line["unattributed_samples"] = n
            line["unattributed_by_frame"] = [[k, v / n] for k, v in loose.most_common(15)]
        if tl is not None:
            line["timer_cost_us"] = timer_cost_us(observe)
        print(json.dumps(line))
        return 0
    finally:
        shutil.rmtree(work, ignore_errors=True)


if __name__ == "__main__":
    sys.exit(main())
