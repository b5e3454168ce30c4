"""The program's span timeline laid against the device trace.

The program (utils.observe.timeline) keeps, while armed, each span's
interval on time.time_ns(), its thread, batch, parent and thread CPU time
(TimelineSpan). torch.profiler stamps its events on the same clock: an
event's absolute time is the trace's trace_start_ns() plus its
time_range (microseconds). Here, on those records and the device's busy
intervals (nanoseconds):

* idle gaps named by what the host did: the running stage, the span
  path the dispatch thread had innermost for most of the gap, and for a
  'stall.batch' the awaited batch's worker span (`duplex/stall.batch<-rawize`);
* retire_gap_ms_p95, host_span_cpu_pct and idle_unattributed_pct.

The dispatch threads are the threads that close 'batch' records."""

from __future__ import annotations

import bisect
import statistics

#: outermost spans that are waits, not host work (host_span_cpu_pct)
WAITS = frozenset({"stall", "device_wait", "idle"})
NO_SPAN = "(no span)"


def device_busy_ns(torch, prof) -> list:
    """Merged [start, end) nanosecond intervals of a profiler run's device
    events, on time.time_ns()."""
    from harness.trace import union

    base = prof.profiler.kineto_results.trace_start_ns()
    return union((base + int(e.time_range.start * 1e3), base + int(e.time_range.end * 1e3))
                 for e in prof.events() if e.device_type == torch.autograd.DeviceType.CUDA)


def idle_gaps(busy, t0: int, t1: int) -> list:
    """The [a, b) stretches of [t0, t1) outside the merged `busy`."""
    out, at = [], t0
    for s, e in busy:
        if s > at:
            out.append((at, min(s, t1)))
        at = max(at, e)
        if at >= t1:
            break
    if at < t1:
        out.append((at, t1))
    return [(a, b) for a, b in out if b > a]


def _short(path: str) -> str:
    """'stall/stall.batch' -> 'stall.batch': a dotted part names its parent."""
    parts = path.split("/")
    keep = [p for i, p in enumerate(parts)
            if not (i + 1 < len(parts) and parts[i + 1].startswith(p + "."))]
    return "/".join(keep)


def _segments(spans) -> list:
    """One thread's spans (well nested) as disjoint (start, end, span)
    pieces, each naming the innermost span open over it."""
    out: list = []
    stack: list = []  # (end, span)
    at = None
    for r in sorted(spans, key=lambda r: (r.t0_ns, -r.t1_ns, r.path.count("/"))):
        while stack and stack[-1][0] <= r.t0_ns:
            end, top = stack.pop()
            if end > at:
                out.append((at, end, top))
            at = end
        if stack and r.t0_ns > at:
            out.append((at, r.t0_ns, stack[-1][1]))
        at = r.t0_ns
        end = min(r.t1_ns, stack[-1][0]) if stack else r.t1_ns
        stack.append((end, r))
    while stack:
        end, top = stack.pop()
        if end > at:
            out.append((at, end, top))
        at = max(at, end)
    return out


class Timeline:
    """The records of one traced window, indexed for the gap queries."""

    def __init__(self, records):
        self.records = list(records)
        self.by_id = {r.span: r for r in self.records}
        self.batches = [r for r in self.records if r.name == "batch"]
        self.dispatch = {r.thread for r in self.batches}
        spans = [r for r in self.records if r.name != "batch"]
        self.main = _segments([r for r in spans if r.thread in self.dispatch])
        self.main_starts = [s for s, _e, _r in self.main]
        workers: dict = {}
        for r in spans:
            if r.thread not in self.dispatch:
                b = self.batch_of(r)
                if b is not None:
                    workers.setdefault(b, []).append(r)
        self.workers = {b: _segments(rs) for b, rs in workers.items()}

    def batch_of(self, r):
        """The id of the batch record `r` descends from, or None."""
        seen = 0
        while r is not None and seen < 64:
            if r.name == "batch":
                return r.span
            r = self.by_id.get(r.parent)
            seen += 1
        return None

    def _pieces(self, segs, starts, a: int, b: int):
        """(overlap ns, span) of the segments overlapping [a, b)."""
        i = max(bisect.bisect_right(starts, a) - 1, 0)
        while i < len(segs) and segs[i][0] < b:
            s, e, r = segs[i]
            ov = min(e, b) - max(s, a)
            if ov > 0:
                yield ov, r
            i += 1

    def _stage_at(self, t: int) -> str:
        i = bisect.bisect_right(self.main_starts, t) - 1
        return self.main[i][2].stage if i >= 0 else ""

    def label_ns(self, a: int, b: int) -> dict:
        """{label: ns} over [a, b): the dispatch thread's innermost span,
        after its stage; a 'stall.batch' also names the awaited batch's
        worker span covering most of it; time with no span open is
        '<stage>/(no span)', the stage being the last one seen."""
        out: dict = {}
        covered = 0
        for ov, r in self._pieces(self.main, self.main_starts, a, b):
            covered += ov
            label = f"{r.stage}/{_short(r.path)}"
            if r.name == "stall.batch":
                segs = self.workers.get(self.batch_of(r), [])
                if segs:
                    lo, hi = max(a, r.t0_ns), min(b, r.t1_ns)
                    inner: dict = {}
                    for wov, w in self._pieces(segs, [s for s, _e, _w in segs], lo, hi):
                        inner[w.name] = inner.get(w.name, 0) + wov
                    if inner:
                        label += "<-" + max(inner, key=inner.get)
            out[label] = out.get(label, 0) + ov
        if b - a > covered:
            stage = self._stage_at(a)
            key = f"{stage}/{NO_SPAN}" if stage else NO_SPAN
            out[key] = out.get(key, 0) + (b - a - covered)
        return out

    def label(self, a: int, b: int) -> str:
        ns = self.label_ns(a, b)
        return max(ns, key=ns.get)

    def idle_by_label(self, gaps) -> dict:
        """Device-idle seconds summed by label, largest first."""
        tot: dict = {}
        for a, b in gaps:
            for k, v in self.label_ns(a, b).items():
                tot[k] = tot.get(k, 0) + v
        return {k: v / 1e9 for k, v in sorted(tot.items(), key=lambda kv: -kv[1])}

    def unattributed(self, t: int) -> bool:
        """Whether no program span is open on a dispatch thread at `t`."""
        i = bisect.bisect_right(self.main_starts, t) - 1
        return i < 0 or self.main[i][1] <= t

    def idle_unattributed_pct(self, gaps) -> float | None:
        """Of the device-idle time, the share with no program span open
        on a dispatch thread."""
        total = sum(b - a for a, b in gaps)
        if total <= 0 or not self.main:
            return None
        covered = sum(ov for a, b in gaps for ov, _r in self._pieces(self.main, self.main_starts,
                                                                       a, b))
        return 100.0 * (total - covered) / total

    def retire_gaps_s(self) -> list:
        """Seconds between consecutive batches' retire ends on a dispatch
        thread, within one stage's run (a batch index that does not rise
        starts a new run: a new pass)."""
        out: list = []
        runs: dict = {}
        for r in sorted(self.batches, key=lambda r: r.t1_ns):
            key = (r.stage, r.thread)
            last = runs.get(key)
            if last is not None and r.batch > last.batch:
                out.append((r.t1_ns - last.t1_ns) / 1e9)
            runs[key] = r
        return out

    def retire_gap_ms_p95(self) -> float | None:
        gaps = self.retire_gaps_s()
        if len(gaps) < 20:
            return None
        return 1e3 * statistics.quantiles(gaps, n=20)[18]

    def cpu_pct_by_name(self) -> dict:
        """Each span name's CPU seconds over its wall seconds, in %."""
        tot: dict = {}
        for r in self.records:
            if r.cpu_ns is not None and r.wall_ns > 0:
                c = tot.setdefault(r.name, [0, 0])
                c[0] += r.cpu_ns
                c[1] += r.wall_ns
        return {k: 100.0 * c / w for k, (c, w) in sorted(tot.items())}

    def host_span_cpu_pct(self) -> float | None:
        """The CPU seconds over the wall seconds of every outermost span
        (no enclosing span on its thread) that is host work."""
        cpu = wall = 0
        for r in self.records:
            if r.name == "batch" or r.cpu_ns is None or r.name.split(".")[0] in WAITS:
                continue
            parent = self.by_id.get(r.parent)
            if parent is None or parent.name == "batch":
                cpu += r.cpu_ns
                wall += r.wall_ns
        return 100.0 * cpu / wall if wall > 0 else None
