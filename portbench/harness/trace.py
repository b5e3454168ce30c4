"""Readings the benchmark takes itself: the process's peak host RSS and
the device's activity from a torch.profiler trace held in memory.

PeakMemory and the interval union are copies of chip_smoke.py's
PeakMemory and device_busy_s."""

from __future__ import annotations

import collections
import os
import threading


class PeakMemory:
    """Peak host RSS (/proc/self/statm read every 5 ms by a thread) over a
    `with` block, in GiB."""

    PAGE = os.sysconf("SC_PAGE_SIZE")

    def __init__(self):
        self._done = threading.Event()
        self._thread = threading.Thread(target=self._sample, daemon=True)
        self.host_gib = 0.0

    @classmethod
    def rss_gib(cls) -> float:
        with open("/proc/self/statm") as fh:
            return int(fh.read().split()[1]) * cls.PAGE / 2**30

    def _sample(self):
        while not self._done.wait(0.005):
            self.host_gib = max(self.host_gib, self.rss_gib())

    def __enter__(self):
        self.host_gib = self.rss_gib()
        self._thread.start()
        return self

    def __exit__(self, *exc):
        self._done.set()
        self._thread.join()
        self.host_gib = max(self.host_gib, self.rss_gib())
        return False


def union(spans) -> list:
    """Merged [start, end) intervals of `spans`, sorted."""
    out: list = []
    for s, e in sorted(spans):
        if out and s <= out[-1][1]:
            if e > out[-1][1]:
                out[-1][1] = e
        else:
            out.append([s, e])
    return out


def busy_seconds(merged) -> float:
    return sum(e - s for s, e in merged)


def device_events(torch, prof) -> list:
    """(name, start_us, end_us) of every device event of a profiler run."""
    return [(e.name, e.time_range.start, e.time_range.end) for e in prof.events()
            if e.device_type == torch.autograd.DeviceType.CUDA]


def short_name(name: str, width: int = 120) -> str:
    """A kernel's name cut to `width` characters (templated names run to
    thousands)."""
    return name if len(name) <= width else name[:width - 3] + "..."


def summarize(events, window_s: float, label_at) -> dict:
    """busy_s, kernel seconds by name, and the breakdown's two top-10
    lists. label_at(t_s) names what the host was doing t_s seconds into
    the traced window (the idle gaps are named by it)."""
    merged = union((s, e) for _n, s, e in events)
    by_name: collections.Counter = collections.Counter()
    for name, s, e in events:
        by_name[short_name(name)] += (e - s) / 1e6
    bounds = [0.0] + [x / 1e6 for iv in merged for x in iv] + [window_s]
    gaps = [(label_at((a + b) / 2), b - a)
            for a, b in zip(bounds[0::2], bounds[1::2]) if b > a]
    gaps.sort(key=lambda g: -g[1])
    return {
        "busy_s": busy_seconds(merged) / 1e6,
        "kernel_s": dict(by_name),
        "device_ops": [[n, v] for n, v in by_name.most_common(10)],
        "idle_gaps": [[n, v] for n, v in gaps[:10]],
    }
