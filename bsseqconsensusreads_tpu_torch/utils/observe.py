"""Per-stage metrics: named counters and phase timers.

The port's counterpart of Metrics from the JAX package's utils/observe.py
(the run ledger, traces and sinks are a later slice of the port). Phases the
stages time: ingest, encode, kernel (host-side dispatch: H2D copies and
launches), device_wait (CUDA event sync — the device still owned the
batch), fetch (D2H copy + unpack), host_vote (singleton host path),
rawize (duplex raw units + strand calls), emit, sort_write (the
output writer's sort, spill, merge and deflate), genome_load (the duplex
wire's whole-genome read and upload, or the methyl accumulator's read,
once per stage), methyl (the methylation planes peeled or computed on
the host, and their tallies added) and methyl_finalize (the tally merge
and the bedMethyl / CX writes). A dotted name ('emit.pack',
'sort_write.merge') is a part of the phase before the dot.
"""

from __future__ import annotations

import contextlib
import json
import sys
import time
from dataclasses import dataclass, field

#: phases whose seconds are device occupancy or the transfer around it
DEVICE_PHASES = frozenset({"kernel", "device_wait", "fetch"})


@dataclass
class Metrics:
    """Named counters + phase timers for one stage (the port's stages run
    on one thread). Nested `timed` phases each record their own seconds."""

    counters: dict = field(default_factory=dict)
    seconds: dict = field(default_factory=dict)

    def count(self, name: str, n: int = 1) -> None:
        self.counters[name] = self.counters.get(name, 0) + n

    @contextlib.contextmanager
    def timed(self, name: str):
        t0 = time.monotonic()
        try:
            yield
        finally:
            self.seconds[name] = self.seconds.get(name, 0.0) + time.monotonic() - t0

    def add_seconds(self, name: str, dt: float) -> None:
        """Seconds measured elsewhere (a C call's own clock): a dotted
        name ('sort_write.merge') marks a part of a phase timed whole."""
        self.seconds[name] = self.seconds.get(name, 0.0) + dt

    def as_dict(self) -> dict:
        out = dict(self.counters)
        out.update({f"{k}_seconds": round(v, 3) for k, v in self.seconds.items()})
        return out


def stderr_line(msg: str) -> None:
    """One operator-facing line on stderr."""
    print(msg, file=sys.stderr, flush=True)


def event(name: str, fields: dict) -> None:
    """An event the JAX package writes to its run ledger, as one stderr
    line `<name> {json}` (the port's ledger and sinks are a later slice):
    a checkpoint discard or a shard quarantine is never silent."""
    stderr_line(f"{name} {json.dumps(fields, sort_keys=True, default=str)}")
