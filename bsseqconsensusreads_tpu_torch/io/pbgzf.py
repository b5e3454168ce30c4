"""Parallel BGZF deflate codec: shard block compression, deliver in order.

The port's copy of the JAX package's io/pbgzf.py.

BGZF's one structural gift is that every 64K block is an independent
deflate stream (io.bgzf.deflate_block) — so block compression can fan
out across threads while the file writes strictly in submission order,
and the output bytes are identical to the serial BgzfWriter for any
worker count. zlib releases the GIL around deflate, so plain threads
give real parallelism without pickling block payloads across processes
(the htslib/pbgzip shape: shard-compress-concatenate).

PBgzfWriter is a drop-in for io.bgzf.BgzfWriter (same write/flush/close
surface, same EOF marker, same block cutting: exact MAX_BLOCK_SIZE
payloads, remainder at flush/close) selected by io.bam._create_bgzf for
the python codec tier whenever workers are available — both the bucket
concatenator (pipeline.bucketemit) and the Python sort engine compress
through it. The in-flight window is bounded (no unbounded queue of
compressed blocks behind a slow disk), delivery is deterministic, and
the per-block CRC contract is deflate_block's, unchanged.

Worker resolution (`default_workers`): BSSEQ_TPU_PBGZF forces a count
(0 disables); otherwise the shared host-parallel knob
(parallel.hostpool.host_workers) must offer >= 2 workers — on a 1-vCPU
image the serial writer is strictly cheaper than one worker thread plus
handoff.

Attribution: attach a stage's observe.Metrics via `metrics=` (or
io.bam.attach_codec_metrics) and the writer books worker-busy deflate
seconds under the dotted sub-phase 'sort_write.deflate' (plus
'sort_write.deflate_span' for the writer's active wall) and counts
pbgzf_workers/pbgzf_blocks — so the parallelism is attributable, not
just faster.
"""

from __future__ import annotations

import threading
import time
from collections import deque
from concurrent.futures import Future, ThreadPoolExecutor
from typing import BinaryIO

from bsseqconsensusreads_tpu_torch.io.bgzf import (
    BGZF_EOF,
    MAX_BLOCK_SIZE,
    deflate_block,
)


def default_workers() -> int:
    """Deflate worker count for the python codec tier: BSSEQ_TPU_PBGZF
    overrides (0 disables); otherwise host_workers() when it offers at
    least 2, else 0 (serial BgzfWriter)."""
    import os

    spec = os.environ.get("BSSEQ_TPU_PBGZF", "")
    if spec:
        try:
            return max(0, int(spec))
        except ValueError:
            return 0
    from bsseqconsensusreads_tpu_torch.parallel import hostpool

    w = hostpool.host_workers()
    return w if w >= 2 else 0


class PBgzfWriter:
    """BgzfWriter twin whose per-block deflate runs on a worker pool.

    Blocks are submitted in payload order and written in payload order;
    at most `window` compressed futures are in flight (submitting the
    next block first drains the oldest), so memory is bounded at
    ~window * 64K whatever the disk does. A worker exception (including
    an armed bgzf_write failpoint) surfaces on the writer thread at the
    next drain — the caller's retry unit rewrites the file whole, same
    as the serial codec."""

    def __init__(self, fileobj: BinaryIO, level: int = 6,
                 workers: int = 2, window: int | None = None,
                 metrics=None):
        if workers < 1:
            raise ValueError(f"PBgzfWriter needs workers >= 1, got {workers}")
        self._fh = fileobj
        self._level = level
        self._buf = bytearray()
        self._closed = False
        self.workers = workers
        self._window = window if window is not None else workers * 4
        self._pool = ThreadPoolExecutor(
            max_workers=workers, thread_name_prefix="bsseq-pbgzf"
        )
        self._pending: deque[Future] = deque()
        self._busy_s = 0.0
        self._busy_lock = threading.Lock()
        self._blocks = 0
        self._t_first: float | None = None
        #: stage metrics sink (io.bam.attach_codec_metrics) — optional,
        #: set after construction; read once at close
        self.metrics = metrics

    @classmethod
    def open(cls, path: str, level: int = 6, workers: int | None = None,
             metrics=None) -> "PBgzfWriter":
        w = default_workers() if workers is None else workers
        return cls(open(path, "wb"), level=level, workers=max(1, w),
                   metrics=metrics)

    def _task(self, payload: bytes) -> bytes:
        t0 = time.monotonic()
        block = deflate_block(payload, self._level)
        dt = time.monotonic() - t0
        with self._busy_lock:
            self._busy_s += dt
        return block

    def _submit(self, payload: bytes) -> None:
        if self._t_first is None:
            # graftlint: disable=thread-unsafe-mutation -- writer state is confined to
            # the writing thread; the pool only deflates detached payloads
            self._t_first = time.monotonic()
        if len(self._pending) >= self._window:
            self._fh.write(self._pending.popleft().result())
        self._pending.append(self._pool.submit(self._task, payload))
        # graftlint: disable=thread-unsafe-mutation -- thread-confined writer state, as
        # above
        self._blocks += 1

    def _drain(self) -> None:
        while self._pending:
            self._fh.write(self._pending.popleft().result())

    def write(self, data: bytes) -> None:
        # graftlint: disable=thread-unsafe-mutation -- writer objects are confined to
        # their writing thread
        self._buf += data
        while len(self._buf) >= MAX_BLOCK_SIZE:
            self._submit(bytes(self._buf[:MAX_BLOCK_SIZE]))
            del self._buf[:MAX_BLOCK_SIZE]

    def flush(self) -> None:
        if self._buf:
            self._submit(bytes(self._buf))
            self._buf.clear()
        self._drain()

    def _account(self) -> None:
        m = self.metrics
        if m is None:
            return
        m.count("pbgzf_writers")
        m.count("pbgzf_workers", self.workers)
        m.count("pbgzf_blocks", self._blocks)
        if self._busy_s:
            m.add_seconds("sort_write.deflate", self._busy_s)
        if self._t_first is not None:
            m.add_seconds(
                "sort_write.deflate_span", time.monotonic() - self._t_first
            )

    def close(self) -> None:
        if self._closed:
            return
        # graftlint: disable=thread-unsafe-mutation -- closed by the writing thread
        # after the pool drained
        self._closed = True
        try:
            self.flush()
            self._fh.write(BGZF_EOF)
        finally:
            self._pool.shutdown(wait=True, cancel_futures=True)
            self._fh.close()
            self._account()

    def __enter__(self) -> "PBgzfWriter":
        return self

    def __exit__(self, *exc) -> None:
        self.close()
