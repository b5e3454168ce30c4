"""netchaos: the wire-fault shim for the serve transport.

The port's copy of the JAX package's faults/netchaos.py. It interprets the
three net_* failpoint sites (faults.failpoints: ``net_send`` /
``net_recv`` / ``net_accept``), whose actions are network behaviours no
``raise`` can model:

    delay[:Ns]   sleep before the wire op (latency injection)
    drop         close the connection without delivering the frame —
                 the peer sees a clean EOF, the sender a dead socket
    dup          deliver the same frame twice: the client re-issues the
                 identical request on a fresh connection and discards
                 the second reply (the server answers it from its reply
                 cache, no second dispatch)
    corrupt      flip bytes after the length header — the receiving
                 framing layer must REFUSE the frame (bad_json), never
                 parse it
    half_open    accept, then stall and close without answering — the
                 client's read blocks until its own timeout
    partition    refuse the connection outright; pair with @peer= for
                 one-sided partitions (``net_send=partition@peer=...``)

serve/transport.py (client edges) and serve/server.py (accept edge) enact
the `WirePlan` this module folds the fired points into, and `mangle`
corrupts a frame body. Every fired point is counted and ledgered
('failpoint_fired') by failpoints.evaluate. One branch when unarmed.
"""

from __future__ import annotations

from dataclasses import dataclass

from bsseqconsensusreads_tpu_torch.faults import failpoints


@dataclass
class WirePlan:
    """The folded network faults scheduled for ONE wire operation."""

    delay_s: float = 0.0
    drop: bool = False
    dup: bool = False
    corrupt: bool = False
    half_open: bool = False
    half_open_s: float = 30.0
    partition: bool = False

    def __bool__(self) -> bool:
        return bool(self.delay_s > 0.0 or self.drop or self.dup or self.corrupt
                    or self.half_open or self.partition)


#: the plan when nothing fires — callers only read it
_QUIET = WirePlan()


def plan(site: str, peer: str = "") -> WirePlan:
    """Evaluate the armed schedule at one net_* site against this peer and
    fold every fired point into a WirePlan for the transport to enact."""
    if not failpoints.ARMED:
        return _QUIET
    fired = failpoints.evaluate(site, peer=peer)
    if not fired:
        return _QUIET
    p = WirePlan()
    for fp in fired:
        if fp.action == "delay":
            p.delay_s += fp.duration_s
        elif fp.action == "drop":
            p.drop = True
        elif fp.action == "dup":
            p.dup = True
        elif fp.action == "corrupt":
            p.corrupt = True
        elif fp.action == "half_open":
            p.half_open = True
            p.half_open_s = fp.duration_s
        elif fp.action == "partition":
            p.partition = True
        elif fp.action == "stall":
            # a process action at a net site folds into the delay budget
            p.delay_s += fp.duration_s
    return p


def mangle(body: bytes) -> bytes:
    """Corrupt a frame BODY (the bytes after any length header): XOR the
    first 8 bytes with 0xA5. A JSON body starts with ``{"``, so the flip
    yields non-UTF-8 bytes the receiver must refuse (bad_json); later
    newlines stay, so the unix JSONL framing still delimits one line."""
    if not body:
        return body
    n = min(8, len(body))
    return bytes(b ^ 0xA5 for b in body[:n]) + body[n:]
