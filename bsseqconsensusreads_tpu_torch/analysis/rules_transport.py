"""graftlint transport-discipline rule: unframed socket reads.

The failure class the fleet's TCP transport (serve/transport.py)
introduces: reading a socket with raw ``.recv()`` / ``.readline()``
instead of the length-framed, bounded, guard-typed reader. A raw recv
trusts the peer for the record boundary AND the size — on a TCP port
(no filesystem permission wall) that is an unbounded allocation driven
by hostile bytes, and a protocol desync surfaces as a crash or a hang
instead of a typed `TransportError` refusal. The sanctioned shape is
`serve.transport.recv_message` / `request`, whose frame header is
admitted against MAX_FRAME before any payload byte is buffered; the
two `conn.recv` calls inside transport.py itself carry reviewed
suppressions — they ARE the framed reader.

Scope: files that import `socket` (anything else calling `.readline()`
is reading files, not wires — other rules' business).
"""

from __future__ import annotations

import ast
from typing import Iterator

from bsseqconsensusreads_tpu_torch.analysis.engine import (
    Finding,
    PackageIndex,
    Rule,
    SourceFile,
)

#: Raw stream-read methods that bypass frame admission on a socket.
_RAW_READS = frozenset({"recv", "recv_into", "recvfrom", "readline"})


def _imports_socket(sf: SourceFile) -> bool:
    for node in ast.walk(sf.tree):
        if isinstance(node, ast.Import):
            if any(a.name.split(".")[0] == "socket" for a in node.names):
                return True
        elif isinstance(node, ast.ImportFrom):
            if (node.module or "").split(".")[0] == "socket":
                return True
    return False


def check_unframed_socket_read(
    sf: SourceFile, index: PackageIndex
) -> Iterator[Finding]:
    if not _imports_socket(sf):
        return
    for node in ast.walk(sf.tree):
        if not isinstance(node, ast.Call):
            continue
        func = node.func
        if not isinstance(func, ast.Attribute) or func.attr not in _RAW_READS:
            continue
        yield Finding(
            rule="unframed-socket-read",
            path=sf.display,
            line=node.lineno,
            col=node.col_offset,
            message=(
                f".{func.attr}() on a socket path without the "
                "length-framed guarded reader — the peer controls the "
                "record boundary and the size, so garbage or hostile "
                "frames become unbounded buffering or a crash instead "
                "of a typed TransportError; read through "
                "serve.transport.recv_message/request"
            ),
        )


RULES = [
    Rule(
        name="unframed-socket-read",
        summary="raw recv/readline on socket paths instead of the "
        "length-framed guarded transport reader",
        check=check_unframed_socket_read,
    ),
]
