"""graftlint retry-discipline rule: unbounded retry loops.

The failure class this PR's robustness review named (ROADMAP open item:
grow a rule per new failure class): a `while True:` loop that catches
an I/O or device error and spins again with neither an attempt bound
nor a backoff turns one persistent fault into a livelock — the batch
loop looks alive (the process spins), every ledger counter freezes, and
the run never crashes into the checkpoint layer that could actually
recover it. The sanctioned shape is the bounded executor
(faults.retry.guarded): capped attempts, exponential backoff, then
degrade or die.

A loop passes when any handler path terminates it (`raise` / `break` /
`return` — which is what an attempt-bound check compiles to) or at
least backs off (a sleep/wait call). Loops whose try body touches no
I/O- or device-shaped call are ignored — a pure-compute retry loop is
somebody else's bug.
"""

from __future__ import annotations

import ast
from typing import Iterator

from bsseqconsensusreads_tpu_torch.analysis.engine import (
    Finding,
    PackageIndex,
    Rule,
    SourceFile,
    call_basename,
)

#: Call basenames that mark a try body as touching I/O or the device —
#: the operations whose transient failures invite retry loops.
_IO_DEVICE_CALLS = frozenset(
    {
        # filesystem / sockets / subprocess
        "open", "read", "readline", "readlines", "write", "flush",
        "fsync", "remove", "unlink", "rename", "replace", "recv",
        "send", "sendall", "connect", "communicate", "check_call",
        "check_output", "urlopen", "request",
        # device / executor
        "device_put", "device_get", "block_until_ready", "result",
        "submit",
    }
)

#: Handler calls that count as backing off before the next attempt.
_BACKOFF_CALLS = frozenset({"sleep", "wait", "backoff"})


def _const_true(test: ast.AST) -> bool:
    return isinstance(test, ast.Constant) and bool(test.value)


def _calls_in(nodes) -> Iterator[str]:
    for n in nodes:
        for sub in ast.walk(n):
            if isinstance(sub, ast.Call):
                base = call_basename(sub)
                if base:
                    yield base


def check_unbounded_retry(
    sf: SourceFile, index: PackageIndex
) -> Iterator[Finding]:
    for node in ast.walk(sf.tree):
        if not (isinstance(node, ast.While) and _const_true(node.test)):
            continue
        for sub in PackageIndex._own_nodes(node):
            if not isinstance(sub, ast.Try):
                continue
            if not any(
                base in _IO_DEVICE_CALLS for base in _calls_in(sub.body)
            ):
                continue
            for handler in sub.handlers:
                terminates = any(
                    isinstance(x, (ast.Raise, ast.Break, ast.Return))
                    for stmt in handler.body
                    for x in ast.walk(stmt)
                )
                if terminates:
                    continue
                if any(
                    base in _BACKOFF_CALLS
                    for base in _calls_in(handler.body)
                ):
                    continue
                what = (
                    ast.unparse(handler.type)
                    if handler.type is not None
                    else "BaseException"
                )
                yield Finding(
                    rule="unbounded-retry",
                    path=sf.display,
                    line=handler.lineno,
                    col=handler.col_offset,
                    message=(
                        f"`while True` retry around I/O/device calls "
                        f"swallows {what} with no attempt bound or "
                        "backoff — a persistent fault livelocks here "
                        "instead of crashing into recoverable state; "
                        "bound the attempts (cf. faults.retry.guarded) "
                        "or back off between tries"
                    ),
                )


RULES = [
    Rule(
        name="unbounded-retry",
        summary="while-True retry around I/O/device calls without "
        "attempt bound or backoff",
        check=check_unbounded_retry,
    ),
]
