"""graftlint record-path-discipline rule: per-record-alloc.

The failure class ISSUE 6 (native columnar record path) closed: Python
object construction executed ONCE PER RECORD on an emit- or
sort-reachable hot path. The r05 scale ledger put numbers on it — 121 s
of molecular `emit` and 411 s of `sort_write` were per-record
`BamRecord(...)` building, `.tolist()` tag conversion, and per-blob
generator hops, while the kernels cost 12 s. The native columnar path
(io.wirepack emit + pipeline.extsort native sort) exists precisely so no
such code runs between kernel retire and bytes-on-disk; this rule keeps
new per-record allocation from creeping back in.

Scope: functions that are (a) hot-path reachable (batch-loop roots,
analysis.engine.HOT_PATH_ROOTS) and (b) reachable from an emit/sort
root — a hot function whose basename contains 'emit' or 'sort'. Inside
any loop or comprehension there, the rule flags:

* ``BamRecord(...)`` / ``decode_record(...)`` — a Python record object
  per iteration;
* ``<x>.tolist()`` — a Python list (and boxed ints) per iteration;
* string concatenation with a literal (``"x" + y`` / ``y + "x"``) — a
  new str per iteration; builders belong at batch level.

The Python parity twins construct records per record BY DESIGN — but
their loops now pre-compute tag scalars at batch level and hand numpy
arrays through, so the package self-application stays CLEAN without
suppressions; a twin regression (a new `.tolist()` in the loop) is
exactly what this rule should catch.
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

#: Call basenames that build one Python record object per call.
_RECORD_CTORS = frozenset({"BamRecord", "decode_record"})

_LOOPS = (
    ast.For,
    ast.While,
    ast.ListComp,
    ast.SetComp,
    ast.DictComp,
    ast.GeneratorExp,
)


def _emit_sort_reach(index: PackageIndex) -> set[str]:
    """Qualnames reachable from a hot emit/sort root (basename contains
    'emit' or 'sort'), via the same basename call graph the engine's
    other reachability sets use."""
    roots = {
        fi.qualname
        for name, fis in index.functions.items()
        if "emit" in name.lower() or "sort" in name.lower()
        for fi in fis
        if fi.qualname in index.hot_reachable
    }
    return index._reach(roots)


def _in_loop(sf: SourceFile, node: ast.AST, func: ast.AST) -> bool:
    """Whether node sits inside a loop/comprehension WITHIN func."""
    cur = sf.parents.get(node)
    while cur is not None and cur is not func:
        if isinstance(cur, _LOOPS):
            return True
        if isinstance(cur, (ast.FunctionDef, ast.AsyncFunctionDef)):
            return False
        cur = sf.parents.get(cur)
    return False


def _is_str_concat(node: ast.BinOp) -> bool:
    """`"lit" + x` / `x + "lit"` — a per-iteration str build. Literal-
    anchored on purpose: numeric BinOps (offset math) are everywhere on
    hot paths and are not allocations of interest."""
    if not isinstance(node.op, ast.Add):
        return False
    return any(
        isinstance(side, ast.Constant) and isinstance(side.value, str)
        for side in (node.left, node.right)
    )


def check_per_record_alloc(
    sf: SourceFile, index: PackageIndex
) -> Iterator[Finding]:
    reach = _emit_sort_reach(index)
    if not reach:
        return
    for node in ast.walk(sf.tree):
        if not isinstance(node, (ast.FunctionDef, ast.AsyncFunctionDef)):
            continue
        fi = index.info(node)
        if (
            fi is None
            or fi.qualname not in reach
            or fi.qualname not in index.hot_reachable
        ):
            continue
        for sub in PackageIndex._own_nodes(node):
            what = None
            if isinstance(sub, ast.Call):
                base = call_basename(sub)
                if base in _RECORD_CTORS:
                    what = f"{base}(...) builds a record object"
                elif (
                    isinstance(sub.func, ast.Attribute)
                    and sub.func.attr == "tolist"
                ):
                    what = ".tolist() boxes an array into Python objects"
            elif isinstance(sub, ast.BinOp) and _is_str_concat(sub):
                what = "string concatenation builds a new str"
            if what is None or not _in_loop(sf, sub, node):
                continue
            yield Finding(
                rule="per-record-alloc",
                path=sf.display,
                line=sub.lineno,
                col=sub.col_offset,
                message=(
                    f"{what} once per loop iteration inside the emit/"
                    f"sort-reachable hot function {node.name!r} — "
                    "per-record Python allocation is the host record-"
                    "path wall (r05: 121 s emit / 411 s sort_write vs "
                    "12 s of kernels). Batch it: hand kernel output "
                    "planes to the native columnar emitter "
                    "(io.wirepack.emit_consensus_records), keep tag "
                    "arrays numpy (io.bam._encode_tags serializes them "
                    "vectorized), or precompute per-record scalars at "
                    "batch level (pipeline.calling._span_stats)"
                ),
            )


RULES = [
    Rule(
        name="per-record-alloc",
        summary="per-record Python object construction (BamRecord, "
        ".tolist(), str concat) in a loop on an emit/sort-reachable "
        "hot path",
        check=check_per_record_alloc,
    ),
]
