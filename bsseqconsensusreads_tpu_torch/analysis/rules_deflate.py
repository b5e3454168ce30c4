"""graftlint codec-discipline rule: serial-deflate.

The failure class ISSUE 12's codec tier (io.pbgzf) closed: block
compression executed inline on a merge/emit-reachable hot path. The r06
scale ledger put numbers on it — 65 s of the molecular stage's 96.5 s
merge was `merge_bgzf`, serial deflate on the one thread that also runs
the k-way merge. The sanctioned shape is a writer from the codec tier:
`io.bam._create_bgzf` (which auto-selects `io.pbgzf.PBgzfWriter` when
workers are available) or `io.bgzf.BgzfWriter` for genuinely serial
contexts — never `zlib.compress`/`compressobj` or a hand-rolled
`deflate_block` call at the point of the merge/emit loop, where it pins
the deflate to the merge thread and starves the parallel tier.

Scope: functions that are (a) hot-path reachable and (b) reachable from
a hot merge/emit/sort root (basename contains 'merge', 'emit' or
'sort'). The codec tier itself — io/bgzf.py and io/pbgzf.py — IS the
sanctioned deflate site and is exempt by path.
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

#: The codec tier: the only modules allowed to build deflate streams.
_CODEC_FILES = ("io/bgzf.py", "io/pbgzf.py")

#: zlib entry points that open a serial deflate stream.
_ZLIB_COMPRESS = frozenset({"compress", "compressobj"})


def _merge_emit_reach(index: PackageIndex) -> set[str]:
    """Qualnames reachable from a hot merge/emit/sort root, via the same
    basename call graph the engine's other reachability sets use."""
    roots = {
        fi.qualname
        for name, fis in index.functions.items()
        if any(k in name.lower() for k in ("merge", "emit", "sort"))
        for fi in fis
        if fi.qualname in index.hot_reachable
    }
    return index._reach(roots)


def _is_serial_deflate(node: ast.Call) -> str | None:
    func = node.func
    if (
        isinstance(func, ast.Attribute)
        and func.attr in _ZLIB_COMPRESS
        and isinstance(func.value, ast.Name)
        and func.value.id == "zlib"
    ):
        return f"zlib.{func.attr}(...)"
    if call_basename(node) == "deflate_block":
        return "deflate_block(...)"
    return None


def check_serial_deflate(
    sf: SourceFile, index: PackageIndex
) -> Iterator[Finding]:
    if sf.display.replace("\\", "/").endswith(_CODEC_FILES):
        return
    reach = _merge_emit_reach(index)
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
            if not isinstance(sub, ast.Call):
                continue
            what = _is_serial_deflate(sub)
            if what is None:
                continue
            yield Finding(
                rule="serial-deflate",
                path=sf.display,
                line=sub.lineno,
                col=sub.col_offset,
                message=(
                    f"{what} inline in the merge/emit-reachable hot "
                    f"function {node.name!r} — serial block compression "
                    "on the merge thread is the sort_write wall the "
                    "parallel codec tier removes (r06: 65 s of the "
                    "96.5 s molecular merge was merge_bgzf). Write "
                    "through a codec-tier writer instead: "
                    "io.bam._create_bgzf auto-selects the parallel "
                    "io.pbgzf.PBgzfWriter when workers are available"
                ),
            )


RULES = [
    Rule(
        name="serial-deflate",
        summary="inline zlib/BGZF block compression on merge/emit-"
        "reachable hot paths instead of the parallel codec tier",
        check=check_serial_deflate,
    ),
]
