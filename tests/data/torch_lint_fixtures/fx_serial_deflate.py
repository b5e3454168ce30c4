"""graftlint fixture: serial-deflate — one seeded violation.

`hot_` marks the function as a batch-loop root; 'merge' in its name
makes it a merge/emit root. The inline `zlib.compress` is the seeded
serial deflate on the merge thread (the r06 merge_bgzf wall shape). The
twin below writes through a codec-tier writer and must stay clean.
"""

import zlib


def hot_merge_runs(runs):
    out = []
    for payload in runs:
        out.append(zlib.compress(payload, 1))  # seeded: serial-deflate
    return out


def hot_merge_runs_codec(runs, writer):
    """Clean twin: bytes flow through a codec-tier writer (io.bam's
    _create_bgzf picks io.pbgzf.PBgzfWriter when workers exist) — the
    deflate fans out off the merge thread."""
    for payload in runs:
        writer.write(payload)
    writer.flush()
