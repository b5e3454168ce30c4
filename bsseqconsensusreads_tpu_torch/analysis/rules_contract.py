"""contract-drift: per-file used-but-undeclared surface check.

The whole-program direction of graftcontract (declared-but-unused,
emitted-but-never-consumed, README tables) only makes sense over the
full package and runs as ``cli lint --contracts``. But the *use* side
— an env read, a ledger emit, a failpoint fire, a transport refusal —
is checkable one file at a time against the registry, and that is what
this rule does, so an undeclared name fails the ordinary lint sweep at
the line that introduced it.

Scope is deliberately the four surfaces whose uses are unambiguous in
isolation. Client-side protocol-op literals are *not* checked here:
fixture files legitimately fabricate ops (fx_unleased_work_dispatch
ships an ``"assign"`` job to seed a different rule), and ops are a
cross-plane contract anyway — the whole-program pass owns them.

Files under the analysis subpackage are skipped: the registry and rule
patterns in there mention surface names as declarations, not uses.
"""

from __future__ import annotations

from typing import Iterator

from bsseqconsensusreads_tpu_torch.analysis.engine import (
    Finding,
    PackageIndex,
    Rule,
    SourceFile,
)

_RULE = "contract-drift"


def _check(sf: SourceFile, index: PackageIndex) -> Iterator[Finding]:
    from bsseqconsensusreads_tpu_torch.analysis import contracts

    if "analysis" in sf.module.split("."):
        return
    ex = contracts.Extraction()
    ex._scan_file(sf, index)
    reg = contracts.REGISTRY
    checks = (
        (ex.env_uses, reg.env_names(), "env var",
         "declare it in analysis.contracts ENV_VARS"),
        (ex.event_emits, reg.event_names(), "ledger event",
         "declare it in analysis.contracts EVENTS (and "
         "ledger_tools.EVENT_SCHEMA)"),
        (ex.fire_sites, reg.failpoint_sites, "failpoint site",
         "declare it in analysis.contracts FAILPOINT_SITES and "
         "faults.failpoints.SITES"),
        (ex.schedule_sites, reg.failpoint_sites, "failpoint site",
         "declare it in analysis.contracts FAILPOINT_SITES and "
         "faults.failpoints.SITES"),
        (ex.refusal_uses, reg.refusal_reasons, "refusal reason",
         "declare it in analysis.contracts REFUSAL_REASONS"),
    )
    for uses, declared, what, fix in checks:
        for name, sites in uses.items():
            if name in declared:
                continue
            for _path, line in sites:
                yield Finding(
                    rule=_RULE,
                    path=sf.display,
                    line=line,
                    col=0,
                    message=(
                        f"undeclared {what} {name!r} — not in the "
                        f"graftcontract registry; {fix}, or rename the "
                        f"use to a declared surface"
                    ),
                )


RULES = [
    Rule(
        name=_RULE,
        summary=(
            "use of a BSSEQ_TPU_* env var, ledger event, failpoint "
            "site, or transport refusal reason that the graftcontract "
            "registry does not declare — stringly-typed surfaces rot "
            "silently when emitter and consumer drift apart, so every "
            "name crossing a process or module boundary must be "
            "declared in analysis.contracts (whole-program drift "
            "directions run as `cli lint --contracts`)"
        ),
        check=_check,
    ),
]
