"""graftlint — first-party static analysis for card-hostile and
thread-unsafe code in the port (the JAX package's analysis/, with torch
rules in place of its JAX ones).

The run ledger can *measure* a stalled card; this package exists to
*prevent* the code classes that stall it: host syncs hiding outside
accounted ledger spans, kernel builds on the batch loop, Python branches
on device tensors, unlocked shared mutation in the pools' worker
callables, blocking I/O inside device spans, set-order-dependent shapes,
bare stderr prints, swallowed worker exceptions, and the rest of the
rule table (`lint --list-rules`). `contracts` checks the port's declared
surface (env knobs, failpoints, ledger events, ops, CLI) against its uses.

Entry points:
  * `python -m bsseqconsensusreads_tpu_torch lint [paths...]` — CLI
    (`--contracts` for the whole-program pass)
  * run_lint(paths, rules=...) -> list[Finding]              — library
  * tests/test_torch_graftlint.py, tests/test_torch_contracts.py

Suppression syntax (inline, rule name mandatory):
    x = float(out)  # graftlint: disable=host-sync -- singleton batch,
                    # value is host numpy by construction
A standalone `# graftlint: disable=<rule>` comment line applies to the
next code line. `# graftlint: disable-file=<rule>` anywhere disables a
rule for the whole file. Unknown rule names are a hard error — a typo'd
suppression must not silently disable nothing.
"""

from bsseqconsensusreads_tpu_torch.analysis.engine import (  # noqa: F401
    Finding,
    LintError,
    all_rules,
    run_lint,
)
