"""The shared body of the port's drop-in tools: one CLI subcommand run
with the tool's own arguments, as a Snakemake rule's `shell:` line would
run it.

Each tool takes the arguments of the JAX package's tools/ twin of the same
name, plus `--device cuda|cpu` (default: the card). The consensus stages
pass it to their subcommand; `group` and `filter-consensus` are host code
in both packages and take no device, so there the flag is checked and
then has nothing to move.
"""

from __future__ import annotations

import os
import sys

_REPO = os.path.dirname(os.path.dirname(os.path.dirname(os.path.abspath(__file__))))
#: subcommands whose work runs on the device
DEVICE_COMMANDS = ("molecular", "duplex")


def run_dropin(command: str, argv: list[str]) -> int:
    """`python -m bsseqconsensusreads_tpu_torch <command> <argv>`, in this
    process; `--device` is kept for the consensus stages and checked and
    dropped for the host-only ones."""
    if _REPO not in sys.path:
        sys.path.insert(0, _REPO)
    from bsseqconsensusreads_tpu_torch.cli import main
    from bsseqconsensusreads_tpu_torch.utils import observe

    argv = list(argv)
    if command not in DEVICE_COMMANDS:
        for i, arg in enumerate(argv):
            if arg == "--device" or arg.startswith("--device="):
                value = arg.split("=", 1)[1] if "=" in arg else (
                    argv[i + 1] if i + 1 < len(argv) else "")
                if value not in ("cuda", "cpu"):
                    observe.stderr_line(
                        f"{command}: --device must be cuda or cpu, got {value!r}")
                    return 2
                del argv[i:i + (1 if "=" in arg else 2)]
                break
    return main([command] + argv)
