"""Load and invoke a pysam/click CLI script through the pysam shim.

The port's copy of the JAX package's compat/refrunner.py.

Built for the golden-differential tests: the reference's tools
(tools/1.convert_AG_to_CT.py with CLI at :29-33, tools/2.extend_gap.py at
:142-145) are plain Python scripts whose ``main`` is a click command; this
loads such a script as a module (shim pre-installed) and calls the
undecorated callback directly, so the ACTUAL third-party code runs against
first-party BAM/FASTA I/O.
"""

from __future__ import annotations

import importlib.util
import os
import sys

from bsseqconsensusreads_tpu_torch.compat.pysam_shim import install_shim


def load_pysam_script(path: str, module_name: str | None = None):
    """Import a pysam-dependent script file with the shim active."""
    install_shim()
    if module_name is None:
        base = os.path.basename(path)
        module_name = "refshim_" + "".join(
            c if c.isalnum() else "_" for c in base
        )
    spec = importlib.util.spec_from_file_location(module_name, path)
    if spec is None or spec.loader is None:
        raise ImportError(f"cannot load {path}")
    mod = importlib.util.module_from_spec(spec)
    # register before exec so decorators resolving __module__ work
    sys.modules[module_name] = mod
    spec.loader.exec_module(mod)
    return mod


def run_pysam_script(path: str, /, **kwargs):
    """Run the script's ``main`` (click command or plain function) with
    keyword arguments matching its parameters. Returns the callback's
    return value."""
    mod = load_pysam_script(path)
    main = getattr(mod, "main")
    fn = getattr(main, "callback", main)  # unwrap a click.Command
    return fn(**kwargs)
