"""The port's pinned log-likelihood tables and scalar against the JAX
package, its parameter hand-over, its device rule, and its import hygiene.

Inputs are integer quals; both packages see the same numpy arrays."""

import dataclasses
import os
import subprocess
import sys

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from bsseqconsensusreads_tpu.models.params import ConsensusParams as JaxParams
from bsseqconsensusreads_tpu.ops import phred as jphred
from bsseqconsensusreads_tpu_torch.models.params import ConsensusParams
from bsseqconsensusreads_tpu_torch.ops import phred
from bsseqconsensusreads_tpu_torch.utils.device import resolve_device

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def _jax_jit_table(rate: float) -> np.ndarray:
    fn = jax.jit(lambda q: jnp.stack(
        jphred.log_likelihoods(jphred.adjust_quals_post_umi(q, rate)), axis=-1
    ))
    return np.asarray(fn(jnp.arange(phred.TABLE_QUALS, dtype=jnp.float32)))


def _ulps(a: np.ndarray, b: np.ndarray) -> np.ndarray:
    return np.abs(
        a.view(np.int32).astype(np.int64) - b.view(np.int32).astype(np.int64)
    )


def _jax_static_pre_umi(rate: float) -> np.ndarray:
    # the finalize takes the rate from its static params: XLA folds it
    return np.asarray(jax.jit(lambda: jphred.phred_to_prob(rate))())


@pytest.mark.parametrize("rate", range(phred.PINNED_POST_UMI_RATES))
def test_table_is_the_jax_jitted_table_bit_for_bit_at_integer_rate(rate):
    want = _jax_jit_table(float(rate))
    pinned = phred.pinned_post_umi_tables()
    assert pinned.shape == (94, 512, 2) and pinned.dtype == np.float32
    np.testing.assert_array_equal(pinned[rate].view(np.uint32), want.view(np.uint32))
    table = phred.log_table(rate, "cpu").numpy()
    np.testing.assert_array_equal(table.view(np.uint32), want.view(np.uint32))


#: the largest ulp distance measured between the torch-computed table at
#: post-UMI 30.5 and the JAX jitted one (torch 2.13 and XLA on x86: 6 ulps
#: on 435 of the 1,024 entries)
MEASURED_MAX_ULPS_30_5 = 6
#: margin for another libm's rounding on the torch side
ULP_MARGIN = 1


def test_non_integer_rate_table_stays_within_the_measured_ulps():
    # a non-integer rate computes its table in torch float32. XLA's float32
    # pow is not correctly rounded, and its two-trials and log steps differ
    # by 1 ulp on more quals, so the chain lands a few ulps off: this
    # bounds it at the measured maximum + margin
    want = _jax_jit_table(30.5)
    got = phred.log_table(30.5, "cpu").numpy()
    d = _ulps(got, want)
    bound = MEASURED_MAX_ULPS_30_5 + ULP_MARGIN
    assert d.max() <= bound, f"max {d.max()} ulps at {np.argwhere(d > bound)[:5]}"


def test_pre_umi_scalar_is_the_static_jax_value_at_every_integer_rate():
    for rate in range(phred.PINNED_POST_UMI_RATES):
        want = _jax_static_pre_umi(float(rate))
        got = np.float32(phred.pre_umi_prob(float(rate)))
        assert got.view(np.uint32) == want.view(np.uint32), rate
    assert phred.PRE_UMI_45_PROB.view(np.uint32) == _jax_static_pre_umi(45.0).view(np.uint32)


def test_params_from_reference_carries_every_field():
    ref = JaxParams(error_rate_pre_umi=40.0, error_rate_post_umi=25.0,
                    min_input_base_quality=3, min_consensus_base_quality=7,
                    consensus_call_overlapping_bases=False, min_reads=2)
    for obj in (ref, dataclasses.asdict(ref)):
        got = ConsensusParams.from_reference(obj)
        assert dataclasses.asdict(got) == dataclasses.asdict(ref)
    with pytest.raises(ValueError, match="unknown"):
        ConsensusParams.from_reference({**dataclasses.asdict(ref), "bogus": 1})


def test_entry_points_run_on_the_card_unless_told_cpu():
    assert resolve_device("cpu").type == "cpu"
    if torch.cuda.is_available():
        assert resolve_device(None).type == "cuda"
    else:
        with pytest.raises(RuntimeError, match="device='cpu'"):
            resolve_device(None)


def test_port_and_smoke_import_neither_jax_nor_the_jax_package():
    # tests/conftest.py imports jax, so the check runs in a fresh process;
    # yaml is blocked too: the card's machine has no PyYAML, so only
    # config.FrameworkConfig.from_yaml may import it, when called
    code = r"""
import importlib, pkgutil, sys
sys.modules["jax"] = None
sys.modules["yaml"] = None
import bsseqconsensusreads_tpu_torch as pkg
names = [m.name for m in pkgutil.walk_packages(pkg.__path__, pkg.__name__ + ".")
         if not m.name.endswith(".__main__")]  # __main__ runs the CLI
for name in names:
    importlib.import_module(name)
import chip_smoke
bad = sorted(m for m in sys.modules
             if m == "bsseqconsensusreads_tpu" or m.startswith("bsseqconsensusreads_tpu.")
             or m.startswith("jax."))
print(len(names), bad)
assert not bad, bad
assert len(names) >= 25, names
host = {"io._nativelib", "io.native", "io.wirepack", "pipeline.ingest", "pipeline.stages",
        "config", "pipeline.workflow", "pipeline.checkpoint", "pipeline.group_umi",
        "pipeline.filter", "pipeline.metrics", "utils.oracle"}
assert host <= {n.split(".", 1)[1] for n in names}, names
"""
    out = subprocess.run(
        [sys.executable, "-c", code], cwd=REPO, capture_output=True, text=True,
        env={**os.environ, "PYTHONPATH": REPO},
    )
    assert out.returncode == 0, out.stdout + out.stderr


if __name__ == "__main__":
    # regenerate the port's pinned tables from the JAX package:
    #   JAX_PLATFORMS=cpu python tests/test_torch_phred.py --write-tables
    if sys.argv[1:] != ["--write-tables"]:
        sys.exit("usage: test_torch_phred.py --write-tables")
    tables = np.stack([_jax_jit_table(float(r)) for r in range(phred.PINNED_POST_UMI_RATES)])
    np.save(phred.POST_UMI_TABLES_FILE, tables.astype(np.float32))
    print(phred.POST_UMI_TABLES_FILE, tables.shape)
