"""The port's pinned log-likelihood table and scalar against the JAX
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


def test_pinned_table_is_the_jax_jitted_table_bit_for_bit():
    want = _jax_jit_table(30.0)
    got = phred.LOG_TABLE_POST_UMI_30
    assert got.shape == (512, 2) and got.dtype == np.float32
    np.testing.assert_array_equal(got.view(np.uint32), want.view(np.uint32))
    table = phred.log_table(30.0, "cpu").numpy()
    np.testing.assert_array_equal(table.view(np.uint32), want.view(np.uint32))


def test_pre_umi_scalar_is_the_jax_value_bit_for_bit():
    want = np.asarray(jax.jit(lambda x: jphred.phred_to_prob(x))(jnp.float32(45.0)))
    got = np.float32(phred.pre_umi_prob(45.0))
    assert got.view(np.uint32) == want.view(np.uint32)
    assert phred.PRE_UMI_45_PROB.view(np.uint32) == want.view(np.uint32)


#: post-UMI rate -> the largest ulp distance measured between the
#: torch-computed table and the JAX jitted one (torch 2.13 and XLA on x86)
MEASURED_MAX_ULPS = {15.0: 3, 20.0: 4, 25.0: 5, 40.0: 7}
#: margin for another libm's rounding on the torch side
ULP_MARGIN = 1


@pytest.mark.parametrize("rate", sorted(MEASURED_MAX_ULPS))
def test_torch_computed_table_stays_within_the_measured_ulps(rate):
    # any rate but the pinned 30 computes its table in torch float32. XLA's
    # float32 pow is not correctly rounded (even 10**x rounded from float64
    # differs from it on ~150 of 512 quals), and its two-trials and log
    # steps differ by 1 ulp on a few more, so the chain lands a few ulps off
    # on 2-3% of the entries: this bounds it at the measured maximum + margin
    want = _jax_jit_table(rate)
    got = phred.log_table(rate, "cpu").numpy()
    d = _ulps(got, want)
    bound = MEASURED_MAX_ULPS[rate] + ULP_MARGIN
    assert d.max() <= bound, f"max {d.max()} ulps at {np.argwhere(d > bound)[:5]}"
    assert (d > 0).mean() <= 0.05, f"{int((d > 0).sum())} of {d.size} entries differ"


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
    # tests/conftest.py imports jax, so the check runs in a fresh process
    code = r"""
import importlib, pkgutil, sys
sys.modules["jax"] = None
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
assert len(names) >= 20, names
"""
    out = subprocess.run(
        [sys.executable, "-c", code], cwd=REPO, capture_output=True, text=True,
        env={**os.environ, "PYTHONPATH": REPO},
    )
    assert out.returncode == 0, out.stdout + out.stderr
