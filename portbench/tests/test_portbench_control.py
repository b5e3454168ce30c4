"""The control: the reference in bfloat16 (the type below the float32
the configuration states for the vote) in the program's place must come
out not correct where the outputs depend on the vote's precision."""

import pytest
import torch

from harness import check, genome as genome_mod, traffic
from helpers import TINY_GENOME, tiny_cell


@pytest.fixture(scope="module")
def genome():
    return genome_mod.make_genome(torch, TINY_GENOME, 77, "cpu")


@pytest.mark.parametrize("name,families,sample", [("emseq_wgs_duplex.dup4", 200, 120),
                                                  ("emseq_wgs_duplex.lowpass", 200, 120)])
def test_control_is_not_correct(tmp_path, genome, name, families, sample):
    cell = tiny_cell(name, families, sample)
    inp = traffic.make_pass(cell.config, cell.mix, genome, 5, str(tmp_path / "in.bam"),
                            sample=sample)
    numbers = check.control_numbers(inp, genome, cell.config)
    assert any(v > cell.limits[k] for k, v in numbers.items()), numbers
    assert numbers["qual_mismatch_ppm"] > cell.limits["qual_mismatch_ppm"]

