"""The plain reference against the program's CPU path on the deep panel
(methyl_panel_deep.deep): a tiny genome, a pass of the cell's own
configuration and mix whose strands run from a few templates to hundreds,
every record field equal, under both chemistries; the program's vote
plans put rows on the deep tiles and on the packed kernel both."""

import pytest
import torch

from harness import chain, check, genome as genome_mod, traffic
from helpers import TINY_GENOME, tiny_cell

CELL = "methyl_panel_deep.deep"
FAMILIES, SAMPLE = 10, 10


@pytest.fixture(scope="module")
def genome():
    return genome_mod.make_genome(torch, TINY_GENOME, 2025, "cpu")


@pytest.mark.parametrize("chemistry", ["emseq", "bisulfite"])
def test_reference_equals_the_programs_cpu_path_on_deep_families(tmp_path, genome, chemistry):
    cell = tiny_cell(CELL, FAMILIES, SAMPLE)
    cell.config["chemistry"] = chemistry
    inp = traffic.make_pass(cell.config, cell.mix, genome, 2**31 + 19, str(tmp_path / "in.bam"),
                            sample=SAMPLE)
    assert inp.templates.max() > 64 and inp.templates.min() <= 8
    res = chain.Chain(cell.config, genome, "cpu").run_pass(inp.path, str(tmp_path), "p")
    numbers = check.check_pass(inp, res, genome, cell.config)
    assert numbers == {"records_missing": 0.0, "base_mismatch_ppm": 0.0,
                       "qual_mismatch_ppm": 0.0, "tag_mismatch_ppm": 0.0}
    counters = res.stats["molecular"].metrics.counters
    if "vote.deep_rows" in counters:  # the program counts its vote plans
        assert counters["vote.deep_rows"] > 0 and counters["vote.packed_rows"] > 0
        assert counters["vote.deep_rows"] + counters["vote.packed_rows"] == int(
            inp.templates.sum())
        assert counters["vote.deep_chain_rows"] >= int(inp.templates.max())
