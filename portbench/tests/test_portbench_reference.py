"""The plain reference against the program's CPU path: a tiny genome,
a few families of each mix, every record field equal."""

import os

import pytest
import torch

from harness import chain, check, genome as genome_mod, traffic
from helpers import TINY_GENOME, tiny_cell

CELLS = [("emseq_wgs_duplex.dup4", 160, 60), ("emseq_wgs_duplex.lowpass", 200, 80)]
#: deep families on a few targets: no shipped cell yet, but the generator
#: offers them to a later configuration (PERF.md, Open questions)
PANEL = {"placement": {"kind": "targets", "targets": 3, "target_width": 200},
         "chemistry": "bisulfite"}
DEEP = {"per": "strand", "templates": {"kind": "uniform", "lo": 65, "hi": 256}}


@pytest.fixture(scope="module")
def genome():
    return genome_mod.make_genome(torch, TINY_GENOME, 2024, "cpu")


@pytest.mark.parametrize("name,families,sample,config,mix",
                         [c + ({}, {}) for c in CELLS]
                         + [("emseq_wgs_duplex.dup4", 6, 3, PANEL, DEEP)])
def test_reference_equals_the_programs_cpu_path(tmp_path, genome, name, families, sample,
                                                config, mix):
    cell = tiny_cell(name, families, sample)
    cell.config.update(config)
    cell.mix.update(mix)
    inp = traffic.make_pass(cell.config, cell.mix, genome, 31337, str(tmp_path / "in.bam"),
                            sample=sample)
    res = chain.Chain(cell.config, genome, "cpu").run_pass(inp.path, str(tmp_path), "p")
    numbers = check.check_pass(inp, res, genome, cell.config)
    assert numbers == {"records_missing": 0.0, "base_mismatch_ppm": 0.0,
                       "qual_mismatch_ppm": 0.0, "tag_mismatch_ppm": 0.0}
    assert len(inp.sample_reads) >= sample
    assert os.path.getsize(res.out) > 0
