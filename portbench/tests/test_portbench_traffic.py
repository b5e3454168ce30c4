"""The generator: deterministic by seed, the same work for every seed,
and the family-size distributions its mixes name."""

import numpy as np
import pytest
import torch

from harness import genome as genome_mod
from harness import traffic
from helpers import TINY_GENOME, tiny_cell


@pytest.fixture(scope="module")
def genome():
    return genome_mod.make_genome(torch, TINY_GENOME, 11, "cpu")


def _pass(tmp_path, genome, cell, seed, tag):
    return traffic.make_pass(cell.config, cell.mix, genome, seed, str(tmp_path / f"{tag}.bam"),
                             sample=5)


def test_same_seed_same_bytes_other_seed_same_work(tmp_path, genome):
    cell = tiny_cell("emseq_wgs_duplex.dup4", 300, 5)
    a = _pass(tmp_path, genome, cell, 2**31 + 7, "a")
    b = _pass(tmp_path, genome, cell, 2**31 + 7, "b")
    c = _pass(tmp_path, genome, cell, 2**31 + 8, "c")
    assert open(a.path, "rb").read() == open(b.path, "rb").read()
    assert open(a.path, "rb").read() != open(c.path, "rb").read()
    assert a.reads == c.reads
    assert sorted(a.templates.reshape(-1)) == sorted(c.templates.reshape(-1))
    assert not np.array_equal(a.templates, c.templates)


def test_genome_is_the_seeds():
    a = genome_mod.make_genome(torch, [1000, 500], 5, "cpu")
    b = genome_mod.make_genome(torch, [1000, 500], 5, "cpu")
    c = genome_mod.make_genome(torch, [1000, 500], 6, "cpu")
    assert np.array_equal(a.codes, b.codes) and not np.array_equal(a.codes, c.codes)
    assert set(np.unique(a.codes)) == {0, 1, 2, 3}
    assert a.fetch_str("chr2", 498, 505) == "ACGT"[a.codes[1498]] + "ACGT"[a.codes[1499]]


@pytest.mark.parametrize("dist,mean,lo,hi", [
    ({"kind": "zt_poisson", "mean": 4.0, "max": 12}, 4.07, 1, 12),
    ({"kind": "uniform", "lo": 65, "hi": 256}, 160.5, 65, 256),
    ({"kind": "choice", "values": [1, 2], "weights": [0.7, 0.3]}, 1.3, 1, 2),
])
def test_family_sizes_follow_the_mix(dist, mean, lo, hi):
    t = traffic.template_counts(dist, 20_000)
    assert t.min() == lo and t.max() == hi
    assert abs(t.mean() - mean) < 0.02 * mean


def test_zt_poisson_histogram():
    t = traffic.template_counts({"kind": "zt_poisson", "mean": 4.0, "max": 12}, 100_000)
    k = np.arange(1, 13)
    p = np.exp(k * np.log(4.0) - 4.0 - np.cumsum(np.log(k)))
    p /= p.sum()
    got = np.bincount(t, minlength=13)[1:] / t.size
    assert np.allclose(got, p, atol=1e-4)


def test_records_are_coordinate_sorted_and_grouped(tmp_path, genome):
    from harness import bamio

    cell = tiny_cell("emseq_wgs_duplex.lowpass", 200, 5)
    p = _pass(tmp_path, genome, cell, 99, "s")
    buf = bamio.inflate_bgzf(p.path)
    start, refs = bamio.read_header(buf)
    assert refs == [("chr1", 300_000), ("chr2", 200_000)]
    recs = [bamio.decode_record(buf, o) for o in bamio.record_offsets(buf, start)]
    assert len(recs) == p.reads == 2 * 2 * 200 * 1.3
    keys = [(r["ref_id"], r["pos"]) for r in recs]
    assert keys == sorted(keys)
    assert {r["flag"] for r in recs} == {99, 147, 163, 83}
    assert all(r["cigar"] == [(0, 150)] and len(r["seq"]) == 150 for r in recs)
    assert all(r["tags"]["MI"].endswith(("/A", "/B")) for r in recs)
