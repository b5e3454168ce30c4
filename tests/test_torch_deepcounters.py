"""The molecular vote plans' counters ('vote.' in a stage's Metrics
counters): what each seg_vote launch puts on the deep tiles and on the
packed kernel, counted on the host from the deep plan (ops.cuda_vote
.plan_counts) where pipeline.calling dispatches the molecular vote.

* plan_counts against hand counts for a packed, a deep and two
  packed+deep launches (units of several segments, and of one);
* on the CPU twin's path, the stage's counters equal plan_counts summed
  over the seg_vote calls it really made, and the deep and packed rows
  add up to the rows those calls voted — packed rows, the padded
  envelope and the padded deep route, on one device and on a mesh;
* the counters stay out of the ledger line, which equals the JAX
  package's with or without them.
"""

import numpy as np
import pytest

from bsseqconsensusreads_tpu.pipeline import calling as jcalling
from bsseqconsensusreads_tpu.utils import observe as jobserve
from bsseqconsensusreads_tpu_torch.models.molecular import regular_offsets
from bsseqconsensusreads_tpu_torch.models.params import ConsensusParams
from bsseqconsensusreads_tpu_torch.ops import cuda_vote
from bsseqconsensusreads_tpu_torch.parallel.mesh import make_mesh
from bsseqconsensusreads_tpu_torch.pipeline import calling
from bsseqconsensusreads_tpu_torch.utils import observe
from bsseqconsensusreads_tpu_torch.utils.testing import stream_duplex_families

KEYS = ("vote.deep_rows", "vote.packed_rows", "vote.deep_cells_in", "vote.deep_cells_out",
        "vote.deep_chain_rows")


def _offsets(lens):
    return np.concatenate([[0], np.cumsum(lens)]).astype(np.int32)


#: (segment lengths or host offsets, rows with padding, planes, width, route,
#:  hand counts in KEYS' order)
CASES = {
    # 3 short segments, 4 pad rows: one unit of 32 segments, packed
    "packed": (_offsets([3, 7, 10]), 24, 2, 32, "packed", (0, 20, 0, 0, 0)),
    # the padded deep route's offsets k * T: every segment its own deep unit
    "deep": (regular_offsets(3, 100), 300, 2, 192, "deep",
             (300, 0, 300 * 2 * 192, 3 * 2 * 192, 100)),
    # units of 5 segments (256 threads / (2 * 192 / 8 cells)): units 0 and 2
    # hold a deep segment, so all ten of their segments are the deep tiles'
    "packed+deep, units of 5": (
        _offsets([5, 70, 3, 4, 8, 2, 3, 4, 5, 6, 1, 2, 3, 4, 90]), 216, 2, 192, "packed+deep",
        (190, 20, 190 * 2 * 192, 10 * 2 * 192, 90)),
    # segments averaging more than 64 rows: one segment a unit
    "packed+deep, units of 1": (_offsets([100, 10, 200, 5]), 315, 2, 32, "packed+deep",
                                (300, 15, 300 * 2 * 32, 2 * 2 * 32, 200)),
}


@pytest.mark.parametrize("case", list(CASES))
def test_plan_counts_equal_hand_counts(case):
    offsets, n, p, w, route, want = CASES[case]
    assert cuda_vote.deep_plan(offsets, n, p, w)[2] == route
    got = cuda_vote.plan_counts(offsets, n, p, w)
    assert tuple(got[k] for k in KEYS) == want
    assert got["vote.deep_rows"] + got["vote.packed_rows"] == int(offsets[-1] - offsets[0])


#: templates per strand, family by family: singletons (the host vote),
#: shallow strands, strands at and just past the deep rows, and deep ones
TEMPLATES = [1, 3, 70, 2, 130, 8, 64, 65, 1, 100, 12, 6, 3, 90, 2, 5]


def _run_stage(layout, deep_threshold, monkeypatch, n_data=None):
    calls = []

    def recording(real):
        def launch(bases, quals, offsets, params, *args, **kwargs):
            if bases.shape[1] == 2:  # the two roles' planes: not the singleton qual tables'
                calls.append((offsets.numpy().copy(), *bases.shape))
            return real(bases, quals, offsets, params, *args, **kwargs)
        return launch

    for name in ("seg_vote", "seg_vote_partials"):
        monkeypatch.setattr(cuda_vote, name, recording(getattr(cuda_vote, name)))
    codes = np.random.default_rng(19).integers(0, 4, 6000).astype(np.int8)
    records = stream_duplex_families(codes, len(TEMPLATES),
                                     templates_for=lambda fam: TEMPLATES[fam])
    stats = calling.StageStats(stage="molecular")
    out = list(calling.call_molecular_batches(
        records, ConsensusParams(min_reads=1), mode="self", batch_families=4,
        grouping="coordinate", stats=stats, device="cpu", layout=layout,
        deep_threshold=deep_threshold,
        mesh=None if n_data is None else make_mesh(n_data, devices=["cpu"] * n_data),
    ))
    assert out and calls
    return stats, calls


@pytest.mark.parametrize("layout,deep_threshold,n_data", [
    ("packed", None, None), ("padded", None, None), ("packed", 80, None),
    ("packed", None, 2), ("padded", None, 3), ("packed", 80, 2)])
def test_stage_counters_are_the_plans_of_the_launches_made(layout, deep_threshold, n_data,
                                                           monkeypatch):
    """One device, and a mesh of CPU slots: its data shards' packed rows or
    padded envelopes, and the deep route's templates split over its slots
    (seg_vote's partials mode)."""
    stats, calls = _run_stage(layout, deep_threshold, monkeypatch, n_data)
    counters = stats.metrics.counters
    want = dict.fromkeys(KEYS, 0)
    for offsets, n, p, w in calls:
        for k, v in cuda_vote.plan_counts(offsets, n, p, w).items():
            want[k] += v
    assert {k: counters[k] for k in KEYS} == want
    voted = sum(int(off[-1] - off[0]) for off, *_shape in calls)
    assert counters["vote.deep_rows"] + counters["vote.packed_rows"] == voted
    assert counters["vote.deep_rows"] > 0 and counters["vote.packed_rows"] > 0
    if layout == "packed" and deep_threshold is None:  # every device-voted template once
        singles = 0 if n_data else 2 * TEMPLATES.count(1)  # a mesh votes them too
        assert voted == 2 * sum(TEMPLATES) - singles
    if deep_threshold is not None:
        assert counters["deep_routed_families"] == 2 * sum(t > 80 for t in TEMPLATES)


def test_vote_counters_stay_out_of_the_ledger_line(monkeypatch):
    stats, _calls = _run_stage("packed", None, monkeypatch)
    assert all(k in stats.metrics.counters for k in KEYS)
    line = stats.as_dict()
    assert not [k for k in line if k.startswith(observe.VOTE_PREFIX)]
    assert line["route_batches_single"] == stats.metrics.counters["route_batches_single"]


def test_the_ledger_line_with_vote_counters_equals_the_jax_packages():
    out = []
    for calling_mod, lib, extra in ((calling, observe, True), (jcalling, jobserve, False)):
        st = calling_mod.StageStats(stage="molecular", metrics=lib.Metrics())
        st.records_in, st.families, st.consensus_out, st.batches = 40, 20, 20, 3
        st.pad_cells, st.used_cells, st.wall_seconds = 30, 90, 12.5
        st.metrics.count("route_batches_single", 3)
        if extra:
            for k in KEYS:
                st.metrics.count(k, 7)
        out.append(list(st.as_dict().items()))
    assert out[0] == out[1]
