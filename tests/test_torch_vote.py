"""The port's vote (ops.cuda_vote plain versions, models.molecular) against
the JAX package's XLA legs and its Pallas interpret legs, on the CPU.

Inputs are made from a seed with numpy and handed to both packages.
Tolerance: bit-equal against the XLA legs and vote_finalize_groups; tie-
aware against column_vote_groups (its factored sum reorders the adds, as
tests/test_pallas.py already treats it)."""

import jax
import numpy as np
import pytest
import torch

from bsseqconsensusreads_tpu.models import duplex as jdx
from bsseqconsensusreads_tpu.models import molecular as jm
from bsseqconsensusreads_tpu.models.params import ConsensusParams as JaxParams
from bsseqconsensusreads_tpu.ops.encode import (
    FamilyMeta,
    MolecularBatch,
    pack_molecular_rows,
)
from bsseqconsensusreads_tpu.ops.pallas_vote import (
    column_vote_groups,
    vote_finalize_groups,
)
from bsseqconsensusreads_tpu_torch.models import duplex as tdx
from bsseqconsensusreads_tpu_torch.models import molecular as tm
from bsseqconsensusreads_tpu_torch.models.params import ConsensusParams
from bsseqconsensusreads_tpu_torch.ops import cuda_vote

KEYS = ("base", "qual", "depth", "errors")
RTA3 = np.array([2, 12, 23, 37], np.uint8)

PARAMS = {
    "default": {},
    "min_input_q20": {"min_input_base_quality": 20},
    "min_consensus_q30": {"min_consensus_base_quality": 30},
    "no_cocall": {"consensus_call_overlapping_bases": False},
}


def _both(**kw):
    return JaxParams(**kw), ConsensusParams(**kw)


def _families(seed, f, t, w, qual_pool=None, p_n=0.05):
    """Padded [F, T, 2, W] batch with ragged template counts; pad slots
    stay NBASE/0, a few all-N columns, RTA3 or random quals."""
    rng = np.random.default_rng(seed)
    n_tpl = rng.integers(1, t + 1, size=f)
    bases = np.full((f, t, 2, w), 4, np.int8)
    quals = np.zeros((f, t, 2, w), np.uint8)
    truth = rng.integers(0, 4, size=(f, w)).astype(np.int8)
    for i in range(f):
        for j in range(n_tpl[i]):
            for r in range(2):
                s = int(rng.integers(0, w // 3))
                e = min(w, s + int(rng.integers(w // 3, w)))
                obs = truth[i, s:e].copy()
                flip = rng.random(e - s) < 0.1
                obs[flip] = rng.integers(0, 4, int(flip.sum()))
                obs[rng.random(e - s) < p_n] = 4
                bases[i, j, r, s:e] = obs
                quals[i, j, r, s:e] = (
                    rng.choice(qual_pool, e - s) if qual_pool is not None
                    else rng.integers(0, 94, e - s)
                )
    bases[:, :, :, w - 3:] = 4  # empty columns at the window's end
    quals[:, :, :, w - 3:] = 0
    meta = [FamilyMeta(str(i), 0, 0, int(n_tpl[i])) for i in range(f)]
    return MolecularBatch(bases, quals, meta)


def _assert_equal(got, want):
    for k in KEYS:
        a = np.asarray(want[k])
        b = got[k].numpy() if isinstance(got[k], torch.Tensor) else np.asarray(got[k])
        assert a.dtype == b.dtype, (k, a.dtype, b.dtype)
        np.testing.assert_array_equal(b, a, err_msg=k)


@pytest.mark.parametrize("name", sorted(PARAMS))
def test_packed_vote_is_bit_equal_to_the_jax_xla_leg(name):
    jp, tp = _both(**PARAMS[name])
    batch = _families(1, f=40, t=4, w=96, qual_pool=RTA3)
    pk = pack_molecular_rows(batch)
    assert pk.bases.shape[0] > pk.n_real_rows  # sentinel pad rows present
    want = jm.molecular_consensus_packed(
        pk.bases, pk.quals, pk.seg, pk.num_families, jp, "xla"
    )
    got = tm.molecular_consensus_packed(
        torch.from_numpy(pk.bases), torch.from_numpy(pk.quals),
        torch.from_numpy(pk.seg), pk.num_families, tp,
    )
    _assert_equal(got, want)


@pytest.mark.parametrize("rate", [20, 0])
def test_packed_vote_is_bit_equal_to_the_jax_xla_leg_at_post_umi_rate(rate):
    # a non-default integer rate reads its own pinned table: the vote, not
    # only the table, must match the JAX leg there (random quals 0..93 touch
    # every table entry the path can index below the co-call sums)
    jp, tp = _both(error_rate_post_umi=float(rate))
    batch = _families(8 + rate, f=40, t=4, w=96)
    pk = pack_molecular_rows(batch)
    want = jm.molecular_consensus_packed(
        pk.bases, pk.quals, pk.seg, pk.num_families, jp, "xla"
    )
    got = tm.molecular_consensus_packed(
        torch.from_numpy(pk.bases), torch.from_numpy(pk.quals),
        torch.from_numpy(pk.seg), pk.num_families, tp,
    )
    _assert_equal(got, want)


def _segment_rows(seed, lens, w, planes=2, pad_rows=3):
    """Segment-packed rows [N, planes, W] for segments of the given lengths
    (0 = an empty segment), ascending ids, `pad_rows` sentinel rows at the
    end; reads start and end anywhere in the window, RTA3 quals, 5% N."""
    rng = np.random.default_rng(seed)
    lens = np.asarray(lens)
    n = int(lens.sum()) + pad_rows
    bases = np.full((n, planes, w), 4, np.int8)
    quals = np.zeros((n, planes, w), np.uint8)
    truth = rng.integers(0, 4, size=(len(lens), w)).astype(np.int8)
    seg = np.concatenate([np.repeat(np.arange(len(lens), dtype=np.int32), lens),
                          np.full(pad_rows, len(lens), np.int32)])
    for r in range(n - pad_rows):
        for p in range(planes):
            s = int(rng.integers(0, w - 8))
            e = int(rng.integers(s + 8, w + 1))
            obs = truth[seg[r], s:e].copy()
            flip = rng.random(e - s) < 0.1
            obs[flip] = rng.integers(0, 4, int(flip.sum()))
            obs[rng.random(e - s) < 0.05] = 4
            bases[r, p, s:e] = obs
            quals[r, p, s:e] = rng.choice(RTA3, e - s)
    return bases, quals, seg


#: the shapes a tiled kernel gets wrong first: empty segments (pad families
#: of a pow2 bucket), one deep segment among short ones, widths that are
#: multiples of 32 but not powers of two, and the input-qual filter
EDGE_SHAPES = {
    "empty_segments": dict(lens=[0, 2, 0, 0, 3, 1, 0, 4, 0], w=96, kw={}),
    "deep_segment": dict(lens=[1, 2, 300, 1, 3, 2], w=64, kw={}),
    "w160": dict(lens=[1, 3, 2, 5, 1, 2, 1, 4], w=160, kw={}),
    "w224": dict(lens=[2, 1, 1, 3, 6, 2], w=224, kw={}),
    "min_input_q20": dict(lens=[3, 1, 0, 2, 5, 2], w=96, kw={"min_input_base_quality": 20}),
}


@pytest.mark.parametrize("name", sorted(EDGE_SHAPES))
def test_packed_vote_edge_shapes_are_bit_equal_to_the_jax_xla_leg(name):
    case = EDGE_SHAPES[name]
    jp, tp = _both(**case["kw"])
    bases, quals, seg = _segment_rows(len(name), case["lens"], case["w"])
    nf = len(case["lens"])
    want = jm.molecular_consensus_packed(bases, quals, seg, nf, jp, "xla")
    got = tm.molecular_consensus_packed(
        torch.from_numpy(bases), torch.from_numpy(quals), torch.from_numpy(seg), nf, tp,
    )
    _assert_equal(got, want)
    assert (got["depth"].numpy()[np.asarray(case["lens"]) == 0] == 0).all()


@pytest.mark.parametrize("w", [96, 160])
def test_duplex_vote_with_input_qual_filter_is_bit_equal_to_the_jax_xla_leg(w):
    # one plane of 2-row segments (the duplex merge's seg_vote) under
    # min_input_base_quality 20
    kw = {"min_reads": 0, "min_input_base_quality": 20}
    jp, tp = JaxParams(**kw), ConsensusParams(**kw)
    bases, quals, _ = _segment_rows(w, [4] * 12, w, planes=1, pad_rows=0)
    bases, quals = bases.reshape(12, 4, w), quals.reshape(12, 4, w)
    want = jdx.duplex_consensus_packed(bases, quals.astype(np.float32), jp, "xla")
    got = tdx.duplex_consensus_packed(
        torch.from_numpy(bases), torch.from_numpy(quals.astype(np.int16)), tp
    )
    for k in want:
        np.testing.assert_array_equal(got[k].numpy(), np.asarray(want[k]), err_msg=k)


@pytest.mark.parametrize("t", [1, 3, 8])
def test_padded_vote_is_bit_equal_to_the_jax_xla_leg(t):
    jp, tp = _both(min_input_base_quality=20 if t == 3 else 0)
    batch = _families(2 + t, f=12, t=t, w=64)
    want = jm.molecular_consensus(batch.bases, batch.quals, jp)
    got = tm.molecular_consensus(
        torch.from_numpy(batch.bases), torch.from_numpy(batch.quals), tp
    )
    _assert_equal(got, want)


def test_deep_padded_vote_is_bit_equal_to_the_jax_xla_leg():
    # the deep route's dispatch shape: 4,097 real templates padded to the
    # 5,120 bucket, per-column depths far past an 8-bit count
    rng = np.random.default_rng(77)
    t, w, real = 5120, 32, 4097
    truth = rng.integers(0, 4, w).astype(np.int8)
    bases = np.full((1, t, 2, w), 4, np.int8)
    quals = np.zeros((1, t, 2, w), np.uint8)
    obs = np.broadcast_to(truth, (real, 2, w)).copy()
    flip = rng.random(obs.shape) < 0.1
    obs[flip] = rng.integers(0, 4, int(flip.sum()))
    bases[0, :real] = obs
    quals[0, :real] = rng.choice(RTA3, (real, 2, w))
    jp, tp = _both()
    want = jm.molecular_consensus(bases, quals, jp)
    got = tm.molecular_consensus(torch.from_numpy(bases), torch.from_numpy(quals), tp)
    _assert_equal(got, want)
    assert 3000 < got["depth"].max() <= real  # co-calling masks disagreements
    assert got["depth"].dtype == torch.int16


def test_exact_ties_call_the_lowest_base_like_the_jax_leg():
    # two observations per column, different bases, equal quals: an exact
    # log-likelihood tie in every column
    f, w = 4, 32
    bases = np.full((f, 2, 2, w), 4, np.int8)
    quals = np.zeros((f, 2, 2, w), np.uint8)
    rng = np.random.default_rng(3)
    for i in range(f):
        a = rng.integers(0, 4, w)
        bases[i, 0, 0] = a
        bases[i, 1, 0] = (a + 1 + rng.integers(0, 3, w)) % 4
        quals[i, :, 0] = rng.choice(RTA3, w)[None, :]
    jp, tp = _both(consensus_call_overlapping_bases=False)
    want = jm.molecular_consensus(bases, quals, jp)
    got = tm.molecular_consensus(torch.from_numpy(bases), torch.from_numpy(quals), tp)
    _assert_equal(got, want)
    called = got["base"].numpy()[:, 0]
    np.testing.assert_array_equal(called, np.minimum(bases[:, 0, 0], bases[:, 1, 0]))


def test_segment_partials_and_finalize_match_jax_bit_for_bit():
    jp, tp = _both()
    batch = _families(4, f=24, t=4, w=64, qual_pool=RTA3)
    pk = pack_molecular_rows(batch)
    jb, jq = jm.overlap_cocall(pk.bases, pk.quals.astype(np.float32))
    # jitted, as every production program runs it: the table the port pins
    # is the jitted one (eager JAX rounds a few log terms differently)
    partials = jax.jit(
        jm.vote_partials_segments, static_argnames=("num_segments", "params")
    )
    jll, jcnt, jdepth = partials(
        jb, jq, pk.seg, num_segments=pk.num_families + 1, params=jp
    )
    tb, tq = tm.overlap_cocall(
        torch.from_numpy(pk.bases), torch.from_numpy(pk.quals).to(torch.int16)
    )
    np.testing.assert_array_equal(tb.numpy(), np.asarray(jb))
    np.testing.assert_array_equal(tq.numpy(), np.asarray(jq).astype(np.int16))
    offsets = tm.segment_offsets(torch.from_numpy(pk.seg), pk.num_families)
    ll, cnt, depth = tm.vote_partials_segments(tb, tq, offsets, tp)
    nf = pk.num_families
    np.testing.assert_array_equal(
        ll.numpy().view(np.uint32), np.asarray(jll)[:nf].view(np.uint32)
    )
    np.testing.assert_array_equal(cnt.numpy(), np.asarray(jcnt)[:nf])
    np.testing.assert_array_equal(depth.numpy(), np.asarray(jdepth)[:nf])

    want = jm.vote_finalize(jll[:nf], jdepth[:nf], jp)
    pallas = vote_finalize_groups(jll[:nf], jdepth[:nf], jp, interpret=True)
    got = cuda_vote.vote_finalize(ll, depth, tp)
    for w_, p_, g_ in zip(want, pallas, got):
        np.testing.assert_array_equal(g_.numpy(), np.asarray(w_))
        np.testing.assert_array_equal(g_.numpy(), np.asarray(p_))
    errors = tm.errors_from_counts(cnt, depth, got[0])
    np.testing.assert_array_equal(
        errors.numpy(), np.asarray(jm.errors_from_counts(jcnt[:nf], jdepth[:nf], want[0]))
    )


@pytest.mark.parametrize("g,t,w", [(6, 5, 40), (8, 1, 24)])
def test_padded_vote_matches_the_pallas_interpret_leg_tie_aware(g, t, w):
    rng = np.random.default_rng(g * 100 + t)
    bases = rng.integers(0, 5, size=(g, t, w)).astype(np.int8)
    quals = np.where(bases != 4, rng.integers(2, 41, size=(g, t, w)), 0)
    jp, tp = _both()
    want = column_vote_groups(bases, quals.astype(np.float32), jp, interpret=True)
    offsets = torch.arange(0, g * t + 1, t, dtype=torch.int32)
    got = cuda_vote.seg_vote(
        torch.from_numpy(bases).reshape(g * t, 1, w),
        torch.from_numpy(quals.astype(np.int16)).reshape(g * t, 1, w),
        offsets, tp, with_ll=True,
    )
    top2 = np.sort(got["ll"].numpy()[:, 0], axis=-1)[..., -2:]
    tie = np.abs(top2[..., 1] - top2[..., 0]) <= 1e-4
    for k in KEYS:
        a, b = got[k].numpy()[:, 0].astype(int), np.asarray(want[k]).astype(int)
        np.testing.assert_array_equal(a[~tie], b[~tie], err_msg=k)
    np.testing.assert_array_equal(
        got["depth"].numpy()[:, 0][tie], np.asarray(want["depth"])[tie]
    )
    dq = np.abs(got["qual"].numpy()[:, 0].astype(int) - np.asarray(want["qual"]).astype(int))
    assert (dq[tie] <= 1).all()


@pytest.mark.parametrize("hist", [False, True])
def test_singleton_host_path_matches_jax(hist):
    jp, tp = _both()
    batch = _families(5, f=30, t=1, w=64, qual_pool=np.array([0, 1, 2, 12, 23, 37, 41], np.uint8))
    want = jm.singleton_consensus_host(
        batch.bases, batch.quals, jp, "xla", with_histogram=hist
    )
    got = tm.singleton_consensus_host(
        batch.bases, batch.quals, tp, "cpu", with_histogram=hist
    )
    assert sorted(got) == sorted(want)
    for k in want:
        np.testing.assert_array_equal(got[k], want[k], err_msg=k)


def test_host_count_helpers_and_output_wire_match_jax():
    jp, tp = _both()
    batch = _families(6, f=10, t=3, w=64, qual_pool=RTA3)
    out = jm.molecular_consensus(batch.bases, batch.quals, jp)
    tout = tm.molecular_consensus(
        torch.from_numpy(batch.bases), torch.from_numpy(batch.quals), tp
    )
    wire = np.asarray(jm.pack_molecular_outputs(out)).view(np.uint8)
    twire = tm.pack_molecular_outputs(tout).numpy()
    np.testing.assert_array_equal(twire, wire)
    f, w = batch.bases.shape[0], batch.bases.shape[-1]
    unpacked = tm.unpack_molecular_outputs(twire, f, w)
    for k, v in jm.unpack_molecular_outputs(wire, f, w).items():
        np.testing.assert_array_equal(unpacked[k], v, err_msg=k)
    host = {k: np.asarray(v) for k, v in out.items()}
    for hist in (False, True):
        a = tm.recompute_molecular_counts(host, batch.bases, batch.quals, tp, hist)
        b = jm.recompute_molecular_counts(host, batch.bases, batch.quals, jp, hist)
        for k in b:
            np.testing.assert_array_equal(a[k], b[k], err_msg=k)
    counts = tm.molecular_base_counts(batch.bases, batch.quals, tp)
    np.testing.assert_array_equal(
        counts, jm.molecular_base_counts(batch.bases, batch.quals, jp)
    )
    np.testing.assert_array_equal(
        tm.sparsify_base_counts(counts, host["base"]),
        jm.sparsify_base_counts(counts, host["base"]),
    )


def test_wrappers_take_the_plain_version_on_cpu_tensors_and_count_nothing():
    tp = ConsensusParams()
    batch = _families(7, f=8, t=2, w=32, qual_pool=RTA3)
    b = torch.from_numpy(batch.bases).reshape(16, 2, 32)
    q = torch.from_numpy(batch.quals).to(torch.int16).reshape(16, 2, 32)
    off = torch.arange(0, 17, 2, dtype=torch.int32)
    for k in cuda_vote.LAUNCHES:
        cuda_vote.LAUNCHES[k] = 0
    got = cuda_vote.seg_vote(b, q, off, tp, with_ll=True)
    want = cuda_vote.seg_vote_plain(b, q, off, tp, with_ll=True)
    for k in want:
        torch.testing.assert_close(got[k], want[k], rtol=0, atol=0)
    ll = want["ll"].reshape(-1, 32, 4)
    depth = want["depth"].reshape(-1, 32).to(torch.int32)
    fb, fq = cuda_vote.vote_finalize(ll, depth, tp)
    torch.testing.assert_close(fb, want["base"].reshape(-1, 32), rtol=0, atol=0)
    torch.testing.assert_close(fq, want["qual"].reshape(-1, 32), rtol=0, atol=0)
    assert cuda_vote.LAUNCHES == {"seg_vote": 0, "vote_finalize": 0}
    # a tensor that is neither on the CPU nor on the card is refused, not
    # silently voted on the host
    with pytest.raises(ValueError, match="CPU or CUDA"):
        cuda_vote.seg_vote(b.to("meta"), q.to("meta"), off.to("meta"), tp)
