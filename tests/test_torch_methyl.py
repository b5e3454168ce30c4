"""The port's methylation extraction (methyl/context, methyl/tally,
methyl/emit, the methyl dispatch variants of models/duplex and their
wiring through call_duplex_batches, the stage runner and the CLI) on the
CPU against the JAX package's.

Tolerance: bit/byte equality throughout. The epilogue is integer-only, so
its planes must be bit-equal between the port's torch epilogue, its numpy
twin and the JAX package's jitted methyl_epilogue; the merged tallies
array-equal; the bedMethyl and CX files SHA-equal to the JAX package's
over both transports, both host engines and both methyl engines; the
consensus BAM unchanged by methyl. Inputs are made from seeds with numpy:
randomized planes with N reference cells and extension windows that run
off their contig, the JAX package's methyl fixture (two contigs, a window
past a contig's end, an unmapped family, a FASTA whose contig order is
not the BAM header's), and a bisulfite stream_duplex_families mixture
through `run`."""

import hashlib
import json
import os
from functools import partial

import jax
import numpy as np
import pytest
import torch

from bsseqconsensusreads_tpu import config as jconfig
from bsseqconsensusreads_tpu.io.bam import BamHeader, BamReader, BamWriter
from bsseqconsensusreads_tpu.methyl import context as jctx
from bsseqconsensusreads_tpu.methyl import tally as jtally
from bsseqconsensusreads_tpu.models import duplex as jd
from bsseqconsensusreads_tpu.models.params import ConsensusParams as JaxParams
from bsseqconsensusreads_tpu.ops import refstore as jrs
from bsseqconsensusreads_tpu.pipeline import calling as jc
from bsseqconsensusreads_tpu.pipeline import extsort as je
from bsseqconsensusreads_tpu.pipeline import stages as jstages
from bsseqconsensusreads_tpu.utils.testing import (
    make_aligned_duplex_group,
    random_genome,
    stream_duplex_families,
    write_fasta,
)
from bsseqconsensusreads_tpu_torch import cli
from bsseqconsensusreads_tpu_torch import config as pconfig
from bsseqconsensusreads_tpu_torch.io.bam import BamReader as PortReader
from bsseqconsensusreads_tpu_torch.methyl import context as tctx
from bsseqconsensusreads_tpu_torch.methyl import tally as ttally
from bsseqconsensusreads_tpu_torch.models import duplex as td
from bsseqconsensusreads_tpu_torch.models.params import ConsensusParams
from bsseqconsensusreads_tpu_torch.ops import refstore as trs
from bsseqconsensusreads_tpu_torch.ops import wire as tw
from bsseqconsensusreads_tpu_torch.ops.encode import codes_to_seq
from bsseqconsensusreads_tpu_torch.pipeline import calling as tc
from bsseqconsensusreads_tpu_torch.pipeline import checkpoint as pcheckpoint
from bsseqconsensusreads_tpu_torch.pipeline import stages as pstages
from bsseqconsensusreads_tpu_torch.pipeline import workflow as pwf
from bsseqconsensusreads_tpu_torch.utils.observe import Metrics

_A, _C, _G, _T, _N = 0, 1, 2, 3, 4
RTA3 = np.array([2, 12, 23, 37], np.uint8)


def _sha(path: str) -> str:
    with open(path, "rb") as fh:
        return hashlib.sha256(fh.read()).hexdigest()


def _t(*arrays):
    return [torch.from_numpy(np.ascontiguousarray(a)) for a in arrays]


@partial(jax.jit, static_argnums=6)
def _jax_epilogue(bases, quals, cover, cm, cons, ref_ext, min_q):
    return jctx.methyl_epilogue(bases, quals, cover, cm, cons, ref_ext, min_q)


def _store(order=("chrA", "chrB")):
    """Two contigs, chrA with an N run; the port's and the JAX package's
    store over the same sequences, in `order`."""
    rng = np.random.default_rng(3)
    seqs = {n: "".join("ACGT"[i] for i in rng.integers(0, 4, k))
            for n, k in (("chrA", 900), ("chrB", 600))}
    seqs["chrA"] = seqs["chrA"][:650] + "N" * 10 + seqs["chrA"][660:]
    return (trs.RefStore(list(order), seqs=[seqs[n] for n in order]),
            jrs.RefStore(list(order), seqs=[seqs[n] for n in order]))


def _duplex_batch(seed, f, w, store, min_q_pool=RTA3):
    """Raw duplex planes on windows of `store` with the edge windows
    planted (no contig, past a contig's end, the genome's last base, a
    contig's first base), and the extension windows of those families:
    (bases, quals, cover, convert_mask, eligible, starts, limits, los,
    ref, ref_ext)."""
    rng = np.random.default_rng(seed)
    rid = rng.integers(0, 2, f)
    ws = np.array([int(rng.integers(0, store.lengths[r] - w)) for r in rid])
    rid[0] = -1
    rid[1], ws[1] = 0, store.lengths[0] - w // 2
    rid[2], ws[2] = 1, store.lengths[1] - w - 1
    rid[3], ws[3] = 1, 0
    starts, limits = store.window_offsets(rid, ws)
    los = store.window_origins(rid)
    ref = store.host_windows(starts, limits, w + 1)
    ref_ext = store.host_windows_ext(starts, los, limits, w + 4)
    bases = np.full((f, 4, w), _N, np.int8)
    quals = np.zeros((f, 4, w), np.uint8)
    cover = np.zeros((f, 4, w), bool)
    for i in range(f):
        s0, e0 = int(rng.integers(0, 8)), int(rng.integers(w // 2, w))
        for r in range(4):
            s, e = s0 + int(rng.integers(0, 2)), min(w, e0 - int(rng.integers(0, 2)))
            cover[i, r, s:e] = True
            seq = np.where(ref[i, s:e] == _N, rng.integers(0, 4, e - s), ref[i, s:e])
            # bisulfite-like evidence: some C read as T, some G as A
            conv = rng.random(e - s) < 0.4
            seq = np.where(conv & (seq == _C), _T, np.where(conv & (seq == _G), _A, seq))
            noise = rng.random(e - s) < 0.05
            seq[noise] = rng.integers(0, 4, int(noise.sum()))
            bases[i, r, s:e] = seq
            quals[i, r, s:e] = rng.choice(min_q_pool, e - s)
    cmask = np.zeros((f, 4), bool)
    cmask[:, 1] = cover[:, 1].any(-1)
    cmask[:, 2] = cover[:, 2].any(-1)
    eligible = rng.random(f) < 0.7
    return bases, quals, cover, cmask, eligible, starts, limits, los, ref, ref_ext


# ---------------------------------------------------------------- epilogue


@pytest.mark.parametrize("seed", [0, 1, 2])
@pytest.mark.parametrize("w", [160, 192, 224])
@pytest.mark.parametrize("min_q", [0, 20])
def test_epilogue_is_bit_equal_to_the_jax_package_and_the_host_twin(seed, w, min_q):
    rng = np.random.default_rng(100 + seed)
    f = 9
    bases = rng.integers(0, 5, (f, 4, w)).astype(np.int8)
    quals = rng.integers(0, 45, (f, 4, w)).astype(np.int8)
    cover = rng.random((f, 4, w)) < 0.7
    cm = rng.random((f, 4)) < 0.5
    cons = rng.integers(0, 5, (f, 2, w)).astype(np.int8)
    ref_ext = rng.integers(0, 5, (f, w + 4)).astype(np.int8)  # N cells included
    # extension windows that run off their contig on either side
    store, _ = _store()
    rid = np.array([0, 1, 1, -1])
    ws = np.array([0, store.lengths[1] - w // 2, 1, 5])
    starts, limits = store.window_offsets(rid, ws)
    ref_ext[:4] = store.host_windows_ext(starts, store.window_origins(rid), limits, w + 4)
    args = (bases, quals, cover, cm, cons, ref_ext)
    want = np.asarray(_jax_epilogue(*args, float(min_q)))
    got = tctx.methyl_epilogue(*_t(*args), min_q)
    host = tctx.methyl_epilogue_host(*args, min_q)
    assert got.dtype == torch.uint8 and host.dtype == want.dtype == np.uint8
    np.testing.assert_array_equal(got.numpy(), want)
    np.testing.assert_array_equal(host, want)
    assert want[:, 0].any() and want[:, 1].any()


def _hand_case():
    """One family, W=8, genome slice TACGCTAGGCAT (window = g[2:10]) — the
    JAX package's hand case."""
    code = {"A": _A, "C": _C, "G": _G, "T": _T}
    ref_ext = np.array([[code[c] for c in "TACGCTAGGCAT"]], dtype=np.int8)
    w = 8
    bases = np.full((1, 4, w), _N, np.int8)
    quals = np.full((1, 4, w), 30, np.int8)
    cover = np.zeros((1, 4, w), bool)
    convert_mask = np.array([[False, True, True, False]])
    bases[0, 0, 0], cover[0, 0, 0] = _C, True  # CpG+: one untreated C
    bases[0, 3, 0], cover[0, 3, 0] = _T, True  # and one untreated T
    bases[0, 1, 1], cover[0, 1, 1] = _G, True  # CpG-: both treated rows G
    bases[0, 2, 1], cover[0, 2, 1] = _G, True
    bases[0, 0, 2], cover[0, 0, 2] = _C, True  # CHH+: below the quality gate
    quals[0, 0, 2] = 3
    cons_base = np.zeros((1, 2, w), np.int8)  # called everywhere
    return bases, quals, cover, convert_mask, cons_base, ref_ext


def _epilogue_on(engine, *args):
    if engine == "torch":
        return tctx.methyl_epilogue(*_t(*args[:6]), args[6]).numpy()
    return tctx.methyl_epilogue_host(*args)


@pytest.mark.parametrize("engine", ["torch", "numpy"])
def test_hand_case_contexts_and_counts(engine):
    planes = _epilogue_on(engine, *_hand_case(), 20)
    ctx, counts = planes[0, 0], planes[0, 1]
    assert list(ctx) == [1, 4, 3, 0, 0, 6, 6, 3]
    assert counts[0] == (1 | (1 << 4))
    assert counts[1] == 2
    assert counts[2] == 0
    assert counts[3] == 0 and counts[4] == 0


@pytest.mark.parametrize("engine", ["torch", "numpy"])
def test_uncalled_columns_report_nothing(engine):
    bases, quals, cover, cm, cons, ref_ext = _hand_case()
    cons = np.full_like(cons, _N)
    assert not _epilogue_on(engine, bases, quals, cover, cm, cons, ref_ext, 20).any()


@pytest.mark.parametrize("engine", ["torch", "numpy"])
def test_n_reference_suppresses(engine):
    bases, quals, cover, cm, cons, ref_ext = _hand_case()
    ref_ext = ref_ext.copy()
    ref_ext[0, 3] = _N
    planes = _epilogue_on(engine, bases, quals, cover, cm, cons, ref_ext, 20)
    assert planes[0, 0, 0] == 0 and planes[0, 1, 0] == 0
    assert planes[0, 0, 1] == 0


def test_methyl_wire_words_are_the_jax_bitcast_and_unpack_inverts_them():
    rng = np.random.default_rng(8)
    f, w = 5, 192
    planes = rng.integers(0, 256, (f, 2, w)).astype(np.uint8)
    want = np.asarray(jctx.methyl_wire_words(planes))
    got = tctx.methyl_wire_words(torch.from_numpy(planes))
    assert got.dtype == torch.int32 and got.numel() == want.size
    np.testing.assert_array_equal(got.numpy().view(np.uint8), want.view(np.uint8))
    np.testing.assert_array_equal(tctx.unpack_methyl_planes(got.numpy(), f, w), planes)
    np.testing.assert_array_equal(
        tctx.unpack_methyl_planes(got.numpy().view(np.uint8), f, w),
        jctx.unpack_methyl_planes(want, f, w),
    )


# ---------------------------------------------------------------- dispatch


@pytest.mark.parametrize("min_q", [0, 20])
def test_unpacked_methyl_dispatch_equals_the_jax_packages(min_q):
    store, _ = _store()
    b, q, c, cm, el, _st, _li, _lo, ref, ref_ext = _duplex_batch(21, 12, 96, store)
    tp = ConsensusParams(min_reads=0, min_input_base_quality=min_q)
    jp = JaxParams(min_reads=0, min_input_base_quality=min_q)
    packed, la, rd, planes = td.duplex_call_pipeline_packed_methyl(
        *_t(b, q.astype(np.int16), c, ref, cm, el, ref_ext), params=tp)
    jpacked, jla, jrd, jplanes = jd.duplex_call_pipeline_packed_methyl(
        b, q, c, ref, cm, el, ref_ext, params=jp, layout="packed")
    np.testing.assert_array_equal(planes.numpy(), np.asarray(jplanes))
    assert np.asarray(jplanes)[:, 0].any()
    np.testing.assert_array_equal(la.numpy(), np.asarray(jla))
    np.testing.assert_array_equal(rd.numpy(), np.asarray(jrd))
    f, w = b.shape[0], b.shape[-1]
    out = td.unpack_duplex_outputs(packed.numpy(), f, w)
    jout = jd.unpack_duplex_outputs(np.asarray(jpacked), f, w)
    for k in out:
        np.testing.assert_array_equal(out[k], jout[k], err_msg=k)
    # the methyl variant leaves the consensus planes as they are
    plain, _la, _rd = td.duplex_call_pipeline_packed(
        *_t(b, q.astype(np.int16), c, ref, cm, el), params=tp)
    np.testing.assert_array_equal(packed.numpy(), plain.numpy())


@pytest.mark.parametrize("levels", ["q2", "q8"])
def test_wire_methyl_dispatch_equals_the_jax_packages(levels):
    store, jstore = _store()
    pool = RTA3 if levels == "q2" else np.arange(2, 62, 2, dtype=np.uint8)
    b, q, c, cm, el, st, li, los, ref, ref_ext = _duplex_batch(33, 12, 96, store, pool)
    f, w = b.shape[0], b.shape[-1]
    tp, jp = ConsensusParams(min_reads=0), JaxParams(min_reads=0)
    dw = tw.pack_duplex_inputs(b, q, c, cm, el, st, li, qual_mode="auto")
    assert dw.qual_mode == levels
    words = np.concatenate([dw.to_words(), los])
    got = td.duplex_call_wire_fused_methyl(
        torch.from_numpy(words.view(np.uint8).copy()), store.device_codes("cpu"), f, w,
        params=tp, qual_mode=dw.qual_mode,
    ).numpy()
    assert got.dtype == np.uint8 and got.size == f * 6 * w
    jwire = np.asarray(jd.duplex_call_wire_fused_methyl(
        words, jstore.codes, f, w, params=jp, qual_mode=dw.qual_mode, layout="packed"))
    jplanes = jctx.unpack_methyl_planes(jwire[-(f * 2 * w // 4):], f, w)
    planes = tctx.unpack_methyl_planes(got[f * 4 * w:], f, w)
    np.testing.assert_array_equal(planes, jplanes)
    assert jplanes[:, 0].any()
    # the prefix is the plain wire route's output; the planes are the
    # unpacked route's on the host-gathered extension windows
    plain = td.duplex_call_wire_fused(
        torch.from_numpy(dw.to_words().view(np.uint8).copy()), store.device_codes("cpu"),
        f, w, params=tp, qual_mode=dw.qual_mode,
    ).numpy()
    np.testing.assert_array_equal(got[: f * 4 * w], plain)
    _p, _la, _rd, uplanes = td.duplex_call_pipeline_packed_methyl(
        *_t(b, q.astype(np.int16), c, ref, cm, el, ref_ext), params=tp)
    np.testing.assert_array_equal(planes, uplanes.numpy())


# ---------------------------------------------------------------- tallies


def _dup_tallies(rng, n, span=400):
    sites = rng.integers(0, span, n).astype(np.int64)
    ctx = (sites % 6 + 1).astype(np.uint8)  # a pure function of the site
    return sites, ctx, rng.integers(0, 5, n).astype(np.uint32), rng.integers(0, 5, n).astype(np.uint32)


@pytest.mark.parametrize("n", [0, 1, 257, 5000])
def test_merge_tallies_python_native_and_the_jax_package_agree(n):
    args = _dup_tallies(np.random.default_rng(n), n)
    want = jtally.merge_tallies(*args, engine="python")
    for engine in ("python", "native", "auto"):
        got = ttally.merge_tallies(*args, engine=engine)
        for g, x in zip(got, want):
            assert g.dtype == x.dtype
            np.testing.assert_array_equal(g, x)
    if n > 1:
        assert np.all(np.diff(want[0]) > 0)
    with pytest.raises(ValueError, match="merge engine"):
        ttally.merge_tallies(*args, engine="gpu")


def test_extract_tallies_maps_the_header_order_onto_the_store():
    # the store holds chrB first; the BAM header lists chrA first and an
    # unknown contig: raw ref_ids would land the sites on the wrong contig
    store, jstore = _store(order=("chrB", "chrA"))
    header_names = ["chrA", "chrB", "chrUn"]
    rng = np.random.default_rng(4)
    f, w = 8, 64
    planes = np.zeros((f, 2, w), np.uint8)
    planes[:, 0] = rng.integers(0, 7, (f, w))
    planes[:, 1] = rng.integers(0, 256, (f, w))
    metas = [type("Meta", (), {"ref_id": r, "window_start": s})()
             for r, s in ((0, 10), (1, 20), (2, 5), (-1, 0), (0, -3), (1, 500), (0, 0), (1, 1))]
    got = ttally.extract_tallies(planes, metas, store, store.contig_indices(header_names))
    want = jtally.extract_tallies(planes, metas, jstore, jstore.contig_indices(header_names))
    for g, x in zip(got, want):
        np.testing.assert_array_equal(g, x)
    # chrA's family 0 lands after the whole of chrB in the store
    assert got[0].size and got[0].max() >= store.offsets[1]
    unmapped = ttally.extract_tallies(planes, metas, store)
    assert not np.array_equal(unmapped[0], got[0])


class _FakeCk:
    def __init__(self, batches_done=0):
        self.batches_done = batches_done
        self.on_flush = None


class TestAccumulatorProtocol:
    """The JAX package's spill / resume / idempotence / threshold cases
    (tests/test_methyl.py), each also held against the JAX accumulator's
    bytes for the same adds."""

    @pytest.fixture()
    def stores(self):
        rng = np.random.default_rng(5)
        seq = "".join("ACGT"[i] for i in rng.integers(0, 4, 600))
        return trs.RefStore(["c1"], seqs=[seq]), jrs.RefStore(["c1"], seqs=[seq])

    @staticmethod
    def _tallies(rng, n):
        sites = np.sort(rng.integers(0, 500, n)).astype(np.int64)
        ctx = (sites % 6 + 1).astype(np.uint8)
        return (sites, ctx, rng.integers(0, 3, n).astype(np.uint32) + 1,
                rng.integers(0, 3, n).astype(np.uint32))

    def _reference(self, stores, tmp_path, batches):
        """(port bytes, JAX bytes) of an uninterrupted run of `batches`."""
        out = []
        for store, cls, name in ((stores[0], ttally.MethylAccumulator, "ref_port.bed"),
                                 (stores[1], jtally.MethylAccumulator, "ref_jax.bed")):
            acc = cls(store, str(tmp_path / name))
            for bi, t in sorted(batches.items()):
                acc.add(bi, *t)
            acc.finalize()
            out.append(open(tmp_path / name, "rb").read())
        assert out[0] == out[1]
        return out[0]

    def test_spill_resume_byte_identical(self, stores, tmp_path):
        rng = np.random.default_rng(9)
        batches = {bi: self._tallies(rng, 40) for bi in (1, 2, 3, 4)}
        ref = self._reference(stores, tmp_path, batches)
        bed = str(tmp_path / "r.bed")
        acc = ttally.MethylAccumulator(stores[0], bed)
        acc.attach_checkpoint(_FakeCk())
        acc.add(1, *batches[1])
        acc.add(2, *batches[2])
        acc.flush(2)
        acc.add(3, *batches[3])
        del acc  # the crash: 3 pending, 4 never delivered
        acc2 = ttally.MethylAccumulator(stores[0], bed)
        acc2.attach_checkpoint(_FakeCk(batches_done=2))
        acc2.add(3, *batches[3])
        acc2.add(4, *batches[4])
        acc2.finalize()
        assert open(bed, "rb").read() == ref

    def test_orphan_run_above_watermark_dropped(self, stores, tmp_path, capsys):
        rng = np.random.default_rng(10)
        batches = {bi: self._tallies(rng, 30) for bi in (1, 2, 3, 4)}
        ref = self._reference(stores, tmp_path, batches)
        bed = str(tmp_path / "o.bed")
        acc = ttally.MethylAccumulator(stores[0], bed)
        acc.attach_checkpoint(_FakeCk())
        for bi in (1, 2, 3, 4):
            acc.add(bi, *batches[bi])
        acc.flush(2)
        acc.flush(4)  # this run outruns the checkpoint's commit
        del acc
        acc2 = ttally.MethylAccumulator(stores[0], bed)
        acc2.attach_checkpoint(_FakeCk(batches_done=2))
        assert not os.path.exists(bed + ".methyl.run.0001")
        assert '"runs_dropped": 1' in capsys.readouterr().err
        acc2.add(3, *batches[3])
        acc2.add(4, *batches[4])
        acc2.finalize()
        assert open(bed, "rb").read() == ref

    def test_add_is_idempotent(self, stores, tmp_path):
        rng = np.random.default_rng(11)
        batches = {bi: self._tallies(rng, 25) for bi in (1, 2)}
        ref = self._reference(stores, tmp_path, batches)
        bed = str(tmp_path / "i.bed")
        acc = ttally.MethylAccumulator(stores[0], bed)
        acc.attach_checkpoint(_FakeCk())
        acc.add(1, *batches[1])
        acc.add(1, *batches[1])  # a replay replaces, never doubles
        acc.flush(1)
        acc.add(1, *batches[1])  # at the watermark: ignored
        acc.add(2, *batches[2])
        acc.finalize()
        assert open(bed, "rb").read() == ref

    def test_uncheckpointed_threshold_spill(self, stores, tmp_path):
        rng = np.random.default_rng(12)
        batches = {bi: self._tallies(rng, 50) for bi in (1, 2, 3)}
        ref = self._reference(stores, tmp_path, batches)
        bed = str(tmp_path / "t.bed")
        metrics = Metrics()
        acc = ttally.MethylAccumulator(stores[0], bed, spill_sites=60, metrics=metrics,
                                       engine="python")
        for bi in (1, 2, 3):
            acc.add(bi, *batches[bi])
        report = acc.finalize()
        assert open(bed, "rb").read() == ref
        assert report["sites"] > 0 and report["bed"] == bed
        assert metrics.counters["methyl_spill_runs"] >= 1
        assert metrics.seconds["methyl_finalize.bedmethyl"] >= 0
        assert not os.path.exists(bed + ".methyl.runs.json")
        with pytest.raises(ValueError, match="bed_path or cx_path"):
            ttally.MethylAccumulator(stores[0])


# ---------------------------------------------------------------- the stage


@pytest.fixture(scope="module")
def duplex_env(tmp_path_factory):
    """The JAX package's methyl fixture: 40 aligned duplex groups over two
    contigs, one window past its contig's end, one unmapped family; the
    FASTA lists chrB first, the BAM header chrA."""
    tmp = tmp_path_factory.mktemp("torch_methyl")
    rng = np.random.default_rng(11)
    _, g1 = random_genome(rng, 9000, name="chrA")
    _, g2 = random_genome(rng, 7000, name="chrB")
    genomes = {"chrA": g1, "chrB": g2}
    header = BamHeader("@HD\tVN:1.6\tSO:coordinate\n", [("chrA", 9000), ("chrB", 7000)])
    records = []
    for fam in range(40):
        ref_id = fam % 2
        gname = ("chrA", "chrB")[ref_id]
        start = 50 + (fam // 2) * 150
        if fam == 6:
            start = len(genomes[gname]) - 60
        recs = make_aligned_duplex_group(
            rng, gname, genomes[gname], fam, start, 60, softclip=3 if fam % 5 == 0 else 0,
        )
        for r in recs:
            r.ref_id = -1 if fam == 9 else ref_id
        records.extend(recs)
    records.sort(key=lambda r: (r.ref_id, r.pos))
    bam = str(tmp / "dup_in.bam")
    with BamWriter(bam, header) as w:
        w.write_all(records)
    fasta = str(tmp / "genome.fa")
    with open(fasta, "w") as fh:
        for name in ("chrB", "chrA"):
            seq = genomes[name]
            fh.write(f">{name}\n")
            for i in range(0, len(seq), 60):
                fh.write(seq[i:i + 60] + "\n")
    env = {"tmp": tmp, "bam": bam, "fasta": fasta, "genomes": genomes}
    env["jax"] = _jax_duplex_methyl(env)
    return env


def _jax_duplex_methyl(env):
    """The JAX package's duplex stage with methyl 'both' on its unpacked
    route: (BAM, bedMethyl, CX) paths."""
    store = jrs.RefStore.from_fasta(env["fasta"])
    base = str(env["tmp"] / "jax_dup.bam")
    acc = jtally.MethylAccumulator(store, base + ".bedmethyl", base + ".CX_report.txt")
    with BamReader(env["bam"]) as r:
        names = [n for n, _ in r.header.references]
        batches = jc.call_duplex_batches(
            r, lambda n, s, e: env["genomes"][n][s:e], names, JaxParams(min_reads=0),
            mode="self", grouping="coordinate", batch_families=8, mesh=None,
            transport="unpacked", emit="python", vote_kernel="xla", refstore=store,
            methyl=acc,
        )
        je.write_batch_stream(batches, base, r.header, "self", sort_engine="python")
    report = acc.finalize()
    assert report["sites"] > 0
    return base, report["bed"], report["cx"]


def _port_duplex_cli(env, tag, *extra):
    out = str(env["tmp"] / f"port_{tag}.bam")
    rc = cli.main(["duplex", "-i", env["bam"], "-o", out, "--reference", env["fasta"],
                   "--mode", "self", "--batch-families", "8", "--device", "cpu", *extra])
    assert rc == 0
    return out


@pytest.mark.parametrize("methyl_engine", ["device", "host"])
@pytest.mark.parametrize("engine", ["native", "python"])
@pytest.mark.parametrize("transport", ["wire", "unpacked"])
def test_duplex_methyl_files_are_sha_equal_to_the_jax_packages(
        duplex_env, transport, engine, methyl_engine, capsys):
    _jbam, jbed, jcx = duplex_env["jax"]
    tag = f"{transport}_{engine}_{methyl_engine}"
    out = _port_duplex_cli(
        duplex_env, tag, "--transport", transport, "--emit", engine, "--ingest", engine,
        "--methyl", "both", "--methyl-engine", methyl_engine,
    )
    err = capsys.readouterr().err.strip().splitlines()
    report = json.loads(err[-2])["methyl"]
    stats = json.loads(err[-1])
    assert report == {"sites": report["sites"], "bed": out + ".bedmethyl",
                      "cx": out + ".CX_report.txt"} and report["sites"] > 0
    assert _sha(out + ".bedmethyl") == _sha(jbed)
    assert _sha(out + ".CX_report.txt") == _sha(jcx)
    # the phase was timed (its seconds are rounded to the millisecond, which
    # the device engine's plane peel can undercut); the SHA equalities above
    # show that every batch's planes reached the tally
    assert "methyl_seconds" in stats
    assert stats["route_batches_wire" if transport == "wire" else "route_batches_single"] > 0
    # methyl does not touch the consensus
    plain = _port_duplex_cli(duplex_env, f"plain_{transport}_{engine}",
                             "--transport", transport, "--emit", engine, "--ingest", engine)
    assert _sha(out) == _sha(plain)


@pytest.mark.parametrize("methyl_engine", ["device", "host"])
def test_duplex_methyl_on_a_sharded_mesh_is_sha_equal_to_the_jax_packages(
        duplex_env, methyl_engine):
    """The sharded mesh route (4 CPU shards): under 'device' each shard runs
    the epilogue on its own device, under 'host' the numpy twin runs at the
    retire; both give the JAX package's files and the one-device BAM."""
    from bsseqconsensusreads_tpu_torch.parallel.mesh import make_mesh
    from bsseqconsensusreads_tpu_torch.pipeline import extsort as pextsort

    jbam, jbed, jcx = duplex_env["jax"]
    store = trs.RefStore.from_fasta(duplex_env["fasta"])
    base = str(duplex_env["tmp"] / f"mesh_{methyl_engine}.bam")
    acc = ttally.MethylAccumulator(store, base + ".bedmethyl", base + ".CX_report.txt")
    st = tc.StageStats(stage="duplex")
    with PortReader(duplex_env["bam"]) as r:
        names = [n for n, _ in r.header.references]
        batches = tc.call_duplex_batches(
            r, lambda n, s, e: duplex_env["genomes"][n][s:e], names,
            ConsensusParams(min_reads=0), mode="self", grouping="coordinate",
            batch_families=8, stats=st, device="cpu", transport="unpacked",
            mesh=make_mesh(4, devices=["cpu"] * 4), refstore=store, methyl=acc,
            methyl_engine=methyl_engine, emit="python",
        )
        pextsort.write_batch_stream(batches, base, r.header, "self", sort_engine="python")
    report = acc.finalize()
    assert st.metrics.counters["route_batches_sharded"] == st.batches > 0
    assert _sha(report["bed"]) == _sha(jbed) and _sha(report["cx"]) == _sha(jcx)
    assert _sha(base) == _sha(jbam)


def test_methyl_out_and_single_formats(duplex_env, capsys):
    _jbam, jbed, jcx = duplex_env["jax"]
    base = str(duplex_env["tmp"] / "elsewhere")
    _port_duplex_cli(duplex_env, "bed_only", "--methyl", "bedmethyl", "--methyl-out", base)
    assert _sha(base + ".bedmethyl") == _sha(jbed)
    assert not os.path.exists(base + ".CX_report.txt")
    out = _port_duplex_cli(duplex_env, "cx_only", "--methyl", "cx")
    assert _sha(out + ".CX_report.txt") == _sha(jcx)
    assert not os.path.exists(out + ".bedmethyl")
    assert '"methyl"' in capsys.readouterr().err


def test_the_duplex_caller_refuses_methyl_without_conversion(duplex_env):
    store = trs.RefStore.from_fasta(duplex_env["fasta"])
    acc = ttally.MethylAccumulator(store, str(duplex_env["tmp"] / "refused.bed"))
    with PortReader(duplex_env["bam"]) as r:
        names = [n for n, _ in r.header.references]
        with pytest.raises(ValueError, match="converting chemistry"):
            next(tc.call_duplex_batches(r, None, names, device="cpu", chemistry="none",
                                        methyl=acc))
        with pytest.raises(ValueError, match="unknown methyl engine"):
            next(tc.call_duplex_batches(r, None, names, device="cpu", methyl=acc,
                                        methyl_engine="gpu"))


# ---------------------------------------------------------------- run


@pytest.fixture(scope="module")
def run_env(tmp_path_factory):
    """A bisulfite stream_duplex_families mixture (1 and 2 templates per
    strand, RTA3 quals, substitutions) as `run`'s grouped input."""
    tmp = tmp_path_factory.mktemp("torch_methyl_run")
    rng = np.random.default_rng(23)
    codes = rng.integers(0, 4, size=12_000).astype(np.int8)
    fasta = str(tmp / "genome.fa")
    write_fasta(fasta, "chr1", codes_to_seq(codes))
    read_len = 100
    pool = [bytes(np.random.default_rng(300 + i).choice(RTA3, size=read_len)) for i in range(16)]
    err_pos = rng.integers(2, read_len - 2, size=4096)
    err_base = rng.integers(0, 4, size=4096)

    def mutate(seq, fam, ti, flag):
        i = int(err_pos[(fam * 31 + ti * 7 + flag) & 4095])
        return seq[:i] + "ACGT"[err_base[(fam + flag) & 4095]] + seq[i + 1:]

    bam = str(tmp / "input" / "sampleM.bam")
    os.makedirs(os.path.dirname(bam))
    header = BamHeader("@HD\tVN:1.6\tSO:coordinate\n", [("chr1", len(codes))])
    with BamWriter(bam, header) as w:
        w.write_all(stream_duplex_families(
            codes, 48, read_len=read_len, templates_for=lambda fam: 1 if fam % 10 < 7 else 2,
            qual_for=lambda fam, ti, flag: pool[(fam + ti * 13 + flag) & 15],
            mutate=mutate, bisulfite=True,
        ))
    kw = dict(genome_dir=str(tmp), genome_fasta_file_name="genome.fa", backend="cpu",
              batch_families=8, methyl="both")
    jt, _r, _s = jstages.run_pipeline(jconfig.FrameworkConfig(**kw), bam,
                                      outdir=str(tmp / "jax"))
    return {"tmp": tmp, "bam": bam, "kw": kw, "jax_target": jt}


def _run(run_env, tag, **over):
    kw = {**run_env["kw"], **over}
    return pstages.run_pipeline(pconfig.FrameworkConfig(**kw), run_env["bam"],
                                outdir=str(run_env["tmp"] / tag))


@pytest.mark.parametrize("transport", ["auto", "wire"])
def test_run_methyl_files_are_sha_equal_to_the_jax_packages(run_env, transport):
    jt = run_env["jax_target"]
    target, results, stats = _run(run_env, f"port_{transport}", transport=transport)
    assert [r.ran for r in results] == [True, True]
    assert _sha(target + ".bedmethyl") == _sha(jt + ".bedmethyl")
    assert _sha(target + ".CX_report.txt") == _sha(jt + ".CX_report.txt")
    assert stats["duplex"].metrics.seconds["methyl"] > 0
    plain, _r, _s = _run(run_env, f"plain_{transport}", transport=transport, methyl="off")
    assert _sha(target) == _sha(plain)
    assert not os.path.exists(plain + ".bedmethyl")


@pytest.mark.parametrize("when", ["after_flush", "between_spill_and_commit"])
def test_killed_checkpointed_run_resumes_to_the_same_methyl_bytes(run_env, monkeypatch, when):
    """A duplex stage killed after two committed batches — cleanly between
    two flushes, or after the methyl run of the third was written and
    before its manifest commit (an orphan run the resume must drop) —
    resumes to the uninterrupted run's bedMethyl and CX bytes."""
    whole, _r, _s = _run(run_env, f"ck_whole_{when}", checkpoint_every=1)
    outdir = str(run_env["tmp"] / f"ck_crash_{when}")
    real_save = pcheckpoint._Manifest.save
    count = {"duplex": 0}

    def dying_save(self, path):
        if path.endswith("_duplex_unfiltered.bam.ckpt.json"):
            if count["duplex"] == 2:
                raise KeyboardInterrupt
            count["duplex"] += 1
        return real_save(self, path)

    real_flush = pcheckpoint.BatchCheckpoint._flush

    def dying_flush(self, items, n_batches):
        if self.target.endswith("_duplex_unfiltered.bam") and self.batches_done == 2:
            raise KeyboardInterrupt
        return real_flush(self, items, n_batches)

    with monkeypatch.context() as m:
        if when == "after_flush":
            m.setattr(pcheckpoint.BatchCheckpoint, "_flush", dying_flush)
        else:
            m.setattr(pcheckpoint._Manifest, "save", dying_save)
        with pytest.raises(KeyboardInterrupt):
            _run(run_env, f"ck_crash_{when}", checkpoint_every=1)
    runs = json.load(open(os.path.join(
        outdir, "sampleM_consensus_duplex_unfiltered.bam.bedmethyl.methyl.runs.json")))["runs"]
    assert [r["upto"] for r in runs] == ([1, 2] if when == "after_flush" else [1, 2, 3])
    target, results, stats = _run(run_env, f"ck_crash_{when}", checkpoint_every=1)
    assert [r.ran for r in results] == [False, True]
    assert stats["duplex"].metrics.counters["methyl_spill_runs"] >= 1
    for suffix in (".bedmethyl", ".CX_report.txt"):
        assert _sha(target + suffix) == _sha(whole + suffix)
    assert _sha(target) == _sha(whole)
    assert not [p for p in os.listdir(outdir) if ".methyl.run" in p]


@pytest.mark.parametrize("over,match", [
    ({"chemistry": "none"}, "converting chemistry"),
    ({"single_strand": True}, "single_strand"),
    ({"methyl": "bedgraph"}, "unknown methyl mode"),
])
def test_run_refuses_methyl_where_the_jax_package_does(run_env, over, match):
    builder = pstages.PipelineBuilder(
        pconfig.FrameworkConfig(**{**run_env["kw"], **over}), run_env["bam"], outdir="unused")
    with pytest.raises(pwf.WorkflowError, match=match):
        builder.build()
