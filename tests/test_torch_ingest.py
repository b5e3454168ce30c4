"""The port's native ingest against the JAX package's and against its own
Python engine: the columnar batches the C decoder and grouper produce,
the family runs and their order, the columnar record views, and the
encoded batches the native fill writes.

Inputs: the grouped_env and mixture_env fixtures of
tests/test_torch_pipeline.py, and the molecular consensus BAM the port
writes from each (it carries the cd/ce/cB tags the duplex stage reads)."""

import numpy as np
import pytest

from bsseqconsensusreads_tpu.io import native as jnative
from bsseqconsensusreads_tpu_torch.io import native
from bsseqconsensusreads_tpu_torch.io.bam import BamReader
from bsseqconsensusreads_tpu_torch.ops.encode import (
    encode_duplex_families,
    encode_molecular_families,
)
from bsseqconsensusreads_tpu_torch.pipeline import calling as tc
from bsseqconsensusreads_tpu_torch.pipeline.ingest import (
    ColumnarRecordView,
    FamilyRun,
    GroupedColumnarStream,
    columnar_records,
)
from test_torch_pipeline import _port_chain, grouped_env, mixture_env  # noqa: F401

FIXED = ("ref_id", "pos", "flag", "mapq", "l_seq", "next_ref", "next_pos",
         "tlen", "n_cigar", "qname", "mi", "rx", "ref_span", "left_clip",
         "right_clip", "cigar_flags", "aux_len")


def _records_of(batch):
    """Per-record variable-length planes of a ColumnarBatch (either
    package's): seq, qual, cigar and aux spans, concatenated in order."""
    seq, qual, cig, aux = [], [], [], []
    for i in range(batch.n):
        o, n = int(batch.var_off[i]), int(batch.l_seq[i])
        seq.append(batch.seq[o : o + n])
        qual.append(batch.qual[o : o + n])
        c = int(batch.cigar_off[i])
        cig.append(batch.cigar[c : c + int(batch.n_cigar[i])])
        raw = int(batch.aux_len[i])
        k = raw & ~(1 << 30)
        span = 6 * k if raw & (1 << 30) else 2 * k
        a = int(batch.aux_off[i])
        aux.append(batch.aux[a : a + span] if k else batch.aux[:0])
    cat = np.concatenate
    return cat(seq), cat(qual), cat(cig), cat(aux)


def _assert_batches_equal(port, jax_batch):
    assert port.n == jax_batch.n
    for k in FIXED:
        np.testing.assert_array_equal(getattr(port, k), getattr(jax_batch, k), err_msg=k)
    for a, b, name in zip(_records_of(port), _records_of(jax_batch),
                          ("seq", "qual", "cigar", "aux")):
        np.testing.assert_array_equal(a, b, err_msg=name)


@pytest.fixture(scope="module", params=["grouped_env", "mixture_env"])
def inputs(request):
    """(raw grouped BAM, the port's molecular 'self' output BAM)."""
    env = request.getfixturevalue(request.param)
    mol, _ = _port_chain(env, "self", "ingest_in")
    return env["bam"], mol


@pytest.mark.parametrize("which", ["raw", "molecular"])
def test_columnar_batches_equal_the_jax_package(inputs, which):
    path = inputs[0] if which == "raw" else inputs[1]
    small = dict(batch_records=16)  # several batches per file
    port = list(native.read_columnar(path, **small))
    jax_batches = list(jnative.read_columnar(path, **small))
    assert len(port) == len(jax_batches) > 1
    for a, b in zip(port, jax_batches):
        _assert_batches_equal(a, b)
    if which == "molecular":  # the cd/ce/cB aux planes are populated
        assert any(int(b.aux_len.max()) & (1 << 30) for b in port)


@pytest.mark.parametrize("strip_suffix", [False, True])
def test_grouped_columnar_batches_equal_the_jax_package(inputs, strip_suffix):
    path = inputs[1] if strip_suffix else inputs[0]
    port = list(native.read_grouped_columnar(path, 10_000, strip_suffix))
    jax_batches = list(jnative.read_grouped_columnar(path, 10_000, strip_suffix))
    assert len(port) == len(jax_batches)
    for (pb, pmi, pn, pr), (jb, jmi, jn, jr) in zip(port, jax_batches):
        _assert_batches_equal(pb, jb)
        np.testing.assert_array_equal(pmi, jmi)
        np.testing.assert_array_equal(pn, jn)
        assert pr == jr


@pytest.mark.parametrize("grouping", ["coordinate", "adjacent"])
@pytest.mark.parametrize("strip_suffix", [False, True])
def test_native_groups_equal_the_python_stream(inputs, grouping, strip_suffix):
    path = inputs[1] if strip_suffix else inputs[0]
    st_py, st_nat = tc.StageStats(), tc.StageStats()
    with BamReader(path, engine="python") as r:
        py = [(mi, [(x.qname, x.flag, x.pos) for x in recs])
              for mi, recs in tc.stream_mi_groups(r, strip_suffix, grouping, stats=st_py)]
    stream = GroupedColumnarStream(path, strip_suffix=strip_suffix, grouping=grouping)
    nat = [(mi, [(x.qname, x.flag, x.pos) for x in recs])
           for mi, recs in tc.stream_mi_groups(stream, strip_suffix, grouping, stats=st_nat)]
    assert nat == py and len(py) > 10
    assert st_nat.records_in == st_py.records_in
    assert st_nat.refragmented_families == st_py.refragmented_families


def test_a_mismatched_pre_grouped_stream_is_refused(inputs):
    stream = GroupedColumnarStream(inputs[0], grouping="adjacent")
    with pytest.raises(ValueError, match="grouping"):
        next(tc.stream_mi_groups(stream, grouping="coordinate"))
    stream = GroupedColumnarStream(inputs[0], flush_margin=500)
    with pytest.raises(ValueError, match="flush_margin"):
        next(tc.stream_mi_groups(stream, grouping="coordinate"))


def test_columnar_views_carry_the_records_fields(inputs):
    path = inputs[1]
    with BamReader(path, engine="python") as r:
        want = list(r)
    got = list(columnar_records(path, batch_records=50))
    assert len(got) == len(want)
    for v, rec in zip(got, want):
        assert isinstance(v, ColumnarRecordView)
        assert (v.qname, v.flag, v.ref_id, v.pos, v.mapq, v.next_ref_id, v.next_pos,
                v.tlen, v.cigar, v.seq, v.qual, v.reference_end) == (
            rec.qname, rec.flag, rec.ref_id, rec.pos, rec.mapq, rec.next_ref_id,
            rec.next_pos, rec.tlen, rec.cigar, rec.seq, rec.qual, rec.reference_end)
        assert v.get_tag("MI") == rec.get_tag("MI")
        for tag in ("cd", "ce", "cB"):
            np.testing.assert_array_equal(v.get_tag(tag)[1], rec.get_tag(tag)[1])
        assert not v.has_tag("XX") and v.has_tag("cB")


def _chunks(groups, size=8):
    out, buf = [], []
    for g in groups:
        buf.append(g)
        if len(buf) == size:
            out.append(buf)
            buf = []
    return out + ([buf] if buf else [])


def _assert_meta_equal(a, b):
    assert [(m.mi, m.ref_id, m.window_start, m.n_templates, m.rx, tuple(m.role_reverse))
            for m in a] == [(m.mi, m.ref_id, m.window_start, m.n_templates, m.rx,
                             tuple(m.role_reverse)) for m in b]


def test_native_molecular_encode_equals_the_python_encode(inputs):
    path = inputs[0]
    with BamReader(path, engine="python") as r:
        py_chunks = _chunks(tc.stream_mi_groups(r, grouping="coordinate"))
    stream = GroupedColumnarStream(path, scan_policy="drop")
    nat_chunks = _chunks(tc.stream_mi_groups(stream, grouping="coordinate"))
    assert len(nat_chunks) == len(py_chunks) > 1
    for nat, py in zip(nat_chunks, py_chunks):
        assert all(isinstance(g, FamilyRun) for g in nat)
        assert [g.ntpl_est for g in nat] == [tc._kept_template_count(r) for _, r in py]
        nb, nskip = encode_molecular_families(nat)
        pb, pskip = encode_molecular_families(py)
        assert nskip == pskip
        np.testing.assert_array_equal(nb.bases, pb.bases)
        np.testing.assert_array_equal(nb.quals, pb.quals)
        _assert_meta_equal(nb.meta, pb.meta)


def test_native_duplex_encode_equals_the_python_encode(inputs, tmp_path):
    path = inputs[1]
    with BamReader(path, engine="python") as r:
        py_chunks = _chunks(tc.stream_mi_groups(r, True, "coordinate"))
        names = [n for n, _ in r.header.references]
    stream = GroupedColumnarStream(path, strip_suffix=True, scan_policy="duplex")
    nat_chunks = _chunks(tc.stream_mi_groups(stream, True, "coordinate"))
    genome = {}

    def fetch(name, start, end):
        # a deterministic stand-in reference, so the ref planes are compared too
        seq = genome.setdefault(name, "".join("ACGT"[(i * 7) % 4] for i in range(40_000)))
        return seq[start:end]

    assert len(nat_chunks) == len(py_chunks) > 1
    for nat, py in zip(nat_chunks, py_chunks):
        nb, nleft, nskip = encode_duplex_families(nat, fetch, names)
        pb, pleft, pskip = encode_duplex_families(py, fetch, names)
        assert nskip == pskip
        assert [(x.qname, x.flag) for x in nleft] == [(x.qname, x.flag) for x in pleft]
        for k in ("bases", "quals", "cover", "ref", "convert_mask", "extend_eligible"):
            np.testing.assert_array_equal(getattr(nb, k), getattr(pb, k), err_msg=k)
        _assert_meta_equal(nb.meta, pb.meta)
        # the sidecar of raw cd/ce/cB rows is the same from views and records
        ns, ps = tc._duplex_sidecar(nat), tc._duplex_sidecar(py)
        assert ns.keys() == ps.keys()
        for mi in ps:
            for a, b in zip(ns[mi], ps[mi]):
                assert a.keys() == b.keys()
                for row in a:
                    assert a[row][0] == b[row][0]
                    for x, y in zip(a[row][1:], b[row][1:]):
                        np.testing.assert_array_equal(x, y)
