"""The port's wire transport (ops/wire, ops/refstore, the wire kernels of
models/molecular and models/duplex and the C packs in io/wirepack) on
the CPU against the JAX package's.

Tolerance: bit/byte equality throughout — the wire words, the device
unpack, the window gathers, the genome read from a FASTA, and the wire
kernels' output bytes (the JAX package's XLA vote against the port's
plain seg_vote): the port's wire returns the unpacked route's output
planes, held against the JAX package's unpacked outputs and against its
slim / b0 wire outputs once the JAX host rebuild has run. Inputs are made from seeds with numpy: duplex batches whose
reference windows come from a two-contig genome (windows at NO_REF, past
the contig end, at the genome's last base, within `width` of the end),
molecular envelopes and packed rows, with RTA3 quals (4 levels), 5-16
levels and more than 16."""

import numpy as np
import pytest
import torch

from bsseqconsensusreads_tpu.models import duplex as jd
from bsseqconsensusreads_tpu.models import molecular as jm
from bsseqconsensusreads_tpu.models.params import ConsensusParams as JaxParams
from bsseqconsensusreads_tpu.ops import reconstruct as jrec
from bsseqconsensusreads_tpu.ops import refstore as jrs
from bsseqconsensusreads_tpu.ops import wire as jw
from bsseqconsensusreads_tpu_torch.alphabet import BASE_CODE
from bsseqconsensusreads_tpu_torch.models import duplex as td
from bsseqconsensusreads_tpu_torch.models import molecular as tm
from bsseqconsensusreads_tpu_torch.models.params import ConsensusParams
from bsseqconsensusreads_tpu_torch.ops import refstore as trs
from bsseqconsensusreads_tpu_torch.ops import wire as tw

N = 4
RTA3 = np.array([2, 12, 23, 37], np.uint8)
LEVELS = {
    "levels4": RTA3,  # auto -> q2
    "levels11": np.array([2, 5, 9, 12, 17, 20, 23, 28, 30, 37, 41], np.uint8),  # q4
    "levels30": np.arange(2, 62, 2, dtype=np.uint8),  # q8
}
AUTO_MODE = {"levels4": "q2", "levels11": "q4", "levels30": "q8"}


def _store():
    rng = np.random.default_rng(3)
    seqs = ["".join("ACGT"[i] for i in rng.integers(0, 4, n)) for n in (700, 400)]
    seqs[0] = seqs[0][:650] + "N" * 10 + seqs[0][660:]
    return trs.RefStore(["chrA", "chrB"], seqs=seqs), jrs.RefStore(["chrA", "chrB"], seqs=seqs)


def _duplex_batch(seed, f, w, pool, store):
    """Duplex planes on windows of `store`, with the edge windows planted:
    an unknown contig (NO_REF), a window running past its contig's end,
    one ending at the genome's last base, one starting within w of the
    end, and one on the second contig."""
    rng = np.random.default_rng(seed)
    rid = rng.integers(0, 2, f)
    ws = np.array([int(rng.integers(0, store.lengths[r] - w)) for r in rid])
    rid[0] = -1
    rid[1], ws[1] = 0, store.lengths[0] - w // 2  # past chrA's end
    rid[2], ws[2] = 1, store.lengths[1] - w - 1  # the genome's last base
    rid[3], ws[3] = 1, store.lengths[1] - w // 3  # starts within w of the end
    starts, limits = store.window_offsets(rid, ws)
    ref = store.host_windows(starts, limits, w + 1)
    bases = np.full((f, 4, w), N, np.int8)
    quals = np.zeros((f, 4, w), np.uint8)
    cover = np.zeros((f, 4, w), bool)
    for i in range(f):
        s0, e0 = int(rng.integers(0, 8)), int(rng.integers(w // 2, w))
        for r in range(4):
            if i % 7 == 3 and r == 2:
                continue
            s, e = s0 + int(rng.integers(0, 2)), min(w, e0 - int(rng.integers(0, 2)))
            cover[i, r, s:e] = True
            seq = np.where(ref[i, s:e] == N, rng.integers(0, 4, e - s), ref[i, s:e])
            noise = rng.random(e - s) < 0.1
            seq[noise] = rng.integers(0, 4, int(noise.sum()))
            bases[i, r, s:e] = seq
            quals[i, r, s:e] = rng.choice(pool, e - s)
    cmask = np.zeros((f, 4), bool)
    cmask[:, 1] = cover[:, 1].any(-1)
    cmask[:, 2] = cover[:, 2].any(-1)
    eligible = rng.random(f) < 0.7
    return bases, quals, cover, cmask, eligible, starts, limits, ref


def _molecular_envelope(seed, f, t, w, pool):
    rng = np.random.default_rng(seed)
    bases = np.full((f, t, 2, w), N, np.int8)
    quals = np.zeros((f, t, 2, w), np.uint8)
    truth = rng.integers(0, 4, (f, w)).astype(np.int8)
    for i in range(f):
        for k in range(int(rng.integers(1, t + 1))):
            for p in range(2):
                s = int(rng.integers(0, w // 2))
                e = int(rng.integers(s + 1, w + 1))
                obs = truth[i, s:e].copy()
                noise = rng.random(e - s) < 0.05
                obs[noise] = rng.integers(0, 4, int(noise.sum()))
                bases[i, k, p, s:e] = obs
                quals[i, k, p, s:e] = rng.choice(pool, e - s)
    return bases, quals


def _packed_rows(bases, quals, pad_rows=6):
    """PackedRows-shaped arrays of an envelope: real rows in family order,
    then all-N pad rows carrying the sentinel family id."""
    f = bases.shape[0]
    keep = (bases != N).any(axis=(-1, -2))
    rows_b, rows_q = bases[keep], quals[keep]
    seg = np.nonzero(keep)[0].astype(np.int32)
    n_real = len(seg)
    w = bases.shape[-1]
    rows_b = np.concatenate([rows_b, np.full((pad_rows, 2, w), N, np.int8)])
    rows_q = np.concatenate([rows_q, np.zeros((pad_rows, 2, w), np.uint8)])
    seg = np.concatenate([seg, np.full(pad_rows, f, np.int32)])
    return rows_b, rows_q, seg, f, n_real


def _params():
    return ConsensusParams(min_reads=0), JaxParams(min_reads=0)


def _dev(words):
    return torch.from_numpy(words.view(np.uint8).copy())


# ---------------------------------------------------------------- packs


@pytest.mark.parametrize("w", [160, 192, 224])
@pytest.mark.parametrize("levels", sorted(LEVELS))
def test_duplex_pack_words_equal_the_jax_packages(w, levels):
    store, _j = _store()
    b, q, c, cm, el, st, li, _ref = _duplex_batch(w + len(levels), 6, w, LEVELS[levels], store)
    modes = ["auto", "q8"] + [m for m in ("q2", "q4") if AUTO_MODE[levels] in (m, "q2")]
    for mode in modes:
        want = jw.pack_duplex_inputs(b, q, c, cm, el, st, li, qual_mode=mode)
        for native in (False, True):
            got = tw.pack_duplex_inputs(b, q, c, cm, el, st, li, qual_mode=mode, native=native)
            assert got.qual_mode == want.qual_mode
            np.testing.assert_array_equal(got.to_words(), want.to_words())
    auto = tw.pack_duplex_inputs(b, q, c, cm, el, st, li, qual_mode="auto")
    assert auto.qual_mode == AUTO_MODE[levels]


@pytest.mark.parametrize("levels", sorted(LEVELS))
def test_molecular_pack_words_equal_the_jax_packages(levels):
    b, q = _molecular_envelope(7, 5, 3, 192, LEVELS[levels])
    want = jw.pack_molecular_inputs(b, q, qual_mode="auto")
    rows = _packed_rows(b, q)
    jwords, jmode = jw.pack_molecular_rows_wire(*rows, qual_mode="auto")
    assert jmode == AUTO_MODE[levels]
    for native in (False, True):
        got = tw.pack_molecular_inputs(b, q, qual_mode="auto", native=native)
        np.testing.assert_array_equal(got.to_words(), want.to_words())
        words, mode = tw.pack_molecular_rows_wire(*rows, qual_mode="auto", native=native)
        assert mode == jmode
        np.testing.assert_array_equal(words, jwords)


def test_wire_section_sizes_equal_the_jax_packages():
    for f, w, r in ((6, 192, 4), (5, 160, 6), (1, 224, 2)):
        for mode in ("q8", "q2", "q4"):
            assert tw.wire_section_sizes(f, w, r, mode) == jw.wire_section_sizes(f, w, r, mode)
            assert tw.rows_wire_section_sizes(f * 3, f, w, mode) == \
                jw.rows_wire_section_sizes(f * 3, f, w, mode)


def _raises_like_jax(fn_port, fn_jax):
    with pytest.raises(ValueError) as jerr:
        fn_jax()
    with pytest.raises(ValueError) as perr:
        fn_port()
    return str(perr.value), str(jerr.value)


@pytest.mark.parametrize("case", ["q_over_93_q2", "q_255_q4", "too_many_levels_q2",
                                  "odd_w", "bad_mode"])
def test_pack_refusals_match_the_jax_packages(case):
    store, _j = _store()
    b, q, c, cm, el, st, li, _ref = _duplex_batch(5, 4, 192, RTA3, store)
    mode = "q2"
    if case == "q_over_93_q2":
        q = q.copy()
        q[c] = np.where(q[c] == 37, 94, q[c])
    elif case == "q_255_q4":
        q = q.copy()
        q[0, 0, c[0, 0]] = 255
        mode = "q4"
    elif case == "too_many_levels_q2":
        q = np.where(c, (np.arange(q.size).reshape(q.shape) % 7 + 2), 0).astype(np.uint8)
    elif case == "odd_w":
        b, q, c = b[..., :-1], q[..., :-1], c[..., :-1]
    else:
        mode = "q3"
    for native in (False, True):
        got, want = _raises_like_jax(
            lambda: tw.pack_duplex_inputs(b, q, c, cm, el, st, li, qual_mode=mode, native=native),
            lambda: jw.pack_duplex_inputs(b, q, c, cm, el, st, li, qual_mode=mode),
        )
        # the JAX package packs with its C sweep here: the C messages match
        # word for word, the numpy twin's name the same limit
        assert got == want if native else ("93" in want) == ("93" in got)
    # auto never refuses: it falls back to raw bytes
    if case in ("q_over_93_q2", "q_255_q4"):
        assert tw.pack_duplex_inputs(b, q, c, cm, el, st, li, qual_mode="auto").qual_mode == "q8"


def test_splitters_refuse_the_other_version_and_a_wrong_header():
    b, q = _molecular_envelope(8, 4, 2, 160, RTA3)
    rows = _packed_rows(b, q)
    v2, mode = tw.pack_molecular_rows_wire(*rows, qual_mode="auto")
    v1 = tw.pack_molecular_inputs(b, q, qual_mode="auto")
    n, nf = rows[0].shape[0], rows[3]
    cases = [
        (lambda m: m.split_duplex_wire(v2, 4, 160, r=4, qual_mode=mode), "v2 magic"),
        (lambda m: m.split_molecular_rows_wire(v1.to_words(), n, nf, 160, mode), "magic"),
        (lambda m: m.split_molecular_rows_wire(v2, n + 1, nf, 160, mode), "header"),
        (lambda m: m.split_molecular_rows_wire(v2, n, nf, 192, mode), "header"),
        (lambda m: m.split_molecular_rows_wire(v2, n, nf, 160, "q8"), "header"),
    ]
    for fn, what in cases:
        got, want = _raises_like_jax(lambda: fn(tw), lambda: fn(jw))
        assert got == want and what in got


# ---------------------------------------------------------------- device unpack


@pytest.mark.parametrize("levels", sorted(LEVELS))
def test_device_unpack_equals_the_jax_packages(levels):
    store, _j = _store()
    f, w = 6, 192
    b, q, c, cm, el, st, li, _ref = _duplex_batch(21, f, w, LEVELS[levels], store)
    dw = tw.pack_duplex_inputs(b, q, c, cm, el, st, li, qual_mode="auto")
    words = dw.to_words()
    jsec = jw.split_duplex_wire(words, f, w, qual_mode=dw.qual_mode)
    want = jw.unpack_duplex_inputs(*jsec[:3], f, w, qual_mode=dw.qual_mode)
    tsec = tw.split_duplex_wire(_dev(words), f, w, qual_mode=dw.qual_mode)
    got = tw.unpack_duplex_inputs(*tsec[:3], f, w, qual_mode=dw.qual_mode)
    for g, x in zip(got, want):
        np.testing.assert_array_equal(g.numpy(), np.asarray(x))
    np.testing.assert_array_equal(got[0].numpy(), b)
    np.testing.assert_array_equal(got[1].numpy()[c], q[c])
    np.testing.assert_array_equal(trs.widen_u32(tsec[3].view(torch.int32)).numpy(), st)
    np.testing.assert_array_equal(trs.widen_u32(tsec[4].view(torch.int32)).numpy(), li)

    mb, mq = _molecular_envelope(22, 5, 3, w, LEVELS[levels])
    rows = _packed_rows(mb, mq)
    v2, mode = tw.pack_molecular_rows_wire(*rows, qual_mode="auto")
    n, nf = rows[0].shape[0], rows[3]
    jn, jq, jseg, joff = jw.split_molecular_rows_wire(v2, n, nf, w, mode)
    want = jw.unpack_rows_wire_inputs(jn, jq, n, w, mode)
    tn, tq, tseg, toff = tw.split_molecular_rows_wire(_dev(v2), n, nf, w, mode)
    got = tw.unpack_rows_wire_inputs(tn, tq, n, w, mode)
    for g, x in zip(got, want):
        np.testing.assert_array_equal(g.numpy(), np.asarray(x))
    np.testing.assert_array_equal(tseg.view(torch.int32).numpy(), np.asarray(jseg).astype(np.int32))
    np.testing.assert_array_equal(toff.view(torch.int32).numpy(), np.asarray(joff).astype(np.int32))


# ---------------------------------------------------------------- refstore


def test_window_gathers_equal_the_jax_packages():
    store, jstore = _store()
    w = 64
    # NO_REF, chrA's start, past chrA's end, ending at the genome's last
    # base, starting within w of the end, chrB, an unknown contig, start < 0
    rid = np.array([-1, 0, 0, 1, 1, 1, 5, 0])
    ws = np.array([0, 0, 700 - w // 2, 400 - w, 400 - w // 3, 10, 3, -4])
    for a, x in zip(store.window_offsets(rid, ws), jstore.window_offsets(rid, ws)):
        np.testing.assert_array_equal(a, x)
    starts, limits = store.window_offsets(rid, ws)
    los = store.window_origins(rid)
    np.testing.assert_array_equal(los, jstore.window_origins(rid))
    np.testing.assert_array_equal(store.contig_indices(["chrB", "x", "chrA"]),
                                  jstore.contig_indices(["chrB", "x", "chrA"]))
    genome = torch.from_numpy(store.codes)
    for width in (w + 1, w + 4):
        want = np.asarray(jrs.gather_windows(jstore.codes, starts, limits, width))
        got = trs.gather_windows(genome, starts, limits, width).numpy()
        np.testing.assert_array_equal(got, want)
        np.testing.assert_array_equal(store.host_windows(starts, limits, width), want)
        want = np.asarray(jrs.gather_windows_ext(jstore.codes, starts, los, limits, width))
        got = trs.gather_windows_ext(genome, starts, los, limits, width).numpy()
        np.testing.assert_array_equal(got, want)
        np.testing.assert_array_equal(store.host_windows_ext(starts, los, limits, width), want)
    assert (got[0] == N).all()  # NO_REF: all N
    assert (store.host_windows(starts, limits, w + 1)[2, -1] == N)  # past chrA's end
    # the genome's last base is gathered, the column after it is N
    last = store.host_windows(starts, limits, w + 1)[3]
    assert last[w - 1] == store.codes[-1] and last[w] == N


def test_refstore_from_fasta_and_its_device_copy(tmp_path):
    from bsseqconsensusreads_tpu.utils.testing import write_fasta

    fasta = str(tmp_path / "g.fa")
    write_fasta(fasta, "chr1", "ACGTNacgt" * 30)
    store, jstore = trs.RefStore.from_fasta(fasta), jrs.RefStore.from_fasta(fasta)
    np.testing.assert_array_equal(store.codes, jstore.codes)
    assert store.names == jstore.names
    # uploaded once per device
    assert store.device_codes("cpu") is store.device_codes(torch.device("cpu"))
    assert (trs.NO_REF, trs.MAX_GENOME) == (jrs.NO_REF, jrs.MAX_GENOME)


@pytest.mark.parametrize("layout", ["width60_tail", "crlf_width61", "one_line_each"])
def test_refstore_from_fasta_bytes_equal_the_jax_packages(tmp_path, layout):
    """The byte-level genome read (span + translate, line ends dropped)
    against the JAX package's per-contig fetch: several contigs, a short
    last line, CRLF line ends, lowercase and N runs, an IUPAC code."""
    rng = np.random.default_rng(12)
    width, eol = {"width60_tail": (60, b"\n"), "crlf_width61": (61, b"\r\n"),
                  "one_line_each": (10_000, b"\n")}[layout]
    seqs = {}
    with open(tmp_path / "g.fa", "wb") as fh:
        for i, n in enumerate((1, 59, 60, 61, 250, 733)):
            seq = bytes(np.frombuffer(b"ACGTacgtNnRY", np.uint8)[rng.integers(0, 12, n)])
            seqs[f"c{i}"] = seq
            fh.write(f">c{i} desc\n".encode())
            for k in range(0, n, width):
                fh.write(seq[k:k + width] + eol)
    fasta = str(tmp_path / "g.fa")
    store, jstore = trs.RefStore.from_fasta(fasta), jrs.RefStore.from_fasta(fasta)
    assert store.names == jstore.names == list(seqs)
    np.testing.assert_array_equal(store.lengths, jstore.lengths)
    np.testing.assert_array_equal(store.codes, jstore.codes)
    np.testing.assert_array_equal(store.codes[-733:], BASE_CODE[np.frombuffer(seqs["c5"], np.uint8)])


# ---------------------------------------------------------------- kernels


def _duplex_wire_run(seed, levels, store, tp):
    """A duplex batch packed, then voted by the port's wire kernel:
    (batch arrays, wire, its output bytes)."""
    f, w = 12, 96
    b, q, c, cm, el, st, li, ref = _duplex_batch(seed, f, w, LEVELS[levels], store)
    dw = tw.pack_duplex_inputs(b, q, c, cm, el, st, li, qual_mode="auto")
    got = td.duplex_call_wire_fused(
        _dev(dw.to_words()), store.device_codes("cpu"), f, w, params=tp, qual_mode=dw.qual_mode,
    ).numpy()
    return (b, q, c, cm, el, ref), dw, got


@pytest.mark.parametrize("levels", ["levels4", "levels30"])
def test_duplex_wire_kernel_bytes_equal_the_jax_packages(levels):
    tp, jp = _params()
    store, jstore = _store()
    (b, q, c, cm, el, ref), dw, got = _duplex_wire_run(31, levels, store, tp)
    f, w = b.shape[0], b.shape[-1]
    # the JAX package's unpack + gather + vote of the same words, packed
    # as its unpacked route packs them
    sec = jw.split_duplex_wire(dw.to_words(), f, w, qual_mode=dw.qual_mode)
    inputs = jw.unpack_duplex_inputs(*sec[:3], f, w, qual_mode=dw.qual_mode)
    jref = jrs.gather_windows(jstore.codes, sec[3], sec[4], w + 1)
    jwire, _la, _rd = jd.duplex_call_pipeline_packed(
        *inputs[:3], jref, *inputs[3:], params=jp, layout="packed")
    np.testing.assert_array_equal(got, np.asarray(jwire).view(np.uint8))
    # and the port's unpacked route on the host-gathered windows
    planes, _la, _rd = td.duplex_call_pipeline_packed(
        torch.from_numpy(b), torch.from_numpy(q.astype(np.int16)), torch.from_numpy(c),
        torch.from_numpy(ref), torch.from_numpy(cm), torch.from_numpy(el), params=tp,
    )
    np.testing.assert_array_equal(got, planes.numpy())
    with pytest.raises(ValueError, match="4 rows"):
        td.duplex_call_wire_fused(_dev(dw.to_words()), store.device_codes("cpu"), f, w, r=2)


@pytest.mark.parametrize("levels", ["levels4", "levels30"])
def test_duplex_wire_output_equals_the_jax_wire_retired(levels):
    """The JAX package's wire ships the b0 planes and rebuilds the quals on
    the host (ops.reconstruct.retire_duplex_wire); the port's wire ships
    the planes whole. Both routes end in the same arrays."""
    tp, jp = _params()
    store, jstore = _store()
    (_b, q, c, _cm, el, _ref), dw, got = _duplex_wire_run(51, levels, store, tp)
    f, w = c.shape[0], c.shape[-1]
    jwire = np.asarray(jd.duplex_call_wire_fused(
        dw.to_words(), jstore.codes, f, w, params=jp, qual_mode=dw.qual_mode, layout="packed",
    ))
    want = jrec.retire_duplex_wire(jwire, f, w, c, q.astype(np.float32), el, jp, "xla")
    out = td.unpack_duplex_outputs(got, f, w)
    assert sorted(out) == sorted(set(want) - {"la", "rd"})
    for k in out:
        np.testing.assert_array_equal(out[k], want[k], err_msg=k)


@pytest.mark.parametrize("levels", ["levels4", "levels11"])
def test_molecular_wire_kernels_bytes_equal_the_jax_packages(levels):
    tp, jp = ConsensusParams(), JaxParams()
    f, t, w = 6, 3, 64
    b, q = _molecular_envelope(41, f, t, w, LEVELS[levels])
    v1 = tw.pack_molecular_inputs(b, q, qual_mode="auto")
    want = np.asarray(jm.molecular_wire_kernel()(
        v1.to_words(), f, t, w, params=jp, qual_mode=v1.qual_mode)).view(np.uint8)
    got = tm.molecular_wire_kernel(_dev(v1.to_words()), f, t, w, tp, v1.qual_mode).numpy()
    rows = _packed_rows(b, q)
    v2, mode = tw.pack_molecular_rows_wire(*rows, qual_mode="auto")
    n, nf = rows[0].shape[0], rows[3]
    want2 = np.asarray(jm.molecular_wire_packed_kernel("xla")(
        v2, n_rows=n, num_families=nf, w=w, params=jp, qual_mode=mode)).view(np.uint8)
    got2 = tm.molecular_wire_packed_kernel(_dev(v2), n, nf, w, tp, mode).numpy()
    np.testing.assert_array_equal(want2, want)  # the JAX package's two wires agree too
    np.testing.assert_array_equal(got2, got)  # packed rows vote the envelope's bits
    # the JAX wire's slim planes are the port's base and qual planes ...
    out = tm.unpack_molecular_outputs(got, f, w)
    for k, v in jm.unpack_molecular_slim_outputs(want, f, w).items():
        np.testing.assert_array_equal(out[k], v, err_msg=k)
    # ... and the whole output is the JAX package's unpacked route's
    full = np.asarray(jm.pack_molecular_outputs(jm.molecular_consensus(b, q, jp)))
    np.testing.assert_array_equal(got, full.view(np.uint8))
