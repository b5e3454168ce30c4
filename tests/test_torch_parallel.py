"""The port's multi-device layer (parallel/mesh, sharding, deep_family,
multihost; the mesh routes of the batch callers) on CPU meshes against the
JAX package's on its 8 virtual CPU devices, and against one device.

Tolerances: the mesh shapes, pads and shard plans equal; the sharded
molecular (rows, outwire) and duplex outputs byte-equal to the JAX
package's sharded routes and to the port's one-device output; the deep
route's split: base, depth and errors equal, qual within 1 of one device
(the float sums add in another order — the JAX package documents and
tests the same relaxation, tests/test_parallel.py) and of the JAX
package's split; the callers' BAMs on a mesh (sharded and the round-robin
wire) SHA-equal to mesh=None; the two-process run (this file run as a
worker script in two processes over gloo) equal to one process.

Run as a script (`python tests/test_torch_parallel.py --worker PORT RANK
OUTDIR`) it is one worker of the two-process test and imports no JAX.
"""

import hashlib
import os
import socket
import subprocess
import sys

import numpy as np
import pytest
import torch

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
if REPO not in sys.path:
    sys.path.insert(0, REPO)

from bsseqconsensusreads_tpu_torch.alphabet import NBASE  # noqa: E402
from bsseqconsensusreads_tpu_torch.io.bam import BamHeader, BamReader, BamWriter  # noqa: E402
from bsseqconsensusreads_tpu_torch.models.molecular import (  # noqa: E402
    molecular_consensus,
    pack_molecular_outputs,
)
from bsseqconsensusreads_tpu_torch.models.params import ConsensusParams  # noqa: E402
from bsseqconsensusreads_tpu_torch.ops.encode import codes_to_seq  # noqa: E402
from bsseqconsensusreads_tpu_torch.parallel import multihost  # noqa: E402
from bsseqconsensusreads_tpu_torch.parallel import sharding  # noqa: E402
from bsseqconsensusreads_tpu_torch.parallel.deep_family import (  # noqa: E402
    deep_family_consensus,
)
from bsseqconsensusreads_tpu_torch.parallel.mesh import (  # noqa: E402
    default_mesh,
    make_mesh,
    pad_families,
)
from bsseqconsensusreads_tpu_torch.pipeline import calling as pcalling  # noqa: E402
from bsseqconsensusreads_tpu_torch.pipeline import extsort as pextsort  # noqa: E402
from bsseqconsensusreads_tpu_torch.pipeline import stages as pstages  # noqa: E402
from bsseqconsensusreads_tpu_torch.utils.testing import (  # noqa: E402
    stream_duplex_families,
    write_fasta,
)

CPU8 = ["cpu"] * 8


def _sha(path: str) -> str:
    with open(path, "rb") as fh:
        return hashlib.sha256(fh.read()).hexdigest()


def _bytes(a) -> bytes:
    a = a.cpu().numpy() if isinstance(a, torch.Tensor) else np.asarray(a)
    return np.ascontiguousarray(a).tobytes()


def _families(seed, f, t, w, n_frac=0.2):
    rng = np.random.default_rng(seed)
    bases = rng.integers(0, 4, size=(f, t, 2, w)).astype(np.int8)
    bases[rng.random(bases.shape) < n_frac] = NBASE
    quals = rng.integers(2, 41, size=bases.shape).astype(np.uint8)
    return bases, quals


# ---------------------------------------------------------------- mesh


def test_mesh_shapes_refusals_and_pads_equal_the_jax_packages():
    import jax

    from bsseqconsensusreads_tpu.parallel import mesh as jmesh

    assert make_mesh(devices=CPU8).shape == jmesh.make_mesh().shape == {"data": 8, "reads": 1}
    assert make_mesh(n_data=4, n_reads=2, devices=CPU8).shape == \
        jmesh.make_mesh(n_data=4, n_reads=2).shape
    m = make_mesh(n_data=2, n_reads=2, devices=["cpu:0", "cpu:1", "cpu:2", "cpu:3"])
    assert [str(d) for d in m.devices.flat] == ["cpu:0", "cpu:1", "cpu:2", "cpu:3"]
    assert m.local_slots() == [(0, 0), (0, 1), (1, 0), (1, 1)]
    for kw in ({"n_data": 16, "n_reads": 2}, {"n_data": 9}):
        with pytest.raises(ValueError, match="needs"):
            make_mesh(devices=CPU8, **kw)
        with pytest.raises(ValueError, match="needs"):
            jmesh.make_mesh(devices=jax.devices(), **kw)
    if not torch.cuda.is_available():  # no card: the default mesh refuses, never shrinks
        with pytest.raises(ValueError, match="needs 1 devices, have 0"):
            default_mesh()
    arrs = (np.ones((5, 3), np.int8), np.ones((5, 2), np.float32), np.ones(5, bool))
    (got, n), (want, jn) = pad_families(arrs, 5, 4), jmesh.pad_families(arrs, 5, 4)
    assert n == jn == 8
    for g, w in zip(got, want):
        np.testing.assert_array_equal(g, w)
    assert (got[0][5:] == NBASE).all() and (~got[2][5:]).all()


@pytest.mark.parametrize("f,shards", [(13, 4), (64, 8), (1, 2), (16, 3)])
def test_shard_packed_rows_equals_the_jax_packages(f, shards):
    from bsseqconsensusreads_tpu.ops import encode as jenc

    from bsseqconsensusreads_tpu_torch.ops import encode as penc

    rng = np.random.default_rng(f)
    bases, quals = _families(f, f, 4, 64)
    meta = [penc.FamilyMeta(str(i), 0, 0, int(rng.integers(1, 5))) for i in range(f)]
    jmeta = [jenc.FamilyMeta(str(i), 0, 0, m.n_templates) for i, m in enumerate(meta)]
    pk = penc.pack_molecular_rows(penc.MolecularBatch(bases, quals, meta))
    jpk = jenc.pack_molecular_rows(jenc.MolecularBatch(bases, quals, jmeta))
    got, want = penc.shard_packed_rows(pk, shards), jenc.shard_packed_rows(jpk, shards)
    for k in ("bases", "quals", "seg"):
        np.testing.assert_array_equal(getattr(got, k), getattr(want, k))
    for k in ("fams_per_shard", "n_shards", "total_families", "n_real_rows"):
        assert getattr(got, k) == getattr(want, k)


# ---------------------------------------------------------------- sharded routes


def _jax_mesh(n_data, n_reads=1):
    import jax

    from bsseqconsensusreads_tpu.parallel.mesh import make_mesh as jax_make_mesh

    return jax_make_mesh(n_data=n_data, n_reads=n_reads,
                         devices=jax.devices()[: n_data * n_reads])


@pytest.mark.parametrize("n_data", [4, 8])
def test_sharded_molecular_routes_equal_the_jax_packages_and_one_device(n_data):
    from bsseqconsensusreads_tpu.models.params import ConsensusParams as JaxParams
    from bsseqconsensusreads_tpu.ops import encode as jenc
    from bsseqconsensusreads_tpu.parallel import sharding as jsh

    from bsseqconsensusreads_tpu_torch.ops import encode as penc

    f, t, w = 16, 6, 128
    bases, quals = _families(41, f, t, w)
    mesh, jm = make_mesh(n_data, devices=CPU8), _jax_mesh(n_data)
    one = _bytes(pack_molecular_outputs(molecular_consensus(
        torch.from_numpy(bases), torch.from_numpy(quals), ConsensusParams())))
    got = sharding.sharded_molecular_outwire(mesh, ConsensusParams())(bases, quals)
    want = jsh.sharded_molecular_outwire(jm, JaxParams())(bases, quals)
    assert _bytes(got) == _bytes(want) == one
    got = sharding.sharded_molecular_consensus(mesh, ConsensusParams())(bases, quals)
    want = jsh.sharded_molecular_consensus(jm, JaxParams())(bases, quals)
    assert _bytes(pack_molecular_outputs(got)) == one
    for k in got:
        want_k = np.array(want[k])
        assert _bytes(got[k].to(torch.from_numpy(want_k).dtype)) == _bytes(want_k), k
    # the packed rows split at family boundaries
    n_tpl = np.random.default_rng(3).integers(1, t + 1, size=f)
    meta = [penc.FamilyMeta(str(i), 0, 0, int(n)) for i, n in enumerate(n_tpl)]
    jmeta = [jenc.FamilyMeta(str(i), 0, 0, int(n)) for i, n in enumerate(n_tpl)]
    for i, n in enumerate(n_tpl):
        bases[i, n:] = NBASE
    sp = penc.shard_packed_rows(penc.pack_molecular_rows(penc.MolecularBatch(bases, quals, meta)),
                                n_data)
    jsp = jenc.shard_packed_rows(jenc.pack_molecular_rows(jenc.MolecularBatch(bases, quals, jmeta)),
                                 n_data)
    got = sharding.sharded_molecular_rows(mesh, sp.fams_per_shard, ConsensusParams())(
        sp.bases, sp.quals, sp.seg)
    want = jsh.sharded_molecular_rows(jm, jsp.fams_per_shard, JaxParams())(
        jsp.bases, jsp.quals, jsp.seg)
    one = _bytes(pack_molecular_outputs(molecular_consensus(
        torch.from_numpy(bases), torch.from_numpy(quals), ConsensusParams())))
    assert _bytes(got) == _bytes(want)
    assert _bytes(got)[: len(one)] == one  # the pad families trail


def test_sharded_duplex_routes_equal_the_jax_packages_and_one_device():
    from bsseqconsensusreads_tpu.models.params import ConsensusParams as JaxParams
    from bsseqconsensusreads_tpu.ops.encode import encode_duplex_families, iter_mi_groups
    from bsseqconsensusreads_tpu.parallel import sharding as jsh
    from bsseqconsensusreads_tpu.utils.testing import make_aligned_duplex_group, random_genome

    from bsseqconsensusreads_tpu_torch.models.duplex import (
        duplex_call_pipeline,
        duplex_call_pipeline_packed,
    )

    rng = np.random.default_rng(45)
    name, genome = random_genome(rng, 3000)
    recs = []
    for mi in range(8):
        recs += make_aligned_duplex_group(rng, name, genome, mi, 30 + mi * 150, 80)
    batch, _, _ = encode_duplex_families(iter_mi_groups(recs, strip_suffix=True),
                                         lambda n, s, e: genome[s:e], [name])
    arrays = (batch.bases, batch.quals, batch.cover, batch.ref, batch.convert_mask,
              batch.extend_eligible)
    mesh, jm = make_mesh(4, devices=CPU8), _jax_mesh(4)
    got = sharding.sharded_duplex_outwire(mesh, ConsensusParams(min_reads=0))(*arrays)
    want = jsh.sharded_duplex_outwire(jm, JaxParams(min_reads=0))(*arrays)
    one = duplex_call_pipeline_packed(*(torch.from_numpy(a) for a in arrays),
                                      params=ConsensusParams(min_reads=0))
    for g, w, o in zip(got, want, one):
        assert _bytes(g) == _bytes(w) == _bytes(o)
    got = sharding.sharded_duplex_pipeline(mesh, ConsensusParams(min_reads=0))(*arrays)
    want = jsh.sharded_duplex_pipeline(jm, JaxParams(min_reads=0))(*arrays)
    one = duplex_call_pipeline(*(torch.from_numpy(a) for a in arrays),
                               params=ConsensusParams(min_reads=0))
    assert set(got) == set(one)
    for k in got:
        assert _bytes(got[k]) == _bytes(one[k]), k
        want_k = np.array(want[k])
        assert _bytes(got[k].to(torch.from_numpy(want_k).dtype)) == _bytes(want_k), k


@pytest.mark.parametrize("shape", [(1, 2), (4, 2), (1, 8)])
def test_deep_split_equals_one_device_and_the_jax_packages_within_one_qual(shape):
    from bsseqconsensusreads_tpu.models.params import ConsensusParams as JaxParams
    from bsseqconsensusreads_tpu.parallel.deep_family import (
        deep_family_consensus as jdeep,
        deep_family_consensus_rows as jdeep_rows,
    )

    n_data, n_reads = shape
    f, t, w = n_data, 64 * n_reads, 128
    bases, quals = _families(43 + n_reads, f, t, w, n_frac=0.3)
    mesh = make_mesh(n_data, n_reads, devices=CPU8)
    one = {k: v.numpy() for k, v in molecular_consensus(
        torch.from_numpy(bases), torch.from_numpy(quals), ConsensusParams()).items()}
    jm = _jax_mesh(n_data, n_reads)
    # the port's one entry point against both of the JAX package's
    got = {k: v.numpy() for k, v in deep_family_consensus(mesh, ConsensusParams())(
        bases, quals).items()}
    for theirs in (jdeep_rows, jdeep):
        want = {k: np.asarray(v) for k, v in theirs(jm, JaxParams())(bases, quals).items()}
        for k in ("base", "depth", "errors"):
            np.testing.assert_array_equal(got[k], one[k], err_msg=k)
            np.testing.assert_array_equal(got[k], want[k], err_msg=k)
        for ref in (one, want):
            assert np.abs(got["qual"].astype(np.int32) - ref["qual"].astype(np.int32)).max() <= 1
        assert got["qual"].dtype == one["qual"].dtype and got["depth"].dtype == one["depth"].dtype


# ---------------------------------------------------------------- the callers on a mesh


@pytest.fixture(scope="module")
def mix_env(tmp_path_factory):
    """A bisulfite mixture of 1 and 3 templates per strand with 5% indel
    reads, and one 40-template family for the deep route."""
    tmp = tmp_path_factory.mktemp("torch_parallel")
    codes = np.random.default_rng(5).integers(0, 4, size=30_000).astype(np.int8)
    fasta = str(tmp / "genome.fa")
    write_fasta(fasta, "chr1", codes_to_seq(codes))
    recs = stream_duplex_families(
        codes, 96, read_len=100, bisulfite=True, indel_rate=0.05,
        templates_for=lambda fam: 40 if fam == 50 else (1 if fam % 10 < 6 else 3),
    )
    bam = str(tmp / "grouped.bam")
    with BamWriter(bam, BamHeader("@HD\tVN:1.6\tSO:coordinate\n", [("chr1", 30_000)])) as w:
        w.write_all(recs)
    return {"tmp": tmp, "fasta": fasta, "bam": bam, "runs": {}}


def _chain(env, tag, mesh, transport="unpacked", engine="native", deep_threshold=None):
    """The port's molecular -> duplex chain on the CPU (indel_policy
    'align', 16 families per batch); returns (molecular, duplex) paths."""
    if tag in env["runs"]:
        return env["runs"][tag]
    mol = str(env["tmp"] / f"mol_{tag}.bam")
    st = pcalling.StageStats()
    with BamReader(env["bam"]) as r:
        src = pstages.molecular_ingest_stream(env["bam"], r, st, ingest_choice=engine,
                                              indel_policy="align")
        batches = pcalling.call_molecular_batches(
            src, ConsensusParams(min_reads=1), mode="self", grouping="coordinate",
            batch_families=16, stats=st, device="cpu", emit=engine, indel_policy="align",
            transport=transport, mesh=mesh, deep_threshold=deep_threshold)
        pextsort.write_batch_stream(batches, mol, r.header, "self", sort_engine=engine)
    dup = str(env["tmp"] / f"dup_{tag}.bam")
    ds = pcalling.StageStats()
    from bsseqconsensusreads_tpu_torch.io.fasta import FastaFile

    with BamReader(mol) as r, FastaFile(env["fasta"]) as fa:
        src = pstages.duplex_ingest_stream(mol, r, ds, ingest_choice=engine)
        batches = pcalling.call_duplex_batches(
            src, fa.fetch, ["chr1"], ConsensusParams(min_reads=0), mode="self",
            grouping="coordinate", batch_families=16, stats=ds, device="cpu", emit=engine,
            transport=transport, mesh=mesh, refstore=env["fasta"])
        pextsort.write_batch_stream(batches, dup, r.header, "self", sort_engine=engine)
    env["runs"][tag] = (mol, dup, st, ds)
    return env["runs"][tag]


@pytest.mark.parametrize("route,n_data,transport", [
    ("sharded", 4, "unpacked"), ("sharded", 3, "auto"), ("wire_mc", 4, "wire"),
    ("wire_mc", 2, "wire"),
])
def test_callers_on_a_mesh_write_the_one_device_bytes(mix_env, route, n_data, transport):
    mol, dup, _st, _ds = _chain(mix_env, "one", None)
    mmol, mdup, st, ds = _chain(mix_env, f"{route}{n_data}", make_mesh(n_data, devices=CPU8),
                                transport=transport)
    assert _sha(mmol) == _sha(mol)
    assert _sha(mdup) == _sha(dup)
    for stats in (st, ds):
        c = stats.metrics.counters
        assert c[f"route_batches_{route}"] == stats.batches - c.get("deep_routed_families", 0) > 0
        assert not {k for k in c if k.startswith("route_batches_")} - {f"route_batches_{route}"}
    assert st.indel_aligned > 0


def test_wire_round_robin_equals_unpacked_and_python_engines(mix_env):
    one = _chain(mix_env, "one", None)
    py = _chain(mix_env, "py_wire_mc", make_mesh(4, devices=CPU8), transport="wire",
                engine="python")
    assert _sha(py[0]) == _sha(one[0]) and _sha(py[1]) == _sha(one[1])


def _records(path):
    with BamReader(path) as r:
        return list(r)


def test_deep_route_on_a_mesh_matches_one_device_within_one_qual(mix_env):
    """The 40-template family (both strands) deep at threshold 16: its
    template axis over 8 slots; every record equal to the one-device
    run's apart from quals within 1."""
    one, _d, _s, _ds = _chain(mix_env, "deep_one", None, deep_threshold=16)
    got, _d, st, _ds = _chain(mix_env, "deep_mesh", make_mesh(8, devices=CPU8),
                              deep_threshold=16)
    assert st.counter("deep_routed_families") == 2
    a, b = _records(got), _records(one)
    assert len(a) == len(b)
    for x, y in zip(a, b):
        assert (x.qname, x.flag, x.pos, x.seq, x.tags) == (y.qname, y.flag, y.pos, y.seq, y.tags)
        dq = np.abs(np.frombuffer(x.qual, np.uint8).astype(int)
                    - np.frombuffer(y.qual, np.uint8).astype(int))
        assert dq.max(initial=0) <= 1


def test_mesh_resolution_and_refusals():
    cpu = torch.device("cpu")
    assert pcalling._resolve_mesh("auto", cpu) is None  # the CPU never shards under 'auto'
    m = make_mesh(2, devices=["cpu", "cpu"])
    assert pcalling._resolve_mesh(m, cpu) is m and pcalling._resolve_mesh(None, cpu) is None
    with pytest.raises(ValueError, match="mesh must be"):
        pcalling._resolve_mesh("all", cpu)
    assert pcalling._resolve_transport("wire", cpu, m) == "wire-mc"
    assert pcalling._resolve_transport("auto", cpu, m) == "off"
    assert pcalling._resolve_transport("unpacked", cpu, m) == "off"
    assert pcalling._resolve_transport("wire", cpu) == "wire"
    rr = pcalling._WireRoundRobin(make_mesh(3, devices=["cpu"] * 3))
    assert [rr.next_slot()[0] for _ in range(4)] == [(0, 0), (1, 0), (2, 0), (0, 0)]
    assert pcalling._pipeline_depth(pcalling._Inline(), rr) == 3
    if torch.cuda.is_available():
        return
    with pytest.raises(ValueError, match="cannot run on a mesh"):
        pcalling._resolve_mesh(make_mesh(2, devices=["meta", "meta"]), cpu)


# ---------------------------------------------------------------- multihost


def test_multihost_helpers_equal_the_jax_packages_in_one_process():
    from bsseqconsensusreads_tpu.parallel import multihost as jmh

    mesh, jm = multihost.multihost_family_mesh(devices=CPU8), jmh.multihost_family_mesh()
    assert mesh.shape == jm.shape
    for n in (16, 64):
        assert multihost.local_family_count(n, mesh) == jmh.local_family_count(n, jm)
    with pytest.raises(ValueError, match="pad first"):
        multihost.local_family_count(13, mesh)
    with pytest.raises(ValueError, match="pad first"):
        jmh.local_family_count(13, jm)
    bases, quals = _families(77, 16, 5, 64)
    gb, gq = multihost.global_family_batch((bases, quals), 16, mesh)
    jb, jq = jmh.global_family_batch((bases, quals), 16, jm)
    np.testing.assert_array_equal(np.asarray(gb), np.asarray(jb))
    with pytest.raises(ValueError, match="local family rows"):
        multihost.global_family_batch((bases[:8],), 16, mesh)
    got = sharding.sharded_molecular_outwire(mesh, ConsensusParams())(gb, gq)
    from bsseqconsensusreads_tpu.models.params import ConsensusParams as JaxParams
    from bsseqconsensusreads_tpu.parallel.sharding import sharded_molecular_outwire as jsh

    want = jsh(jm, JaxParams())(jb, jq)
    # the JAX package's output wire is flat u32 words; the port's, its bytes
    assert multihost.local_rows(got.reshape(16, -1), 16).tobytes() == \
        jmh.local_rows(want, want.shape[0]).tobytes()
    multihost.init_distributed(num_processes=1)  # a no-op
    assert multihost.process_count() == 1


def _free_port() -> int:
    with socket.socket() as s:
        s.bind(("localhost", 0))
        return s.getsockname()[1]


def test_two_processes_over_gloo_equal_one_process(mix_env, tmp_path):
    port = _free_port()
    env = {**os.environ, "PYTHONPATH": REPO, "OMP_NUM_THREADS": "1"}
    procs = [subprocess.Popen(
        [sys.executable, os.path.abspath(__file__), "--worker", str(port), str(rank),
         str(tmp_path), mix_env["bam"]],
        env=env, stdout=subprocess.PIPE, stderr=subprocess.PIPE, text=True,
    ) for rank in range(2)]
    outs = [p.communicate(timeout=120) for p in procs]
    for p, (_out, err) in zip(procs, outs):
        assert p.returncode == 0, err[-3000:]
    # the sharded kernel: each process's rows of the global batch
    bases, quals = _families(77, 16, 5, 64)
    one = _bytes(pack_molecular_outputs(molecular_consensus(
        torch.from_numpy(bases), torch.from_numpy(quals), ConsensusParams())))
    parts = [np.load(tmp_path / f"wire_{r}.npy") for r in range(2)]
    assert b"".join(p.tobytes() for p in parts) == one
    # the molecular stage over each process's share of the families
    merged = [blob for r in range(2) for blob in _blobs(str(tmp_path / f"mol_{r}.bam"))]
    whole = str(tmp_path / "mol_one.bam")
    _share_stage(mix_env["bam"], whole, None)
    assert merged == _blobs(whole)
    assert all("worker_heartbeat" in err for _o, err in outs)


def _blobs(path):
    with BamReader(path) as r:
        return list(r.raw_records())


def _share_stage(bam, out, mesh, share=slice(None)):
    """The molecular stage over the MI groups `share` of `bam` (in input
    order) on `mesh`, unaligned, in sequential batches: one process's
    records are a contiguous run of the one-process output."""
    with BamReader(bam) as r:
        header = r.header
        groups = list(pcalling.stream_mi_groups(r, grouping="adjacent"))
    records = [rec for _mi, recs in groups[share] for rec in recs]
    batches = pcalling.call_molecular_batches(
        records, ConsensusParams(min_reads=1), mode="unaligned", grouping="adjacent",
        batching="sequential", batch_families=16, device="cpu", mesh=mesh,
        indel_policy="align")
    pextsort.write_batch_stream(batches, out, header, "unaligned")


def _worker(port: str, rank: int, outdir: str, bam: str) -> None:
    """One process of the two-process test: 2 CPU slots per process (a
    global data axis of 4), the sharded kernel on this process's rows of a
    seeded global batch, then the molecular stage on its share of the
    BAM's families."""
    multihost.init_distributed(f"localhost:{port}", 2, rank, backend="gloo")
    mesh = multihost.multihost_family_mesh(devices=["cpu", "cpu"])
    assert mesh.shape == {"data": 4, "reads": 1} and mesh.local_data() == [2 * rank, 2 * rank + 1]
    bases, quals = _families(77, 16, 5, 64)
    n_local, first = multihost.local_family_count(16, mesh)
    gb, gq = multihost.global_family_batch(
        (bases[first:first + n_local], quals[first:first + n_local]), 16, mesh)
    wire = sharding.sharded_molecular_outwire(mesh, ConsensusParams())(gb, gq)
    np.save(os.path.join(outdir, f"wire_{rank}.npy"),
            multihost.local_rows(wire.reshape(n_local, -1), n_local))
    with BamReader(bam) as r:
        n_groups = sum(1 for _ in pcalling.stream_mi_groups(r, grouping="adjacent"))
    _pads, n_pad = pad_families((np.zeros(n_groups),), n_groups, mesh.shape["data"])
    count, first = multihost.local_family_count(n_pad, mesh)
    _share_stage(bam, os.path.join(outdir, f"mol_{rank}.bam"), mesh,
                 slice(first, first + count))
    import torch.distributed as dist

    dist.barrier()
    dist.destroy_process_group()


if __name__ == "__main__" and sys.argv[1:2] == ["--worker"]:
    _worker(sys.argv[2], int(sys.argv[3]), sys.argv[4], sys.argv[5])
