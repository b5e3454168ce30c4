"""The port's duplex stage ops (convert, extend, the duplex merge, the fused
pipeline and its output wire) and its kernel-built qual tables against the
JAX package's XLA legs, on the CPU. Bit-equal throughout.

Inputs: the JAX package's __graft_entry__._example_batch, and random
batches made from a seed with numpy that include reads at window column 0
(no prepend possible), trailing-C trims and families that are not
extend-eligible."""

import numpy as np
import pytest
import torch

from __graft_entry__ import _example_batch
from bsseqconsensusreads_tpu.models import duplex as jd
from bsseqconsensusreads_tpu.models.params import ConsensusParams as JaxParams
from bsseqconsensusreads_tpu.ops import reconstruct as jr
from bsseqconsensusreads_tpu.ops.convert import convert_ag_to_ct as j_convert
from bsseqconsensusreads_tpu.ops.extend import extend_gap as j_extend
from bsseqconsensusreads_tpu_torch.models import duplex as td
from bsseqconsensusreads_tpu_torch.models.params import ConsensusParams
from bsseqconsensusreads_tpu_torch.ops import reconstruct as tr
from bsseqconsensusreads_tpu_torch.ops.convert import convert_ag_to_ct
from bsseqconsensusreads_tpu_torch.ops.extend import extend_gap

C, G = 1, 2


def _random_batch(seed, f=24, w=64):
    """DuplexBatch planes with edge cases planted: convert rows starting at
    column 0, reads ending in C before a reference G, ragged coverage,
    missing rows and a mix of extend-eligible families."""
    rng = np.random.default_rng(seed)
    bases = np.full((f, 4, w), 4, np.int8)
    quals = np.zeros((f, 4, w), np.float32)
    cover = np.zeros((f, 4, w), bool)
    ref = rng.integers(0, 4, size=(f, w + 1)).astype(np.int8)
    for i in range(f):
        s0 = 0 if i % 5 == 0 else int(rng.integers(0, 8))
        e0 = int(rng.integers(w // 2, w))
        for r in range(4):
            if i % 7 == 3 and r == 2:
                continue  # a missing row
            s = s0 + int(rng.integers(0, 2))
            e = min(w, e0 - int(rng.integers(0, 2)))
            cover[i, r, s:e] = True
            bases[i, r, s:e] = ref[i, s:e]
            noise = rng.random(e - s) < 0.2
            bases[i, r, s:e][noise] = rng.integers(0, 4, int(noise.sum()))
            quals[i, r, s:e] = rng.integers(2, 41, e - s)
            if i % 3 == 0 and e < w:  # trailing C before a reference G
                bases[i, r, e - 1] = C
                ref[i, e] = G
    convert_mask = np.zeros((f, 4), bool)
    convert_mask[:, 1] = cover[:, 1].any(-1)
    convert_mask[:, 2] = cover[:, 2].any(-1)
    eligible = rng.random(f) < 0.7
    return bases, quals, cover, ref, convert_mask, eligible


BATCHES = {
    "example": lambda: _example_batch(f=4, w=128),
    "random_a": lambda: _random_batch(11),
    "random_b": lambda: _random_batch(12, f=16, w=96),
}


def _torch(arrays):
    b, q, c, ref, cm, el = arrays
    return (torch.from_numpy(b), torch.from_numpy(q.astype(np.int16)),
            torch.from_numpy(c), torch.from_numpy(ref), torch.from_numpy(cm),
            torch.from_numpy(el))


@pytest.mark.parametrize("name", sorted(BATCHES))
def test_convert_and_extend_are_bit_equal_to_jax(name):
    arrays = BATCHES[name]()
    b, q, c, ref, cm, el = arrays
    jb, jq, jc, jla, jrd = j_convert(b, q, c, ref, cm)
    tb, tq, tc, tla, trd = convert_ag_to_ct(*_torch(arrays)[:5])
    for got, want in ((tb, jb), (tq, jq), (tc, jc), (tla, jla), (trd, jrd)):
        np.testing.assert_array_equal(got.numpy(), np.asarray(want).astype(got.numpy().dtype))
    assert np.asarray(jla).any() and np.asarray(jrd).any() or name == "example"
    jb2, jq2, jc2 = j_extend(jb, jq, jc, jla, jrd, el)
    tb2, tq2, tc2 = extend_gap(tb, tq, tc, tla, trd, torch.from_numpy(el))
    for got, want in ((tb2, jb2), (tq2, jq2), (tc2, jc2)):
        np.testing.assert_array_equal(got.numpy(), np.asarray(want).astype(got.numpy().dtype))


@pytest.mark.parametrize("name", sorted(BATCHES))
def test_duplex_pipeline_wire_and_la_rd_are_bit_equal_to_jax(name):
    arrays = BATCHES[name]()
    jp, tp = JaxParams(min_reads=0), ConsensusParams(min_reads=0)
    jwire, jla, jrd = jd.duplex_call_pipeline_packed(
        *arrays, params=jp, vote_kernel="xla", layout="packed"
    )
    twire, tla, trd = td.duplex_call_pipeline_packed(*_torch(arrays), params=tp)
    np.testing.assert_array_equal(twire.numpy(), np.asarray(jwire).view(np.uint8))
    np.testing.assert_array_equal(tla.numpy(), np.asarray(jla))
    np.testing.assert_array_equal(trd.numpy(), np.asarray(jrd))
    f, w = arrays[0].shape[0], arrays[0].shape[-1]
    got = td.unpack_duplex_outputs(twire.numpy(), f, w)
    want = jd.unpack_duplex_outputs(np.asarray(jwire), f, w)
    for k in want:
        np.testing.assert_array_equal(got[k], want[k], err_msg=k)


@pytest.mark.parametrize("kw", [{}, {"min_input_base_quality": 20}])
def test_duplex_merge_planes_are_bit_equal_to_jax(kw):
    b, q, c, *_ = _random_batch(13)
    b = np.where(c, b, 4).astype(np.int8)
    jp, tp = JaxParams(min_reads=0, **kw), ConsensusParams(min_reads=0, **kw)
    want = jd.duplex_consensus_packed(b, q, jp, "xla")
    padded = jd.duplex_consensus(b, q, jp)
    got = td.duplex_consensus_packed(
        torch.from_numpy(b), torch.from_numpy(q.astype(np.int16)), tp
    )
    assert sorted(got) == sorted(want)
    for k in want:
        np.testing.assert_array_equal(got[k].numpy(), np.asarray(want[k]), err_msg=k)
        np.testing.assert_array_equal(got[k].numpy(), np.asarray(padded[k]), err_msg=k)


@pytest.mark.parametrize("kw", [{}, {"min_input_base_quality": 20, "min_consensus_base_quality": 30}])
def test_qual_tables_equal_the_jax_xla_tables(kw):
    want = jr.qual_tables(JaxParams(**kw), "xla")
    got = tr.qual_tables(ConsensusParams(**kw), "cpu")
    assert len(got) == len(want) == 5
    for g, w in zip(got, want):
        assert g.dtype == w.dtype and g.shape == w.shape
        np.testing.assert_array_equal(g, w)
