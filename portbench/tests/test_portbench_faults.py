"""A run with the timed path broken underneath comes out not correct:
one test per fault a cell can have (one chip: no exchange between chips
to leave out). The harness's look for a card is skipped (device 'cpu');
everything else is a run."""

import time

import numpy as np
import pytest
import torch

from harness.run_cell import run_cell
from helpers import tiny_cell

CELLS = [("emseq_wgs_duplex.dup4", 120, 60), ("emseq_wgs_duplex.lowpass", 160, 80)]


def _unchanged_convert(monkeypatch):
    """The duplex stage's conversion returns its state unchanged."""
    from bsseqconsensusreads_tpu_torch.models import duplex

    def same(bases, quals, cover, ref, convert_mask):
        z = torch.zeros(convert_mask.shape, dtype=torch.int8, device=bases.device)
        return bases, quals, cover, z, z

    monkeypatch.setattr(duplex, "convert_ag_to_ct", same)


def _half_batch(monkeypatch):
    """Each batch's emit leaves out its second half of families."""
    from bsseqconsensusreads_tpu_torch.io import wirepack

    orig = wirepack.emit_consensus_records

    def half(out, **kw):
        h = max(len(kw["mi"]) // 2, 1)

        def cut(v):
            if isinstance(v, tuple):
                return tuple(cut(x) for x in v)
            return v[:h] if v is not None else None

        kw = {k: (cut(v) if k not in ("min_reads", "mode_self", "duplex") else v)
              for k, v in kw.items()}
        return orig({k: np.asarray(v)[:h] for k, v in out.items()}, **kw)

    monkeypatch.setattr(wirepack, "emit_consensus_records", half)


def _altered_answer(monkeypatch):
    """The vote changes the first column's call of every segment."""
    from bsseqconsensusreads_tpu_torch.ops import cuda_vote

    orig = cuda_vote.seg_vote

    def altered(*a, **kw):
        out = orig(*a, **kw)
        b = out["base"][..., 0]
        out["base"][..., 0] = torch.where(b < 4, (b + 1) % 4, b).to(b.dtype)
        return out

    monkeypatch.setattr(cuda_vote, "seg_vote", altered)


FAULTS = {"state_unchanged": _unchanged_convert, "half_batch": _half_batch,
          "answer_altered": _altered_answer}


def _run(name, families, sample):
    cell = tiny_cell(name, families, sample)
    result, checks = run_cell(torch, cell, 2**31 + 99, 0.1, False, "cpu", time.monotonic())
    return result, checks


@pytest.mark.parametrize("name,families,sample", CELLS)
def test_sound_run_is_correct(name, families, sample):
    result, checks = _run(name, families, sample)
    assert result["correct"], checks


@pytest.mark.parametrize("fault", sorted(FAULTS))
@pytest.mark.parametrize("name,families,sample", CELLS)
def test_fault_is_not_correct(monkeypatch, fault, name, families, sample):
    FAULTS[fault](monkeypatch)
    result, checks = _run(name, families, sample)
    assert not result["correct"], checks
