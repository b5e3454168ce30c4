"""The check behind `correct`: the reference's records for the pass's
sampled families (portbench/reference, from the generated reads and the
genome alone), against what the program wrote (harness.compare).

The control puts the reference, computed in bfloat16 (the nearest type
below the float32 the configuration states for the vote), in the
program's place."""

from __future__ import annotations

import torch

from harness import compare
from reference.duplex import duplex_family
from reference.molecular import molecular_family

STRAND_FLAGS = {"A": (99, 147), "B": (163, 83)}


def params_of(cfg: dict) -> dict:
    return dict(cfg["consensus"])


def mi_name(fam: int, strand: str | None = None) -> str:
    base = f"{fam:08d}"
    return base if strand is None else f"{base}/{strand}"


def reference_records(inp, genome, cfg: dict, dtype=torch.float64) -> tuple[list, list]:
    """(molecular records, duplex records) of every sampled family."""
    params = params_of(cfg)
    mol_all, dup_all = [], []
    for fam, reads in inp.sample_reads.items():
        rid = int(inp.ref_id[fam])
        rx = inp.rx[fam]
        mol = {}
        for strand, flags in STRAND_FLAGS.items():
            sreads = [(f, ti, p, c, q) for f, ti, p, c, q in reads if f in flags]
            for r in molecular_family(mi_name(fam, strand), rx, rid, sreads, params, dtype):
                mol[r["flag"]] = r
                mol_all.append(r)
        dup_all.extend(duplex_family(mi_name(fam), rx, rid, mol, genome.contig(rid), params,
                                     dtype))
    return mol_all, dup_all


def _tally(got_mol: dict, got_dup: dict, want_mol: list, want_dup: list, inp,
           n_mid: int, n_out: int) -> dict:
    t = compare.Tally()
    by_name: dict = {}
    for r in want_mol + want_dup:
        by_name.setdefault(r["qname"], []).append(r)
    for name, want in by_name.items():
        got = got_mol.get(name, []) if "/" in name else got_dup.get(name, [])
        compare.compare_records(t, got, want)
    t.missing += abs(n_mid - 4 * inp.families) + abs(n_out - 2 * inp.families)
    return t.numbers()


def check_pass(inp, res, genome, cfg: dict) -> dict:
    """The numbers compared for the pass `res` (a chain.PassResult)."""
    want_mol, want_dup = reference_records(inp, genome, cfg)
    mol_names = {r["qname"] for r in want_mol}
    dup_names = {r["qname"] for r in want_dup}
    n_mid, got_mol = compare.program_records(res.mid, mol_names)
    n_out, got_dup = compare.program_records(res.out, dup_names)
    return _tally(got_mol, got_dup, want_mol, want_dup, inp, n_mid, n_out)


def control_numbers(inp, genome, cfg: dict, dtype=torch.bfloat16) -> dict:
    """The same numbers with the reference in `dtype` in the program's
    place (its record counts taken as the expected ones)."""
    want_mol, want_dup = reference_records(inp, genome, cfg)
    low_mol, low_dup = reference_records(inp, genome, cfg, dtype)
    got_mol, got_dup = {}, {}
    for r in low_mol:
        got_mol.setdefault(r["qname"], []).append(r)
    for r in low_dup:
        got_dup.setdefault(r["qname"], []).append(r)
    return _tally(got_mol, got_dup, want_mol, want_dup, inp, 4 * inp.families,
                  2 * inp.families)
