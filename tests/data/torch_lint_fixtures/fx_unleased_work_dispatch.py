"""Seeded fixture: unleased-work-dispatch.

A dispatch loop handing work slices to a transport send with no lease
in scope, next to its leased twin that must stay clean.
"""

from bsseqconsensusreads_tpu_torch.serve import transport


def dispatch_all(address, slices):
    results = []
    for sl in slices:
        slice_trace = sl.get("trace")  # traced, but STILL unleased
        resp = transport.request(address, {"op": "assign", "slice": sl, "trace": slice_trace})  # seeded: unleased-work-dispatch
        results.append(resp)
    return results


def dispatch_leased(address, slices, ledger):
    results = []
    for sl in slices:
        lease_id = ledger.lease(sl)
        lease_expires = ledger.expiry_of(lease_id)
        slice_trace = sl.get("trace")
        resp = transport.request(
            address,
            {"op": "assign", "slice": sl, "lease_id": lease_id,
             "until": lease_expires, "trace": slice_trace},
        )
        results.append(resp)
    return results
