"""Seeded fixture: unfenced-commit.

A worker loop that publishes a finished slice without any fence epoch
in scope — the zombie-writer shape graftnet's fencing refuses — plus a
clean twin that carries the lease grant's fence_epoch.
"""

from bsseqconsensusreads_tpu_torch.serve import transport


def zombie_publish(address, sl, lease_id, manifest):
    slice_trace = sl.get("trace")  # traced, but STILL unfenced
    resp = transport.request(  # seeded: unfenced-commit
        address,
        {"op": "publish", "lease_id": lease_id,
         "slice": sl["sid"], "manifest": manifest,
         "trace": slice_trace},
        timeout=600.0,
    )
    return resp


def fenced_publish(address, sl, grant, manifest):
    # clean: the commit carries the grant's fence epoch, so a stale
    # holder is refused with publish_fenced instead of racing
    epoch = grant.get("fence_epoch")
    slice_trace = sl.get("trace")
    resp = transport.request(
        address,
        {"op": "publish", "lease_id": grant["lease_id"],
         "slice": sl["sid"], "manifest": manifest, "epoch": epoch,
         "trace": slice_trace},
        timeout=600.0,
    )
    return resp
