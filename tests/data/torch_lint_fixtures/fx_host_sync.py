"""graftlint fixture: host-sync (torch) — one seeded violation.

`hot_` prefix marks the loop as a batch-loop root (engine.HOT_PATH_PREFIX);
`.item()` on the vote kernel's output waits for the card once per
iteration with no accounted ledger span around it. The same read under
`timed("device_wait")`, a CPU tensor, a numpy array and a `.shape` read
stay clean.
"""

import numpy as np
import torch


def seg_vote(bases, quals, offsets, params):
    return bases


def hot_fixture_loop(batches, metrics, params):
    total = 0
    for b, q, off in batches:
        out = seg_vote(b, q, off, params)
        total += out.sum().item()  # seeded: host-sync
        with metrics.timed("device_wait"):
            total += out.max().item()
        width = out.shape[-1]
        host = torch.zeros(width, device="cpu")
        total += int(host.sum().item())
        total += float(np.asarray([width]).sum())
    return total
