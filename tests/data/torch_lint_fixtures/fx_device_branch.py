"""graftlint fixture: device-branch — one seeded violation.

A Python `if` on a tensor made on the card is a hidden bool() that waits
for it; a `None` test and a branch on the tensor's shape stay clean.
"""

import torch


def hot_fixture_branch(n, device, mask=None):
    t = torch.arange(n, device=device)
    if mask is not None and t.shape[0] > 0:
        t = t + 1
    if t.any():  # seeded: device-branch
        return t
    return None
