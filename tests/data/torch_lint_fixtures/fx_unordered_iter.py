"""graftlint fixture: unordered-shape-iter — one seeded violation.

Iterating a set of sizes on a hot-path function (`hot_` prefix) makes
downstream batch shapes follow the hash seed.
"""


def hot_fixture_shapes(fn, items):
    sizes = {len(i) for i in items}
    outs = []
    for s in sizes:  # seeded: unordered-shape-iter
        outs.append(fn(s))
    return outs
