"""The reference's extend (reference.duplex.extend_columns) against the
system's specification of it: vectors of the JAX package's
`ops.extend.extend_gap` (the reference the port was built and is tested
against), written by running it on the CPU once and kept in
data/extend_vectors.json, so that nothing here imports JAX. Each vector
also holds the upstream tool's read-space prepend / append
(tools/2.extend_gap.py, SURVEY.md section 3.3) for the same rows: the two
rules agree where a strand pair's edges line up and part where a
molecular record lost an edge column (PERF.md, Open questions)."""

import json
import os

import numpy as np
import pytest

from reference.duplex import extend_columns

DATA = os.path.join(os.path.dirname(os.path.abspath(__file__)), "data", "extend_vectors.json")
VECTORS = json.load(open(DATA))
ROWS = VECTORS["rows"]


def _extend(case):
    b = {f: np.array(case["bases"][i]) for i, f in enumerate(ROWS)}
    q = {f: np.array(case["quals"][i]) for i, f in enumerate(ROWS)}
    cov = {f: np.array(case["cover"][i], bool) for i, f in enumerate(ROWS)}
    extend_columns(b, q, cov, {f: (case["la"][i], case["rd"][i])
                               for i, f in enumerate(ROWS) if f in (163, 83)})
    return {"bases": [np.where(cov[f], b[f], 4).tolist() for f in ROWS],
            "quals": [np.where(cov[f], q[f], 0).tolist() for f in ROWS],
            "cover": [cov[f].astype(int).tolist() for f in ROWS]}


@pytest.mark.parametrize("i", range(len(VECTORS["cases"])))
def test_reference_extend_equals_the_jax_packages(i):
    case = VECTORS["cases"][i]
    assert _extend(case) == case["jax"]


def test_the_upstream_rule_differs_only_where_edges_do_not_line_up():
    aligned, shifted = VECTORS["cases"][0], VECTORS["cases"][1]
    assert aligned["jax"] == aligned["upstream"]
    assert _extend(shifted) != shifted["upstream"]
