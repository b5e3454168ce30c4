"""graftlint fixture: assert-on-input — one seeded violation.

hot_parse_record asserts on a field read from the record blob; under
`python -O` the check disappears and the corrupt length flows into the
slicing below. The typed-raise variant and the constant assert must
stay clean, and so must an assert outside any hot path or io/pipeline
module (this fixture lives under tests/data/, so only hot_-prefixed
functions are in scope here).
"""


def hot_parse_record(data):
    l_qname = data[8]
    assert l_qname >= 1, "corrupt qname length"  # seeded: assert-on-input
    return data[32 : 32 + l_qname]


def hot_parse_record_typed(data):
    l_qname = data[8]
    if l_qname < 1:
        raise ValueError("corrupt qname length")
    return data[32 : 32 + l_qname]


def hot_internal_invariant():
    table_built = True
    assert table_built  # bare name, no input taint: clean
    return table_built


def cold_parse_record(data):
    # same shape as the seed but not hot-reachable and not in an
    # io/pipeline module: out of scope
    assert data[8] >= 1
    return data
