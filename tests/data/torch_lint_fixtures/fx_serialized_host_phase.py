"""graftlint fixture: serialized-host-phase — one seeded violation.

`hot_` prefix marks the loop as a batch-loop root; `host_workers` below
marks a host pool as available in the linted set. The rawize host span
runs inline between the batch's dispatch_kernel and fetch_out — the
serialized shape the rule flags. The post-fetch variant must stay
clean (that is the sanctioned worker-side retire shape).
"""


def host_workers():
    return 4


def fx_dispatch_kernel_stub(batch):
    return batch


def hot_serialized_batch_loop(batches, metrics, rawize, emit,
                              dispatch_kernel, fetch_out):
    out = []
    for batch in batches:
        wire = dispatch_kernel(batch)
        with metrics.timed("rawize"):  # seeded: serialized-host-phase
            rawize(batch)
        out.append(emit(fetch_out(wire)))
    return out


def hot_pipelined_batch_loop(batches, metrics, rawize, emit,
                             dispatch_kernel, fetch_out):
    """Clean twin: the host phases run AFTER the fetch, off the in-flight
    window — the worker-side retire shape."""
    out = []
    for batch in batches:
        wire = dispatch_kernel(batch)
        host = fetch_out(wire)
        with metrics.timed("rawize"):
            rawize(batch)
        with metrics.timed("emit"):
            out.append(emit(host))
    return out
