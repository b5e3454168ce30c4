"""Seeded fixture: untraced-transport-send.

A work payload (a job spec) handed to a transport send with no trace
context bound in the dispatching scope, next to its traced twin that
must stay clean. No dispatch loops here — the lease-discipline rule
(unleased-work-dispatch) is loop-scoped and owns its own fixture.
"""

from bsseqconsensusreads_tpu_torch.serve import transport


def forward_job(address, spec):
    return transport.request(address, {"op": "submit", "spec": spec})  # seeded: untraced-transport-send


def forward_job_traced(address, spec, observe, job):
    with observe.bind_trace(job.trace) as trace_ctx:
        return transport.request(
            address, {"op": "submit", "spec": spec, "_trace": trace_ctx}
        )
