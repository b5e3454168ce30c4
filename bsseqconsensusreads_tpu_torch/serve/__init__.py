"""The resident consensus engine: many BAM jobs, one warm engine.

The port's counterpart of the JAX package's serve/. A long-lived process
holds what a one-shot CLI run rebuilds every time — on the card the vote
kernels' library (built once, or loaded from BSSEQ_TPU_COMPILE_CACHE_DIR),
the cached tables, the overlap workers' CUDA streams and the host pool —
and shares it across jobs submitted over a socket:

    jobs.py       job specs, guard admission, fingerprinting, the bounded
                  submission queue
    scheduler.py  continuous batching: families from DIFFERENT jobs
                  packed into the same device batch, demultiplexed at
                  retire by per-family job provenance (JobMi)
    server.py     ServeEngine (in-process API) + ServeServer (unix / TCP
                  protocol) + request
    transport.py  addresses, framing, typed refusals, the netchaos shim
    fleet.py      N serve replicas (processes) and their supervision
    router.py     placement, requeue and drain over a fleet

Identity contract: each job's output BAM is byte-identical to a
standalone `molecular --batching sequential` run of the same input;
isolation contract: one tenant's corrupt input, family bomb or stall never
blocks another tenant's retirement.
"""

from bsseqconsensusreads_tpu_torch.serve.jobs import (  # noqa: F401
    AdmissionError,
    Job,
    JobQueue,
    JobSpec,
    QueueClosed,
)
from bsseqconsensusreads_tpu_torch.serve.scheduler import (  # noqa: F401
    JobMi,
    Scheduler,
)
from bsseqconsensusreads_tpu_torch.serve.server import (  # noqa: F401
    ServeEngine,
    ServeServer,
    request,
)
