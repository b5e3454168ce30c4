"""graftswarm: elastic multi-process orchestration.

The port of the JAX package's elastic/ tier. Coordinator/worker sharded
runs over the serve tier's framed transport, with loss recovery (lease
expiry → checkpoint-prefix requeue) and a merge byte-identical to the
single-process pipeline. Each worker is a process of this package that
runs the port's run_pipeline on its slice, on the device the config's
`backend` names (the card by default; a worker that cannot reach it
fails). See coordinator.py for the ledger/durability design and
merge.py for the determinism proof.
"""

from bsseqconsensusreads_tpu_torch.elastic import fencing, merge
from bsseqconsensusreads_tpu_torch.elastic.coordinator import (
    ENV_CHUNK_B,
    DEFAULT_LEASE_S,
    ENV_COORDINATOR_ADDR,
    ENV_LEASE_S,
    ENV_WORKER_ID,
    Coordinator,
    ElasticError,
    SliceLedger,
    base_mi,
    config_doc,
    config_from_doc,
    lease_seconds,
    run_elastic,
    slice_name,
    split_input,
)
from bsseqconsensusreads_tpu_torch.elastic.fencing import EpochBook, FencedError
from bsseqconsensusreads_tpu_torch.elastic.worker import (
    process_slice,
    slice_config,
    work_loop,
)

__all__ = [
    "DEFAULT_LEASE_S",
    "ENV_CHUNK_B",
    "ENV_COORDINATOR_ADDR",
    "ENV_LEASE_S",
    "ENV_WORKER_ID",
    "Coordinator",
    "ElasticError",
    "EpochBook",
    "FencedError",
    "fencing",
    "SliceLedger",
    "base_mi",
    "config_doc",
    "config_from_doc",
    "lease_seconds",
    "merge",
    "process_slice",
    "run_elastic",
    "slice_config",
    "slice_name",
    "split_input",
    "work_loop",
]
