"""Multi-process execution: the family axis across processes.

The port of the JAX package's parallel/multihost.py, on torch.distributed.
Each process ingests its own slice of the input (files are the pipeline's
durable inter-stage boundary, so per-process BAM shards come for free)
and votes its own family rows on its own devices: the consensus kernels
hold no cross-family operator (parallel.sharding), so NOTHING crosses
processes per batch. The process group is joined once (init_distributed:
gloo on the CPU, nccl on the card); the only traffic is the one exchange
of device counts that builds the global mesh (multihost_family_mesh).

One process degenerates cleanly: every helper is then the one-process
mesh's.
"""

from __future__ import annotations

import os
import threading
import time

import numpy as np
import torch

from bsseqconsensusreads_tpu_torch.faults import failpoints as _failpoints
from bsseqconsensusreads_tpu_torch.parallel.mesh import DATA_AXIS, Mesh, process_index
from bsseqconsensusreads_tpu_torch.utils import observe


def process_count() -> int:
    import torch.distributed as dist

    return dist.get_world_size() if dist.is_available() and dist.is_initialized() else 1


class WorkerHeartbeat:
    """Per-process liveness for multi-process runs: 'worker_heartbeat'
    events (observe.event) carrying (process_index, process_count, seq,
    phase).

    beat() is called at the synchronization points (distributed init,
    per-batch assembly); start() adds a daemon thread beating every
    BSSEQ_TPU_HEARTBEAT_S seconds (default 30), so a process wedged
    outside the batch loop keeps announcing itself."""

    def __init__(self, component: str = "multihost"):
        self.component = component
        self._seq = 0
        self._lock = threading.Lock()
        self._stop = threading.Event()
        self._thread: threading.Thread | None = None

    def beat(self, phase: str = "alive", **extra) -> None:
        with self._lock:
            self._seq += 1
            seq = self._seq
        if _failpoints.ARMED:
            try:
                _failpoints.fire("multihost_heartbeat", phase=phase)
            except Exception:  # an injected heartbeat LOSS: the beat never
                # lands (the firing itself was reported) — what a wedged
                # or partitioned process looks like from outside
                return
        observe.event("worker_heartbeat", {
            "component": self.component,
            "process_index": process_index(),
            "process_count": process_count(),
            "seq": seq,
            "phase": phase,
            **extra,
        })

    def start(self, interval_s: float | None = None) -> None:
        if self._thread is not None:
            return
        if interval_s is None:
            try:
                interval_s = float(os.environ.get("BSSEQ_TPU_HEARTBEAT_S", 30))
            except ValueError:
                interval_s = 30.0

        def heartbeat_loop() -> None:
            while not self._stop.wait(interval_s):
                self.beat("alive")

        # graftlint: disable=thread-unsafe-mutation -- armed pre-start on the caller's
        # thread; the beat loop only reads self._stop (an Event)
        self._thread = threading.Thread(target=heartbeat_loop, name="bsseq-heartbeat",
                                        daemon=True)
        self._thread.start()

    def stop(self) -> None:
        self._stop.set()
        if self._thread is not None:
            self._thread.join(timeout=5)
            # graftlint: disable=thread-unsafe-mutation -- after join: the beat loop has
            # exited
            self._thread = None
        # graftlint: disable=thread-unsafe-mutation -- after join: the beat loop has
        # exited
        self._stop = threading.Event()


#: The heartbeat the multihost helpers beat through; a job wanting the
#: periodic announcer calls heartbeat().start() after init_distributed.
_HEARTBEAT = WorkerHeartbeat()


def heartbeat() -> WorkerHeartbeat:
    """This process's multihost heartbeat."""
    return _HEARTBEAT


def init_distributed(
    coordinator_address: str | None = None,
    num_processes: int | None = None,
    process_id: int | None = None,
    backend: str | None = None,
) -> None:
    """Join the multi-process job (torch.distributed.init_process_group).

    coordinator_address 'host:port' (tcp://host:port), num_processes and
    process_id are given explicitly, or left None for torch's environment
    variables (MASTER_ADDR, MASTER_PORT, WORLD_SIZE, RANK). backend: 'nccl'
    when a card is visible, else 'gloo'; nothing here sends per-batch
    traffic, so 'gloo' serves the rendezvous on a card too. A no-op when
    num_processes is 1."""
    import torch.distributed as dist

    if num_processes == 1:
        return
    if backend is None:
        backend = "nccl" if torch.cuda.is_available() else "gloo"
    kw = {}
    if coordinator_address is not None:
        addr = coordinator_address
        kw["init_method"] = addr if "://" in addr else f"tcp://{addr}"
    else:
        kw["init_method"] = "env://"
    if num_processes is not None:
        kw["world_size"] = num_processes
    if process_id is not None:
        kw["rank"] = process_id
    dist.init_process_group(backend=backend, **kw)
    _HEARTBEAT.beat("distributed_init", backend=backend)


def multihost_family_mesh(devices=None) -> Mesh:
    """Every process's devices on the family axis, process-major: rank 0's
    rows first. `devices` are this process's (default its visible CUDA
    devices, else the CPU); the device counts are exchanged once
    (all_gather_object), so each process knows which data rows are its
    own. A process's family rows land only on its own devices."""
    import torch.distributed as dist

    if devices is None:
        n = torch.cuda.device_count()
        devices = [f"cuda:{i}" for i in range(n)] if n else ["cpu"]
    local = [str(torch.device(d)) for d in devices]
    everyone = [local]
    if dist.is_available() and dist.is_initialized():
        everyone = [None] * dist.get_world_size()
        dist.all_gather_object(everyone, local)
    me = process_index()
    grid, procs = [], []
    for rank, devs in enumerate(everyone):
        for d in devs:
            # another process's device is only a placeholder here
            grid.append(d if rank == me else "meta")
            procs.append(rank)
    return Mesh(np.array(grid, dtype=object).reshape(-1, 1),
                np.array(procs, np.int64).reshape(-1, 1))


def local_family_count(n_global_families: int, mesh: Mesh) -> tuple[int, int]:
    """(this process's family count, its first global row) under an even
    split of n_global_families over the mesh's data axis. n_global_families
    must divide evenly by the data size (pad first: parallel.mesh
    .pad_families)."""
    data_size = mesh.shape[DATA_AXIS]
    if n_global_families % data_size:
        raise ValueError(
            f"{n_global_families} families do not split evenly over "
            f"{data_size} devices; pad first (parallel.mesh.pad_families)"
        )
    per_dev = n_global_families // data_size
    local = mesh.local_data()
    return per_dev * len(local), per_dev * min(local)


def global_family_batch(local_arrays, n_global_families: int, mesh: Mesh):
    """This process's family rows of a global batch, checked against the
    mesh: local_arrays' leading axes must be local_family_count's share.
    Nothing moves between processes: the sharded routes take these rows
    and split them over this process's data shards. Returns the arrays as
    a tuple (the JAX package returns global arrays built from each
    process's rows)."""
    # the per-batch synchronization point: a stall here simulates a
    # cross-process timeout, a raise a dead coordinator
    _failpoints.fire("multihost_collective", families=n_global_families)
    n_local, _first = local_family_count(n_global_families, mesh)
    t0 = time.monotonic()
    out = []
    for a in local_arrays:
        if a.shape[0] != n_local:
            raise ValueError(f"expected {n_local} local family rows, got {a.shape[0]}")
        out.append(a)
    _HEARTBEAT.beat(
        "batch_assembled", families=n_global_families,
        assemble_s=round(time.monotonic() - t0, 4),
    )
    return tuple(out)


def local_rows(output, n_local: int) -> np.ndarray:
    """This process's rows of a sharded route's output (a tensor gathered
    family-major over its own data shards) on the host, in global row
    order."""
    got = output.cpu().numpy() if isinstance(output, torch.Tensor) else np.asarray(output)
    if got.shape[0] != n_local:
        raise ValueError(f"expected {n_local} local rows, found {got.shape[0]}")
    return got
