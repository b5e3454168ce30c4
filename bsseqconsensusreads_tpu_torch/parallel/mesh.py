"""Device meshes and batch padding helpers.

The port of the JAX package's parallel/mesh.py. The port's mesh is single
controller, like JAX's shard_map: a (data, reads) grid of torch devices
in one process, each grid slot with its own CUDA stream, on which the
sharded routes (parallel.sharding, parallel.deep_family) launch the stock
single-device kernels and from which their outputs are gathered
family-major. The multi-process scale-out (parallel.multihost) builds a
mesh whose data rows carry the process that owns them; a process runs
only its own rows.

An explicit device list may name one device more than once:
make_mesh(4, devices=['cpu'] * 8) is the counterpart of the 8 virtual
CPU devices the JAX package's tests run on, and
make_mesh(2, devices=['cuda:0'] * 2) drives the sharded code on one card
(two slots, two streams). The callers' mesh='auto' never builds such a
mesh (pipeline.calling._resolve_mesh).
"""

from __future__ import annotations

import contextlib
import threading

import numpy as np
import torch

#: Mesh axis names: 'data' shards the MI-family axis (embarrassingly
#: parallel); 'reads' shards the template axis of deep families.
DATA_AXIS = "data"
READS_AXIS = "reads"


def process_index() -> int:
    """This process's rank in the torch.distributed job (0 outside one)."""
    import torch.distributed as dist

    return dist.get_rank() if dist.is_available() and dist.is_initialized() else 0


class Mesh:
    """A (data, reads) grid of torch devices.

    devices: object array [n_data, n_reads] of torch.device; processes:
    int array of the same shape, the rank owning each slot (by default
    this process: a mesh of its own devices). Slot (d, r) launches on its
    own stream (stream(d, r)), created on first use; on the CPU there is
    none and the slots just run in turn."""

    def __init__(self, devices, processes=None):
        grid = np.empty(np.shape(devices), dtype=object)
        for idx in np.ndindex(grid.shape):
            grid[idx] = torch.device(np.asarray(devices, dtype=object)[idx])
        if grid.ndim != 2 or grid.size == 0:
            raise ValueError(f"a mesh is a non-empty (data, reads) grid, got shape {grid.shape}")
        self.devices = grid
        self.processes = (np.full(grid.shape, process_index(), np.int64) if processes is None
                          else np.asarray(processes, np.int64).reshape(grid.shape))
        self._streams: dict = {}
        self._lock = threading.Lock()

    @property
    def shape(self) -> dict:
        return {DATA_AXIS: self.devices.shape[0], READS_AXIS: self.devices.shape[1]}

    def __repr__(self) -> str:
        return (f"Mesh({self.shape}, devices={[str(d) for d in self.devices.flat]}, "
                f"processes={self.processes.reshape(-1).tolist()})")

    def local_data(self) -> list[int]:
        """The data rows this process owns (every row in one process)."""
        me = process_index()
        return [d for d in range(self.devices.shape[0]) if self.processes[d, 0] == me]

    def local_slots(self) -> list[tuple[int, int]]:
        """(d, r) of every slot of this process's data rows."""
        return [(d, r) for d in self.local_data() for r in range(self.devices.shape[1])]

    def device(self, d: int, r: int = 0) -> torch.device:
        return self.devices[d, r]

    @property
    def first_device(self) -> torch.device:
        """Where gathered outputs land: the first slot this process owns."""
        return self.devices[self.local_data()[0], 0]

    def stream(self, d: int, r: int = 0):
        """Slot (d, r)'s CUDA stream (None for a CPU slot)."""
        dev = self.devices[d, r]
        if dev.type != "cuda":
            return None
        with self._lock:
            s = self._streams.get((d, r))
            if s is None:
                s = self._streams[(d, r)] = torch.cuda.Stream(device=dev)
        return s

    @contextlib.contextmanager
    def on(self, d: int, r: int = 0):
        """Run the block on slot (d, r): its device and stream current, its
        kernels' launches also counted under the tag 'd,r'
        (ops.cuda_vote.TAGGED_LAUNCHES). The slot's stream first waits
        for the calling thread's current stream on that device, so what
        the caller enqueued before (inputs, cached tables) is ready.
        Yields the stream (None on the CPU)."""
        from bsseqconsensusreads_tpu_torch.ops import cuda_vote

        s = self.stream(d, r)
        with cuda_vote.launch_tag(f"{d},{r}"):
            if s is None:
                yield None
                return
            dev = self.devices[d, r]
            s.wait_stream(torch.cuda.current_stream(dev))
            with torch.cuda.device(dev), torch.cuda.stream(s):
                yield s


def make_mesh(n_data: int | None = None, n_reads: int = 1, devices=None) -> Mesh:
    """A (data, reads) mesh over the given devices (default: every visible
    CUDA device). n_data defaults to len(devices) // n_reads; too few
    devices raise, never a smaller mesh."""
    if devices is None:
        devices = [torch.device("cuda", i) for i in range(torch.cuda.device_count())]
    devices = [torch.device(d) for d in devices]
    if n_data is None:
        n_data = len(devices) // n_reads
    need = n_data * n_reads
    if need > len(devices) or need < 1:
        raise ValueError(
            f"mesh ({n_data} x {n_reads}) needs {max(need, 1)} devices, "
            f"have {len(devices)}"
        )
    grid = np.empty((n_data, n_reads), dtype=object)
    for i, dev in enumerate(devices[:need]):
        grid[i // n_reads, i % n_reads] = dev
    return Mesh(grid)


def default_mesh() -> Mesh:
    """All visible CUDA devices on the data axis — families are
    independent, so the whole family axis shards."""
    return make_mesh()


def pad_families(arrays: dict | tuple, n_families: int, multiple: int):
    """Pad the leading family axis of every array to a multiple of the mesh's
    data-axis size (each data shard takes an equal share). Pad rows are
    empty families (int8 bases at the N sentinel, zeros / False
    elsewhere). Returns (padded_arrays, padded_n); callers slice outputs
    back to n_families."""
    pad_to = ((n_families + multiple - 1) // multiple) * multiple
    extra = pad_to - n_families

    def pad(a):
        if extra == 0:
            return a
        widths = [(0, extra)] + [(0, 0)] * (a.ndim - 1)
        fill = 4 if a.dtype == np.int8 else (False if a.dtype == bool else 0)
        return np.pad(a, widths, constant_values=fill)

    if isinstance(arrays, dict):
        return {k: pad(v) for k, v in arrays.items()}, pad_to
    return tuple(pad(a) for a in arrays), pad_to
