"""Multi-device execution: device meshes, family-axis sharding, the deep
route's template-axis split, the multi-process layer and the host pool.

The port of the JAX package's parallel/ package. The family axis shards
over the mesh's 'data' axis with no collective (each shard runs the stock
single-device kernels on its own device and stream); very deep families
split their template axis over 'reads', whose partial vote planes are
added in rank order on one device and finalized there.

The JAX package exports sharded_molecular_outwire under its older alias
sharded_molecular_packed as well; the port keeps the one name.
"""

from bsseqconsensusreads_tpu_torch.parallel.mesh import (  # noqa: F401
    default_mesh,
    make_mesh,
    pad_families,
)
from bsseqconsensusreads_tpu_torch.parallel.sharding import (  # noqa: F401
    sharded_duplex_pipeline,
    sharded_molecular_consensus,
    sharded_molecular_outwire,
)
from bsseqconsensusreads_tpu_torch.parallel.deep_family import (  # noqa: F401
    deep_family_consensus,
)
from bsseqconsensusreads_tpu_torch.parallel import multihost  # noqa: F401
from bsseqconsensusreads_tpu_torch.parallel.hostpool import (  # noqa: F401
    HostPool,
    host_workers,
)
