"""Parallelism: data-parallel training over torch.distributed and
time-sharded inference over a device mesh.

Counterpart of `fullycnnspeechenhancement_tpu/parallel/`.  Data parallelism
runs one process per rank with hand-written collectives (`dp.py`: sync BN,
global masks, summed gradients); `halo.py` shards a long spectrogram's
time axis over the devices of a `mesh.Mesh` with a 3-frame left and
4-frame right halo.
"""

from fullycnnspeechenhancement_torch.parallel.mesh import (  # noqa: F401
    DATA_AXIS,
    MODEL_AXIS,
    Mesh,
    make_mesh,
)
from fullycnnspeechenhancement_torch.parallel.dp import (  # noqa: F401
    DataParallel,
    replicate,
    shard_batch,
    shard_stacked_batch,
)
