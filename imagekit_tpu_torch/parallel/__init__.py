"""Several devices (counterpart of ``imagekit_tpu/parallel/``).

The reference expresses its two scale axes with ``jax.sharding`` over a
device mesh; the port holds the same ``(data, space)`` grid of devices
explicitly (:func:`~.mesh.make_mesh`) and launches once per device:

- **data**: a batch splits over the grid's devices, one launch of the
  head's kernel each (:func:`~.sharding.sharded_resample`, and the
  engine's batches: ``serving/batcher.py``);
- **space**: an oversized image's height splits over the ``space``
  columns, each shard resizes its rows to f32 partials, and the partials
  are summed on the first device (:func:`~.tiling.resize_oversized`).
"""

from imagekit_tpu_torch.parallel.mesh import get_mesh, make_mesh  # noqa: F401
from imagekit_tpu_torch.parallel.sharding import (  # noqa: F401
    shard_batch,
    sharded_resample,
)
from imagekit_tpu_torch.parallel.tiling import resize_oversized  # noqa: F401
