"""Images beyond the bucket ladder (counterpart of
``imagekit_tpu/parallel/``).

The reference resizes them at their exact shape, sharding the height over
a device mesh where it has more than one device. The port drives one card
and has no mesh: :func:`~.tiling.resize_oversized` is the reference's
one-device branch.
"""

from imagekit_tpu_torch.parallel.tiling import resize_oversized  # noqa: F401
