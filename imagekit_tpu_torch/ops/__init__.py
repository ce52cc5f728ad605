"""Device plane of the port: numpy weight builders (:mod:`.weights`), the
heads (:mod:`.dct`, :mod:`.color`) and the CUDA kernels with their plain
PyTorch versions (:mod:`.jpeg8` for K1, :mod:`.resize_strip` for K2,
:mod:`.resize_planes` for K3 and K4, :mod:`.jpeg_pixels` for K6, built
by :mod:`._build` from ``imagekit_tpu_torch/csrc``)."""
