"""Device plane of the port: numpy weight builders (:mod:`.weights`), the
plain PyTorch heads (:mod:`.dct`) and the CUDA kernels (:mod:`.jpeg8`,
built by :mod:`._build` from ``imagekit_tpu_torch/csrc``)."""
