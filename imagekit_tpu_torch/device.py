"""Explicit device selection for the port.

``"cuda"`` is the default everywhere and raises when no card is present;
the CPU, where the heads run their plain PyTorch versions, must be asked
for by name. Float32 matrix products are pinned to full fp32: TF32 keeps
a 10-bit mantissa, coarser than the reference's parity band allows.
"""

from __future__ import annotations

import torch


def resolve_device(name: "str | torch.device" = "cuda") -> torch.device:
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    dev = torch.device(name)
    if dev.type == "cuda":
        if not torch.cuda.is_available():
            raise RuntimeError(
                "device 'cuda' requested but torch.cuda.is_available() is "
                "False; pass device='cpu' to run the plain heads"
            )
        if dev.index is None:
            dev = torch.device("cuda", torch.cuda.current_device())
    elif dev.type != "cpu":
        raise ValueError(f"unsupported device {name!r}: use 'cuda' or 'cpu'")
    return dev
