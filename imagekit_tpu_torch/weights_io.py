"""Carry the JAX package's numpy state into the port.

The reference builds its weight stacks and batch arrays as numpy on the
host; the port's heads take tensors. :func:`to_port` converts them with the
same dtype and layout, and without a copy on the CPU, so a test can feed
both packages exactly the same inputs.
"""

from __future__ import annotations

from typing import Any

import numpy as np
import torch


def to_port(np_stacks: Any, device: "str | torch.device" = "cpu") -> Any:
    """numpy array -> tensor on ``device``; tuples, lists and dicts are
    converted element by element and keep their structure."""
    if isinstance(np_stacks, np.ndarray):
        t = torch.from_numpy(np.ascontiguousarray(np_stacks))
        return t if torch.device(device).type == "cpu" else t.to(device)
    if isinstance(np_stacks, dict):
        return {k: to_port(v, device) for k, v in np_stacks.items()}
    if isinstance(np_stacks, (tuple, list)):
        return type(np_stacks)(to_port(v, device) for v in np_stacks)
    raise TypeError(f"cannot carry {type(np_stacks).__name__} into the port")
