"""Device resolution for the PyTorch port (counterpart of the JAX package's
platform selection in `deep_gcns_torch_tpu/__init__.py`).

Entry points run on the card unless the caller asks for the CPU. Asking for
CUDA on a machine without a card raises: nothing falls back quietly.
"""

from __future__ import annotations

from typing import Union

import torch

DeviceLike = Union[str, torch.device]


def resolve_device(device: DeviceLike = "cuda") -> torch.device:
    """Return the torch device to run on: ``cuda`` by default, ``cpu`` on
    request; raise for a CUDA request without a card or any other type."""
    dev = torch.device(device)
    if dev.type == "cuda":
        if not torch.cuda.is_available():
            raise RuntimeError(
                "device 'cuda' requested but torch.cuda.is_available() is False; "
                "pass device='cpu' to run the plain PyTorch path")
        return dev
    if dev.type == "cpu":
        return dev
    raise ValueError(f"unsupported device {device!r} (expected 'cuda' or 'cpu')")
