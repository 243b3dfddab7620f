"""Device selection for the package's entry points."""

from __future__ import annotations

from typing import Union

import torch

__all__ = ["resolve_device"]


def resolve_device(device: Union[str, torch.device] = "cuda") -> torch.device:
    """The entry points run on the card unless the caller asks for the
    CPU: a CUDA device without CUDA raises instead of running elsewhere."""
    dev = torch.device(device)
    if dev.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError(
            f"device {dev} requested but CUDA is not available; "
            "pass device='cpu' to run the plain versions on the CPU"
        )
    if dev.type not in ("cuda", "cpu"):
        raise ValueError(f"device {dev} is not served (cuda or cpu)")
    return dev
