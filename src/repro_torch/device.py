"""Device resolution for every entry point of the port.

The port runs on the card unless the caller names another device: a
missing ``device`` means ``"cuda"``, and asking for CUDA on a machine
without it raises instead of quietly running on the CPU. The CPU is a
device the caller chooses explicitly (the parity tests do).
"""
from __future__ import annotations

from typing import Optional, Union

import torch


def resolve_device(device: Optional[Union[str, torch.device]] = None
                   ) -> torch.device:
    dev = torch.device("cuda" if device is None else device)
    if dev.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError(
            "repro_torch runs on a CUDA device by default, and "
            "torch.cuda.is_available() is False here; pass device='cpu' "
            "to run the plain PyTorch versions on the CPU")
    if dev.type not in ("cuda", "cpu"):
        raise ValueError(f"unsupported device {dev}; expected cuda or cpu")
    return dev
