"""Device resolution shared by every entry point of the port.

Entry points run on the card unless the caller asks for the CPU: a missing
``device`` means CUDA, and without a GPU that is an error, not a silent CPU
fallback (a CPU run would report CPU numbers under a GPU label).
"""

from __future__ import annotations

from typing import Union

import torch

DeviceLike = Union[str, torch.device, None]


def resolve_device(device: DeviceLike = None) -> torch.device:
    """``None`` -> ``cuda``; ``"cpu"`` -> cpu; anything else must be CUDA.

    Raises RuntimeError when CUDA is asked for (explicitly or by default)
    and no GPU is present, and ValueError for other device types.
    """
    dev = torch.device("cuda" if device is None else device)
    if dev.type == "cpu":
        return dev
    if dev.type != "cuda":
        raise ValueError(f"device must be cuda or cpu, got {dev}")
    if not torch.cuda.is_available():
        raise RuntimeError(
            "no CUDA device is available; pass device='cpu' to run the "
            "port on the CPU")
    return dev
