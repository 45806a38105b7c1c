"""The device rule of the port, in one place.

``device=None`` means the CUDA card. There is no quiet carry-on on the
CPU: asking for the card where there is none raises. The CPU is used only
when the caller names it (the unit tests do).
"""

from __future__ import annotations

from typing import Dict, Optional, Union

import torch

__all__ = ["resolve_device", "device_fingerprint", "synchronize"]

DeviceLike = Optional[Union[str, torch.device]]


def resolve_device(device: DeviceLike = None) -> torch.device:
    """``None`` -> ``cuda`` (raises without a card); anything else is
    taken as given (``"cpu"``, ``"cuda:0"``, a ``torch.device``)."""
    dev = torch.device("cuda" if device is None else device)
    if dev.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError(
            "repro_torch runs on a CUDA device and none is available; "
            'pass device="cpu" explicitly to run on the CPU'
        )
    return dev


def device_fingerprint() -> Dict[str, str]:
    """Identity of the card measurements on this host are valid for."""
    resolve_device(None)
    return {
        "platform": "cuda",
        "device_kind": torch.cuda.get_device_name(0),
    }


def synchronize(device: torch.device) -> None:
    """Wait for the device's queued work (a no-op for the CPU) — what a
    host-clock latency sample must end in."""
    if device.type == "cuda":
        torch.cuda.synchronize(device)
