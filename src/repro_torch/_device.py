"""The device rule of the port, in one place.

``device=None`` means the CUDA card. There is no quiet carry-on on the
CPU: asking for the card where there is none raises. The CPU is used only
when the caller names it (the unit tests do).
"""

from __future__ import annotations

import platform
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


def device_fingerprint(device: DeviceLike = None) -> Dict[str, str]:
    """Identity of the device a measurement on this host is valid for:
    ``{"platform": "cuda", "device_kind": <the card's name>}`` for a CUDA
    device (``None``: the card, an error without one), and
    ``{"platform": "cpu", "device_kind": "<machine> (torch)"}`` for the
    CPU. Autotune entries are stamped with it. The CPU's kind names this
    package, so that a table the JAX package measured on the same host
    (kind ``"cpu"``) never passes for one of this package's."""
    dev = resolve_device(device)
    if dev.type == "cuda":
        return {
            "platform": "cuda",
            "device_kind": torch.cuda.get_device_name(dev),
        }
    return {
        "platform": dev.type,
        "device_kind": f"{platform.machine() or 'unknown'} (torch)",
    }


def synchronize(device: torch.device) -> None:
    """Wait for the work the calling thread queued on ``device``: its
    current stream, not the whole device (a no-op for the CPU). This is
    what a host-clock latency sample must end in. Stream-local on purpose:
    the async front executes a batch on a side stream while the next one
    is planned on the default stream, and a device-wide wait would bill
    that planning to every sample. On the synchronous path the current
    stream is the default one, which holds all of the path's work."""
    if device.type == "cuda":
        torch.cuda.current_stream(device).synchronize()
