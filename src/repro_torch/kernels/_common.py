"""Helpers the kernel wrappers share: argument checks, the launch-error
check, and the XOR reduction torch does not have."""

from __future__ import annotations

import torch

__all__ = ["xor_reduce", "require", "stream_ptr", "check_launch",
           "kernel_device"]

# where a wrapper runs: its plain version, its kernel, or (for the wrappers
# whose output shape does not depend on the data) the kernel's shape alone
_DEVICE_TYPES = ("cpu", "cuda")


def kernel_device(t: torch.Tensor, name: str, meta: bool = False) -> str:
    """``t``'s device type as a wrapper dispatches on it: ``"cpu"`` (the
    plain version), ``"cuda"`` (the kernel) or, where ``meta`` says the
    wrapper answers by shape, ``"meta"``. Any other device raises: it
    would otherwise reach a build and a launch on a null pointer."""
    kind = t.device.type
    if kind in _DEVICE_TYPES or (meta and kind == "meta"):
        return kind
    raise ValueError(f"{name} runs on the CPU (its plain version) or on a "
                     f"CUDA device (its kernel), not on {t.device}")


def xor_reduce(x: torch.Tensor, dim: int) -> torch.Tensor:
    """XOR-fold ``x`` along ``dim`` (a halving tree: torch has no bitwise
    XOR reduction). An empty axis folds to zeros."""
    x = x.movedim(dim, 0)
    if x.shape[0] == 0:
        return x.new_zeros(x.shape[1:])
    while x.shape[0] > 1:
        half = x.shape[0] // 2
        folded = x[:half] ^ x[half : 2 * half]
        if x.shape[0] % 2:
            folded = torch.cat([folded, x[2 * half :]], dim=0)
        x = folded
    return x[0]


def require(
    t: torch.Tensor, name: str, dtype: torch.dtype, ndim: int,
    device: torch.device,
) -> None:
    """Raise on anything the CUDA kernels do not take."""
    if t.device != device:
        raise ValueError(f"{name} is on {t.device}, expected {device}")
    if t.dtype != dtype:
        raise TypeError(f"{name} must be {dtype}, got {t.dtype}")
    if t.dim() != ndim:
        raise ValueError(f"{name} must be {ndim}-d, got shape {tuple(t.shape)}")
    if not t.is_contiguous():
        raise ValueError(f"{name} must be contiguous")
    if any(s >= 2**31 for s in t.shape):
        raise ValueError(f"{name} has an axis beyond the kernels' int range")


def stream_ptr(device: torch.device) -> int:
    return torch.cuda.current_stream(device).cuda_stream


def check_launch(code: int, kernel: str) -> None:
    if code != 0:
        raise RuntimeError(
            f"CUDA kernel {kernel} failed to launch (cudaError {code})"
        )
