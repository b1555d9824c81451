"""What every ctypes-bound kernel wrapper checks before and after a launch."""

from __future__ import annotations

import torch


def check_input(name: str, t, device: torch.device, dtypes, ndim: int):
    """Raise unless ``t`` is a contiguous ``ndim``-dim tensor on ``device``
    whose dtype is one of ``dtypes``."""
    if not torch.is_tensor(t):
        raise TypeError(f"{name} must be a tensor, got {type(t).__name__}")
    if t.device != device:
        raise ValueError(f"{name} is on {t.device}, expected {device}")
    if t.dtype not in dtypes:
        raise TypeError(f"{name} must be one of {list(dtypes)}, got "
                        f"{t.dtype}")
    if t.dim() != ndim:
        raise ValueError(f"{name} must have {ndim} dims, got "
                         f"{tuple(t.shape)}")
    if not t.is_contiguous():
        raise ValueError(f"{name} must be contiguous")


def stream(device: torch.device) -> int:
    """The current CUDA stream of ``device`` as a pointer for ctypes.

    Read through torch's raw accessor (the one its generated kernels
    use): ``torch.cuda.current_stream`` builds a Stream object first,
    several microseconds of host time a launch."""
    return torch._C._cuda_getCurrentRawStream(device.index)


def check_status(err: int, kernel: str) -> None:
    """Raise if a launcher returned a CUDA error."""
    if err != 0:
        raise RuntimeError(f"{kernel} kernel launch failed: CUDA error {err}")
