"""Device selection for the port's entry points.

Every entry point takes ``device=`` and defaults to ``"cuda"``.  There is
no silent CPU fallback: asking for the card where there is none raises,
and the CPU path runs only when the caller passes ``device="cpu"`` (as the
tests do).  On the CPU the kernels' plain PyTorch versions run; on the
card the hand-written kernels run.
"""

from __future__ import annotations

import torch


def on_cuda() -> bool:
    """Whether a CUDA card is visible (the counterpart of the JAX
    package's ``kernels.ops.on_tpu``)."""
    return torch.cuda.is_available()


def resolve_device(device="cuda") -> torch.device:
    """Normalize ``device`` to a :class:`torch.device`, raising when a
    CUDA device is asked for and no card is visible."""
    dev = torch.device(device)
    if dev.type == "cuda" and not on_cuda():
        raise RuntimeError(
            f"device={device!r} needs a CUDA card and none is visible; "
            "pass device='cpu' to run the plain PyTorch path")
    if dev.type not in ("cuda", "cpu"):
        raise ValueError(f"unsupported device {device!r}; use 'cuda' or 'cpu'")
    return dev
