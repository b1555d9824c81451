"""Non-volatile memory abstraction (FRAM analogue).

An :class:`NVStore` holds named numpy arrays that survive power failures.
Individual word writes are atomic (as on FRAM) but *sequences* of writes are
not -- a power failure can leave a vector write torn, which is the consistency
hazard SONIC's idempotence mechanisms are built to survive.  The store charges
the device for every element moved, so energy accounting is automatic.

The JAX package's fleet-scale checkpoint store (``repro.checkpoint``, not
ported yet) implements the same interface against a directory with
atomic-rename commits.
"""

from __future__ import annotations

import numpy as np

from .energy import Device


class NVStore:
    """In-memory simulated FRAM."""

    def __init__(self, device: Device | None = None):
        self._data: dict[str, np.ndarray] = {}
        self.device = device

    # -- allocation --------------------------------------------------------
    def alloc(self, name: str, shape, dtype=np.float32, init=None) -> None:
        arr = np.zeros(shape, dtype=dtype) if init is None else np.array(init, dtype=dtype)
        self._data[name] = arr

    def free(self, name: str) -> None:
        self._data.pop(name, None)

    def __contains__(self, name: str) -> bool:
        return name in self._data

    def keys(self):
        return self._data.keys()

    # -- raw access (no energy accounting; used by the simulator itself) ---
    def raw(self, name: str) -> np.ndarray:
        return self._data[name]

    # -- device-accounted access -------------------------------------------
    def read(self, name: str, idx=slice(None)) -> np.ndarray:
        """Read (a slice of) an NV array, charging FRAM-read energy."""
        arr = self._data[name][idx]
        if self.device is not None:
            self.device.fram_read(np.size(arr))
        return np.array(arr)  # copy: reads land in volatile memory

    def write(self, name: str, value, idx=slice(None)) -> None:
        """Write (a slice of) an NV array, charging FRAM-write energy.

        If power fails mid-write, a *prefix* of the flattened destination is
        updated and the rest keeps its old contents -- a torn write.
        """
        value = np.asarray(value)
        target = self._data[name]

        def partial(frac: float) -> None:
            view = target[idx]
            flat_new = np.ravel(np.broadcast_to(value, view.shape))
            k = int(frac * flat_new.size)
            if k > 0:
                flat_view = view.reshape(-1)
                flat_view[:k] = flat_new[:k]
                target[idx] = view

        if self.device is not None:
            self.device.fram_write(max(np.size(target[idx]), np.size(value)),
                                   partial_cb=partial)
        target[idx] = value

    def write_scalar(self, name: str, value) -> None:
        """Atomic single-word NV write (loop cursors, buffer pointers)."""
        if self.device is not None:
            self.device.fram_write(1)
        self._data[name] = np.asarray(value)

    def read_scalar(self, name: str):
        if self.device is not None:
            self.device.fram_read(1)
        v = self._data[name]
        return v.item() if np.ndim(v) == 0 else v

    # -- snapshots (testing) -------------------------------------------------
    def snapshot(self) -> dict[str, np.ndarray]:
        return {k: v.copy() for k, v in self._data.items()}

    def restore(self, snap: dict[str, np.ndarray]) -> None:
        self._data = {k: v.copy() for k, v in snap.items()}
