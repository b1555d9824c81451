"""PyTorch and CUDA port of the intermittent-inference fleet simulator.

The JAX package ``repro`` is the reference; this package keeps its module
names and layout (``core/fleetsim``, ``kernels/charge_replay``,
``runtime/failures``, ...) so each module's counterpart is easy to find.
It imports ``torch`` and numpy, never ``jax`` and never ``repro``.

The main path is the fleet replay: ``core.fleetsim.build_plan`` flattens a
network under a strategy into a row table, and ``replay_plans`` /
``fleet_sweep`` replay it over many simulated devices, one lane per
device.  Stochastic replays run the hand-written CUDA lane kernel
``kernels.charge_replay`` on the card and its plain PyTorch version on
the CPU.
"""

from .device import on_cuda, resolve_device

__all__ = ["on_cuda", "resolve_device"]
