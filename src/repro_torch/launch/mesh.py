"""Device meshes: the fleet replay's (``FleetMesh``, the fleet half of the
JAX package's ``launch/mesh.py``) and the LM's (``LMMesh``, its LM half).

One process drives every shard, as the JAX package's single-controller
mesh does; no ``torch.distributed`` process group is involved.  A
:class:`FleetMesh` is a tuple of ``torch.device``s along the one axis
``"devices"``: the fleet sweeps split their lanes into equal contiguous
blocks, one a shard, issue every shard's launches, and then gather the
outputs or all-reduce the shards' statistics partials
(:func:`fleet_all_reduce`).  An :class:`LMMesh` names its axes
(``("data", "model")`` or ``("pod", "data", "model")``) and holds a numpy
object array of ``torch.device``s in its shape, or no devices at all for
the abstract production meshes that only the dry run reads;
``launch.shardings`` places an LM's parameters and optimizer state on it
and ``launch.train`` steps them.

The JAX module's ``axis_type_kwargs`` and ``compat_shard_map`` are shims
over JAX versions and have no counterpart here.
"""

from __future__ import annotations

import math
from dataclasses import dataclass

import numpy as np
import torch

from ..device import resolve_device


@dataclass(frozen=True)
class FleetMesh:
    """A 1-D mesh of the devices the fleet's lanes are split across."""
    devices: tuple
    axis_names: tuple = ("devices",)


def make_fleet_mesh(n_shards: int | None = None,
                    device="cuda") -> FleetMesh:
    """1-D mesh over the host's cards for sharding the fleet replay's
    device axis: fleets past one card's memory split their lanes across
    the mesh.  Defaults to every visible card
    (``torch.cuda.device_count()``); on a host with one card this is a
    ``(1,)`` mesh, which runs the same sharded code.  ``n_shards`` may not
    exceed the cards there are.  ``device="cpu"`` gives ``n_shards``
    (default 1) shards on the CPU, the twin of JAX's forced host device
    count."""
    dev = resolve_device(device)
    count = 1 if dev.type == "cpu" else torch.cuda.device_count()
    n = count if n_shards is None else int(n_shards)
    if n < 1:
        raise ValueError(f"a mesh needs at least one shard, got {n}")
    if dev.type == "cpu":
        return FleetMesh((dev,) * n)
    if n > count:
        raise ValueError(f"a mesh of {n} shards needs {n} cards; "
                         f"{count} are visible")
    return FleetMesh(tuple(torch.device("cuda", i) for i in range(n)))


def fleet_all_reduce(parts) -> tuple:
    """All-reduce the shards' fleet-statistics partials, each the
    ``(sums, mins, maxs)`` triple of
    ``repro_torch.core.fleetstats.reduce_lane_outputs``: sums and counts
    added in shard order on the first shard's device, the extremes by
    elementwise min and max.  One shard's triple comes back as it is."""
    parts = list(parts)
    if not parts:
        raise ValueError("fleet_all_reduce needs at least one shard")
    sums, mins, maxs = parts[0]
    dev = next(iter(sums.values())).device
    sums, mins, maxs = dict(sums), dict(mins), dict(maxs)
    for ps, pn, px in parts[1:]:
        for k in sums:
            sums[k] = sums[k] + ps[k].to(dev)
        for k in mins:
            mins[k] = torch.minimum(mins[k], pn[k].to(dev))
        for k in maxs:
            maxs[k] = torch.maximum(maxs[k], px[k].to(dev))
    return sums, mins, maxs


@dataclass(frozen=True, eq=False)
class LMMesh:
    """A named mesh for the LM: ``shape`` maps each axis to its size in
    axis order (as ``jax.sharding.Mesh.shape`` does, so the sharding rules
    read it unchanged); ``devices`` is a numpy object array of
    ``torch.device`` in the mesh's shape, or None for an abstract mesh."""
    axis_names: tuple
    shape: dict
    devices: np.ndarray | None = None

    def __repr__(self) -> str:
        where = "abstract" if self.devices is None else \
            ",".join(sorted({str(d) for d in self.devices.flat}))
        return (f"LMMesh({'x'.join(str(s) for s in self.shape.values())} "
                f"{self.axis_names}, {where})")


def compat_make_mesh(shape, axes, device="cuda") -> LMMesh:
    """A mesh of ``shape`` over ``axes`` on real devices, the counterpart
    of ``jax.make_mesh``: on ``"cuda"`` the first ``prod(shape)`` visible
    cards in row-major order (more than there are raises); on ``"cpu"``
    that many CPU shards, the twin of JAX's forced host devices."""
    shape, axes = tuple(int(s) for s in shape), tuple(axes)
    if len(shape) != len(axes) or len(set(axes)) != len(axes):
        raise ValueError(f"mesh shape {shape} and axes {axes} must pair "
                         f"one distinct name with each size")
    if min(shape, default=0) < 1:
        raise ValueError(f"every mesh axis needs at least one shard: {shape}")
    n = math.prod(shape)
    dev = resolve_device(device)
    if dev.type == "cpu":
        flat = [dev] * n
    else:
        count = torch.cuda.device_count()
        if n > count:
            raise ValueError(f"a {'x'.join(map(str, shape))} mesh needs {n} "
                             f"cards; {count} are visible")
        flat = [torch.device("cuda", i) for i in range(n)]
    devices = np.empty(n, dtype=object)
    devices[:] = flat
    return LMMesh(axes, dict(zip(axes, shape)), devices.reshape(shape))


def make_production_mesh(*, multi_pod: bool = False) -> LMMesh:
    """Single pod: 16x16 = 256 chips (data, model).  Multi-pod: 2x16x16 =
    512 chips (pod, data, model); the pod axis carries pure data
    parallelism.  Abstract: it has no devices, since one controller does
    not hold 256 cards; the dry run reads its shape only."""
    shape = (2, 16, 16) if multi_pod else (16, 16)
    axes = ("pod", "data", "model") if multi_pod else ("data", "model")
    return LMMesh(axes, dict(zip(axes, shape)), None)


def make_host_mesh(shape=(1, 1), axes=("data", "model"),
                   device="cuda") -> LMMesh:
    """Small mesh over the host's devices (the sharded trainer, the
    tests): on ``"cuda"`` it needs ``prod(shape)`` visible cards and raises
    otherwise; on ``"cpu"`` it gives CPU shards of any shape."""
    return compat_make_mesh(shape, axes, device)


def dp_axes(mesh) -> tuple:
    """The data-parallel axes of a mesh (pod folds into DP)."""
    return tuple(a for a in mesh.axis_names if a in ("pod", "data"))


def mesh_chips(mesh) -> int:
    """The shards of a mesh: a :class:`FleetMesh`'s devices, or the product
    of an :class:`LMMesh`'s axis sizes (abstract or not)."""
    if isinstance(mesh, LMMesh):
        return math.prod(mesh.shape.values())
    return len(mesh.devices)
