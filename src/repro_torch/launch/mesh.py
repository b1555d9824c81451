"""The fleet replay's device mesh (the fleet half of the JAX package's
``launch/mesh.py``).

One process drives every shard, as the JAX package's single-controller
mesh does: a :class:`FleetMesh` is a tuple of ``torch.device``s along the
one axis ``"devices"``, the fleet sweeps split their lanes into equal
contiguous blocks, one a shard, issue every shard's launches, and then
gather the outputs or all-reduce the shards' statistics partials
(:func:`fleet_all_reduce`).  No process group is involved.
"""

from __future__ import annotations

from dataclasses import dataclass

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


def mesh_chips(mesh: FleetMesh) -> int:
    return len(mesh.devices)
