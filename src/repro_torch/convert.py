"""Carry networks and plans across from the JAX package as plain numpy.

The two packages share no code, so a network or a plan built by the JAX
package reaches the port as numpy fields:

* a network as a list of layer dicts -- ``{"type": "Conv2D", "w": ...,
  "b": ..., "stride": 1, "relu": True, "name": "conv1"}`` and so on for
  ``MaxPool2D``, ``DenseFC`` and ``SparseFC`` (:func:`numpy_layers` reads
  that form off any simulator network);
* a plan as the dict of its :class:`~repro_torch.core.fleetsim.FleetPlan`
  fields (:func:`plan_fields`).

:func:`simnet_from_numpy` and :func:`plan_from_numpy` rebuild the port's
objects from them, copying every array, so both packages replay the same
plan.
"""

from __future__ import annotations

import dataclasses

import numpy as np

from .core.fleetsim import FleetPlan
from .core.inference import Conv2D, DenseFC, MaxPool2D, SimNet, SparseFC

_LAYERS = {cls.__name__: cls for cls in (Conv2D, MaxPool2D, DenseFC,
                                         SparseFC)}


def _copy(v):
    return np.array(v, copy=True) if isinstance(v, np.ndarray) else v


def numpy_layers(net) -> list[dict]:
    """The layer dicts of a simulator network (of either package)."""
    out = []
    for layer in net.layers:
        d = {"type": type(layer).__name__}
        for f in dataclasses.fields(layer):
            if f.init and not f.name.startswith("_"):
                d[f.name] = _copy(getattr(layer, f.name))
        out.append(d)
    return out


def simnet_from_numpy(layers: list[dict], input_shape,
                      name: str = "net") -> SimNet:
    """Rebuild a port :class:`SimNet` from layer dicts of numpy weights."""
    built = []
    for d in layers:
        d = dict(d)
        kind = d.pop("type")
        if kind not in _LAYERS:
            raise ValueError(f"unknown layer type {kind!r}; expected one of "
                             f"{sorted(_LAYERS)}")
        built.append(_LAYERS[kind](**{k: _copy(v) for k, v in d.items()}))
    return SimNet(built, input_shape=tuple(input_shape), name=name)


def plan_fields(plan) -> dict:
    """The numpy fields of a fleet plan (of either package)."""
    return {f.name: _copy(getattr(plan, f.name))
            for f in dataclasses.fields(plan)}


def plan_from_numpy(fields: dict) -> FleetPlan:
    """Rebuild a port :class:`FleetPlan` from the fields of a JAX-package
    ``FleetPlan``."""
    names = {f.name for f in dataclasses.fields(FleetPlan)}
    unknown = set(fields) - names
    if unknown:
        raise ValueError(f"unknown FleetPlan fields {sorted(unknown)}")
    return FleetPlan(**{k: _copy(v) for k, v in fields.items()})
