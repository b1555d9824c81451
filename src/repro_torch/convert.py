"""Carry networks and plans across from the JAX package as plain numpy.

The two packages share no code, so a network or a plan built by the JAX
package reaches the port as numpy fields:

* a network as a list of layer dicts -- ``{"type": "Conv2D", "w": ...,
  "b": ..., "stride": 1, "relu": True, "name": "conv1"}`` and so on for
  ``MaxPool2D``, ``DenseFC`` and ``SparseFC`` (:func:`numpy_layers` reads
  that form off any simulator network);
* a plan as the dict of its :class:`~repro_torch.core.fleetsim.FleetPlan`
  fields (:func:`plan_fields`);
* a block-sparse FC layer as its block-CSR bundle and sizes
  (:func:`block_sparse_fc_fields`);
* a model config as the dict of its fields (``dataclasses.asdict``), and
  an LM's parameters as the JAX tree with numpy leaves.

:func:`simnet_from_numpy` and :func:`plan_from_numpy` rebuild the port's
objects from them, copying every array, so both packages replay the same
plan; :func:`block_sparse_fc_from_numpy` rebuilds a
:class:`~repro_torch.kernels.ops.BlockSparseFC` on the same bundle;
:func:`model_config_from_fields` and :func:`lm_params_from_numpy` rebuild
a config and copy an LM's weights onto a device.
"""

from __future__ import annotations

import dataclasses

import numpy as np
import torch

from .core.fleetsim import FleetPlan
from .core.inference import Conv2D, DenseFC, MaxPool2D, SimNet, SparseFC
from .kernels.ops import BlockSparseFC
from .models import transformer
from .models.api import param_shapes
from .models.config import ModelConfig
from .models.layers import dt

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


#: The arrays and the sizes that define a block-sparse FC layer.
_BSFC_ARRAYS = ("vals", "row_ptr", "col_idx")
_BSFC_SIZES = ("m", "k", "bm", "bk", "bn")
_BSFC_FIELDS = _BSFC_ARRAYS + _BSFC_SIZES


def block_sparse_fc_fields(fc) -> dict:
    """The numpy bundle and sizes of a ``BlockSparseFC`` (of either
    package): ``vals``, ``row_ptr``, ``col_idx``, ``m``, ``k``, ``bm``,
    ``bk`` and ``bn``.  ``vals`` keeps its dtype: a bf16 layer of the JAX
    package gives its ``ml_dtypes`` bf16 array, which the port reads by
    its 16-bit words."""
    out = {n: np.array(getattr(fc, n), copy=True) for n in _BSFC_ARRAYS}
    out.update({n: int(getattr(fc, n)) for n in _BSFC_SIZES})
    return out


def block_sparse_fc_from_numpy(fields: dict,
                               device="cuda") -> BlockSparseFC:
    """Rebuild a port :class:`BlockSparseFC` on the bundle of
    :func:`block_sparse_fc_fields`, placed on ``device`` in the values'
    own dtype (f32, or bf16 with the same 16-bit words)."""
    if set(fields) != set(_BSFC_FIELDS):
        raise ValueError(f"expected the fields {sorted(_BSFC_FIELDS)}, got "
                         f"{sorted(fields)}")
    return BlockSparseFC.from_block_csr(**fields, device=device)


def model_config_from_fields(fields: dict) -> ModelConfig:
    """A port :class:`ModelConfig` from the fields of a JAX-package config
    (``dataclasses.asdict(cfg)``)."""
    names = {f.name for f in dataclasses.fields(ModelConfig)}
    unknown = set(fields) - names
    if unknown:
        raise ValueError(f"unknown ModelConfig fields {sorted(unknown)}")
    return ModelConfig(**fields)


def lm_params_from_numpy(cfg: ModelConfig, params: dict,
                         device="cuda") -> dict:
    """The port's LM parameters from the JAX package's tree with numpy
    leaves, for every family, leaf by leaf against
    ``models.api.param_shapes(cfg)``: ``embed``, ``final_norm``,
    ``lm_head`` (unless a dense model ties the embeddings) and ``layers``
    with a leading L dimension on every leaf; a hybrid model's
    ``mamba_main`` (n_super, a, ...), ``mamba_tail`` (trailing, ...) and
    ``shared``; an encdec model's ``encoder``, ``decoder`` and
    ``enc_norm``.  A tree of another config's names or shapes is refused.
    Every leaf is checked against the config's shapes and copied onto
    ``device`` in ``cfg.param_dtype``, so editing the numpy tree afterwards
    changes nothing in the port."""
    from .device import resolve_device

    dev = resolve_device(device)
    want = param_shapes(cfg)
    flat = {}

    def walk(tree, prefix):
        for k, v in tree.items():
            name = f"{prefix}{k}"
            if isinstance(v, dict):
                walk(v, name + ".")
            else:
                flat[name] = v

    walk(params, "")
    if set(flat) != set(want):
        raise ValueError(f"parameter names differ from {cfg.name}'s: missing "
                         f"{sorted(set(want) - set(flat))}, unknown "
                         f"{sorted(set(flat) - set(want))}")
    out = {}
    for name, shape in want.items():
        a = np.asarray(flat[name])
        if a.shape != tuple(shape):
            raise ValueError(f"{name}: shape {a.shape}, expected "
                             f"{tuple(shape)}")
        out[name] = torch.tensor(np.array(a, np.float32, copy=True)).to(
            device=dev, dtype=dt(cfg.param_dtype))
    return transformer._nest(out)
