"""The cell's network, its input and each checked lane's inputs, made by the
benchmark from the configuration file and the seeds.

``network_arrays`` draws the weights as ``src/repro_torch/models/dnn.py``
draws them (layer by layer from ``numpy.random.default_rng(weights_seed)``:
``N(0, 1) / sqrt(fan_in)`` as float32, zero biases); ``build_net`` turns
them into a ``SimNet`` of whichever layer classes it is given, so the
program and the reference receive the same arrays.  ``lane_inputs`` draws
one lane's inputs again from the call's seed, as ``fleet_sweep`` and its
design sweep draw them, and ``capacitor_lane_inputs`` as ``capacitor_sweep``
does (``src/repro_torch/core/fleetsim.py``).
"""

from __future__ import annotations

import math

import numpy as np

from . import samplers as S
from .energy import rf_recharge_seconds


def network_arrays(cfg: dict) -> list[dict]:
    rng = np.random.default_rng(cfg["weights_seed"])
    layers = []
    for spec in cfg["layers"]:
        kind = spec["type"]
        if kind == "conv":
            co, ci, kh, kw = spec["out"], spec["in"], spec["kh"], spec["kw"]
            w = (rng.normal(size=(co, ci, kh, kw)) / np.sqrt(ci * kh * kw)
                 ).astype(np.float32)
            layers.append(dict(spec, w=w, b=np.zeros(co, np.float32)))
        elif kind == "fc":
            m, n = spec["out"], spec["in"]
            w = (rng.normal(size=(m, n)) / np.sqrt(n)).astype(np.float32)
            layers.append(dict(spec, w=w, b=np.zeros(m, np.float32)))
        elif kind == "pool":
            layers.append(dict(spec))
        else:
            raise ValueError(f"unknown layer type {kind!r}")
    return layers


def network_input(cfg: dict) -> np.ndarray:
    return np.random.default_rng(cfg["input_seed"]).normal(
        size=tuple(cfg["input_shape"])).astype(np.float32)


def build_net(cfg: dict, arrays: list[dict], mod):
    """A ``SimNet`` of ``mod``'s ``Conv2D``, ``MaxPool2D``, ``DenseFC``."""
    layers = []
    for spec in arrays:
        if spec["type"] == "conv":
            layers.append(mod.Conv2D(spec["w"], spec["b"], name=spec["name"]))
        elif spec["type"] == "fc":
            layers.append(mod.DenseFC(spec["w"], spec["b"],
                                      relu=spec.get("relu", True),
                                      name=spec["name"]))
        elif spec["kh"] == spec["kw"]:
            layers.append(mod.MaxPool2D(spec["kh"]))
        else:
            layers.append(mod.MaxPool2D(kh=spec["kh"], kw=spec["kw"]))
    return mod.SimNet(layers, input_shape=tuple(cfg["input_shape"]),
                      name=cfg["network"])


def lane_inputs(sweep: dict, heads: list[dict], seed: int, lane: int,
                design: bool) -> dict:
    """The inputs of lane ``lane`` of one call: ``heads`` are the candidates'
    ``capacity`` and ``recharge_s``; a design sweep (``design``) lays its
    lanes out plan-major, ``n_devices`` a candidate.  Unchunked calls draw
    the legacy streams of the whole fleet (seeds ``seed`` to ``seed + 3``)
    and take the lane's row; chunked ones draw the lane alone from the
    counter-based streams, which are chunk-invariant."""
    dev = sweep["n_devices"]
    p, d = divmod(lane, dev) if design else (0, lane)
    cap = float(heads[p]["capacity"])
    rs = float(heads[p]["recharge_s"])
    cv = sweep.get("recharge_cv", 0.25)
    tr = sweep.get("trace_reboots", 0)
    ccv, bcv = sweep.get("charge_cv", 0.0), sweep.get("charge_bias_cv", 0.0)
    creb = sweep.get("charge_reboots", 0)
    use_charge = ccv > 0 or bcv > 0 or creb > 0
    if design:
        n_charges = creb or (256 if use_charge else 8)
        use_charge = True                  # design sweeps replay charge-wise
    else:
        n_charges = creb or 256
    cum = ccum = None
    if sweep.get("lane_chunk") is None:
        frac = S.initial_charge_fraction(dev, seed=seed)[d]
        jm = S.harvest_jitter(dev, seed=seed + 1, cv=cv)
        if tr > 0:
            cum = S.cumulative(S.reboot_recharge_times(
                dev, tr, rs, seed=seed + 2) * jm[:, None])[d]
        if use_charge:
            ccum = S.cumulative(S.charge_capacity_jitter(
                dev, n_charges, cap, seed=seed + 3, cv=ccv,
                bias_cv=bcv))[d]
        jm = jm[d]
    else:
        frac = S.initial_charge_fraction_stream(1, seed=seed,
                                                lane_lo=lane)[0]
        jm = S.harvest_jitter_stream(1, seed=seed, cv=cv, lane_lo=lane)
        if tr > 0:
            cum = S.cumulative(S.reboot_recharge_times_stream(
                1, tr, rs, seed=seed, lane_lo=lane) * jm[:, None])[0]
        if use_charge:
            ccum = S.cumulative(S.charge_capacity_jitter_stream(
                1, n_charges, cap, seed=seed, cv=ccv, bias_cv=bcv,
                lane_lo=lane))[0]
        jm = jm[0]
    rem0 = math.inf if math.isinf(cap) else cap * frac
    return dict(plan=p, cap=cap, rem0=rem0, tail_s=rs * jm,
                recharge_cum=cum, charge_cum=ccum)


def capacitor_lane_inputs(sweep: dict, capacities, seed: int,
                          lane: int) -> dict:
    """The inputs of lane ``lane`` of one capacitor sweep: ``n_devices``
    lanes a capacitor, capacitor-major, each with the capacitor's RF
    recharge time as its mean dead time and the one plan.  Unchunked calls
    draw the legacy streams over the whole grid (seeds ``seed``,
    ``seed + 1`` and, for stochastic charges, ``seed + 3``); chunked ones
    draw the lane alone from the counter-based streams."""
    caps = np.asarray(capacities, np.float64)
    lanes = caps.size * sweep["n_devices"]
    g = lane // sweep["n_devices"]
    cap = float(caps[g])
    cv = sweep.get("recharge_cv", 0.25)
    ccv, bcv = sweep.get("charge_cv", 0.0), sweep.get("charge_bias_cv", 0.0)
    creb = sweep.get("charge_reboots", 0)
    use_charge = ccv > 0 or bcv > 0 or creb > 0
    ccum = None
    if sweep.get("lane_chunk") is None:
        frac = S.initial_charge_fraction(lanes, seed=seed)[lane]
        jm = S.harvest_jitter(lanes, seed=seed + 1, cv=cv)[lane]
        if use_charge:
            ccum = S.cumulative(S.charge_capacity_jitter(
                lanes, creb or 256, np.repeat(caps, sweep["n_devices"]),
                seed=seed + 3, cv=ccv, bias_cv=bcv))[lane]
    else:
        frac = S.initial_charge_fraction_stream(1, seed=seed,
                                                lane_lo=lane)[0]
        jm = S.harvest_jitter_stream(1, seed=seed, cv=cv, lane_lo=lane)[0]
        if use_charge:
            ccum = S.cumulative(S.charge_capacity_jitter_stream(
                1, creb or 256, cap, seed=seed, cv=ccv, bias_cv=bcv,
                lane_lo=lane))[0]
    inf = math.isinf(cap)
    return dict(plan=0, cap=cap, rem0=math.inf if inf else cap * frac,
                tail_s=0.0 if inf else float(rf_recharge_seconds(cap)) * jm,
                recharge_cum=None, charge_cum=ccum)
