"""The lane-input reference: frozen copies of the port's harvest samplers.

Copied from ``src/repro_torch/runtime/failures.py`` at commit f60fe63: the
legacy sequential draws (``harvest_jitter``, ``initial_charge_fraction``,
``reboot_recharge_times``, ``charge_capacity_jitter``), the counter-based
``*_stream`` draws and the cumulative trace tables.  The benchmark draws
each checked lane's inputs again from the call's seed with these, so the
reference takes nothing the program drew.  Numpy only.
"""

from __future__ import annotations

import numpy as np

_FRAC_STREAM, _HARVEST_STREAM, _RECHARGE_STREAM, _CHARGE_STREAM = 0, 1, 2, 3


def harvest_jitter(n_devices: int, seed: int = 0,
                   cv: float = 0.25) -> np.ndarray:
    rng = np.random.default_rng(seed)
    sigma = np.sqrt(np.log1p(cv * cv))
    return rng.lognormal(mean=-sigma * sigma / 2, sigma=sigma,
                         size=n_devices)


def initial_charge_fraction(n_devices: int, seed: int = 0) -> np.ndarray:
    rng = np.random.default_rng(seed)
    return rng.uniform(0.05, 1.0, size=n_devices)


def reboot_recharge_times(n_devices: int, n_reboots: int,
                          mean_recharge_s: float, seed: int = 0) -> np.ndarray:
    rng = np.random.default_rng(seed)
    return rng.exponential(mean_recharge_s, size=(n_devices, n_reboots))


def cumulative(traces: np.ndarray) -> np.ndarray:
    """``recharge_trace_cumulative`` / ``charge_trace_cumulative``: the
    ``(devices, k + 1)`` prefix sums, first column 0."""
    traces = np.asarray(traces, np.float64)
    out = np.zeros((traces.shape[0], traces.shape[1] + 1), np.float64)
    np.cumsum(traces, axis=1, out=out[:, 1:])
    return out


def charge_capacity_jitter(n_devices: int, n_charges: int, nominal_cycles,
                           seed: int = 0, cv: float = 0.25,
                           bias_cv: float = 0.0,
                           lo: float = 0.25, hi: float = 4.0) -> np.ndarray:
    nominal = np.broadcast_to(
        np.asarray(nominal_cycles, np.float64).reshape(-1, 1),
        (n_devices, n_charges))
    if cv == 0 and bias_cv == 0:
        mult = np.ones((n_devices, n_charges))
    else:
        rng = np.random.default_rng(seed)
        if cv > 0:
            sigma = np.sqrt(np.log1p(cv * cv))
            mult = rng.lognormal(mean=-sigma * sigma / 2, sigma=sigma,
                                 size=(n_devices, n_charges))
        else:
            mult = np.ones((n_devices, n_charges))
        if bias_cv > 0:
            bsig = np.sqrt(np.log1p(bias_cv * bias_cv))
            bias = rng.lognormal(mean=-bsig * bsig / 2, sigma=bsig,
                                 size=n_devices)
            mult = mult * bias[:, None]
        mult = np.clip(mult, lo, hi)
    return np.maximum(np.rint(nominal * mult), 1.0)


def _stream_uniforms(n_lanes: int, draws_per_lane: int, seed: int,
                     stream: int, lane_lo: int) -> np.ndarray:
    slot = -(-int(draws_per_lane) // 4) * 4
    bg = np.random.Philox(key=np.array([seed, stream], np.uint64))
    bg.advance(int(lane_lo) * slot // 4)
    u = np.random.Generator(bg).random(n_lanes * slot)
    return u.reshape(n_lanes, slot)[:, :draws_per_lane]


def _stream_normals(n_lanes: int, per_lane: int, seed: int, stream: int,
                    lane_lo: int) -> np.ndarray:
    u = _stream_uniforms(n_lanes, 2 * per_lane, seed, stream, lane_lo)
    u1, u2 = u[:, :per_lane], u[:, per_lane:]
    return np.sqrt(-2.0 * np.log1p(-u1)) * np.cos(2.0 * np.pi * u2)


def initial_charge_fraction_stream(n_devices: int, seed: int = 0,
                                   lane_lo: int = 0) -> np.ndarray:
    u = _stream_uniforms(n_devices, 1, seed, _FRAC_STREAM, lane_lo)
    return 0.05 + 0.95 * u[:, 0]


def harvest_jitter_stream(n_devices: int, seed: int = 0, cv: float = 0.25,
                          lane_lo: int = 0) -> np.ndarray:
    z = _stream_normals(n_devices, 1, seed, _HARVEST_STREAM, lane_lo)[:, 0]
    sigma = np.sqrt(np.log1p(cv * cv))
    return np.exp(-sigma * sigma / 2 + sigma * z)


def reboot_recharge_times_stream(n_devices: int, n_reboots: int,
                                 mean_recharge_s, seed: int = 0,
                                 lane_lo: int = 0) -> np.ndarray:
    u = _stream_uniforms(n_devices, n_reboots, seed, _RECHARGE_STREAM,
                         lane_lo)
    mean = np.asarray(mean_recharge_s, np.float64)
    if mean.ndim == 1:
        mean = mean[:, None]
    return -mean * np.log1p(-u)


def charge_capacity_jitter_stream(n_devices: int, n_charges: int,
                                  nominal_cycles, seed: int = 0,
                                  cv: float = 0.25, bias_cv: float = 0.0,
                                  lane_lo: int = 0, lo: float = 0.25,
                                  hi: float = 4.0) -> np.ndarray:
    z = _stream_normals(n_devices, n_charges + 1, seed, _CHARGE_STREAM,
                        lane_lo)
    nominal = np.broadcast_to(
        np.asarray(nominal_cycles, np.float64).reshape(-1, 1),
        (n_devices, n_charges))
    if cv == 0 and bias_cv == 0:
        mult = np.ones((n_devices, n_charges))
    else:
        if cv > 0:
            sigma = np.sqrt(np.log1p(cv * cv))
            mult = np.exp(-sigma * sigma / 2 + sigma * z[:, :n_charges])
        else:
            mult = np.ones((n_devices, n_charges))
        if bias_cv > 0:
            bsig = np.sqrt(np.log1p(bias_cv * bias_cv))
            bias = np.exp(-bsig * bsig / 2 + bsig * z[:, n_charges])
            mult = mult * bias[:, None]
        mult = np.clip(mult, lo, hi)
    return np.maximum(np.rint(nominal * mult), 1.0)
