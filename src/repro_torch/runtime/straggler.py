"""Straggler mitigation policies for synchronous data-parallel steps.

Per-host step times are lognormal with occasional degraded hosts (thermal
throttling / noisy neighbours).  Policies:

  sync      -- barrier on the slowest host (the baseline).
  backup    -- duplicate the slowest shard's work on a spare host after a
               deadline (MapReduce-style backup tasks): effective time =
               max(second_max, deadline + redo).
  quorum    -- drop gradients from hosts beyond the q-quantile deadline and
               renormalize (bounded staleness; standard at 1000+ nodes).
"""

from __future__ import annotations

from dataclasses import dataclass

import numpy as np


@dataclass(frozen=True)
class StragglerSpec:
    n_hosts: int
    base_s: float = 1.0          # median per-host step time
    sigma: float = 0.08          # lognormal spread
    slow_frac: float = 0.01      # fraction of degraded hosts per step
    slow_factor: float = 3.0     # degradation multiplier


def host_times(spec: StragglerSpec, steps: int, seed: int = 0) -> np.ndarray:
    rng = np.random.default_rng(seed)
    t = spec.base_s * rng.lognormal(0.0, spec.sigma,
                                    size=(steps, spec.n_hosts))
    slow = rng.random((steps, spec.n_hosts)) < spec.slow_frac
    return np.where(slow, t * spec.slow_factor, t)


def step_times(policy: str, times: np.ndarray, *, quorum: float = 0.95,
               backup_deadline: float = 1.5, overhead: float = 0.05
               ) -> np.ndarray:
    """Effective per-step wall times under a mitigation policy.

    ``times``: (steps, hosts).  ``backup_deadline`` and quantiles are
    relative to the per-step median."""
    med = np.median(times, axis=1, keepdims=True)
    if policy == "sync":
        return times.max(axis=1)
    if policy == "backup":
        deadline = backup_deadline * med[:, 0]
        # every shard still running at the deadline is duplicated on a
        # median-speed spare; the step ends when the later of (slowest
        # on-time host, spare redo) finishes
        on_time = np.where(times <= deadline[:, None], times, 0.0
                           ).max(axis=1)
        redo = deadline + med[:, 0] + overhead
        need_backup = times.max(axis=1) > deadline
        return np.where(need_backup, np.maximum(on_time, redo),
                        times.max(axis=1))
    if policy == "quorum":
        q = np.quantile(times, quorum, axis=1)
        # gradient contribution of dropped hosts is renormalized; a small
        # constant accounts for the scale correction collective
        return q + overhead
    raise ValueError(policy)


def efficiency(policy: str, spec: StragglerSpec, steps: int = 500,
               seed: int = 0, **kw) -> dict:
    times = host_times(spec, steps, seed)
    eff = step_times(policy, times, **kw)
    ideal = np.median(times, axis=1)
    return {
        "policy": policy,
        "mean_step_s": float(eff.mean()),
        "p99_step_s": float(np.quantile(eff, 0.99)),
        "vs_ideal": float(eff.mean() / ideal.mean()),
    }
