"""A run with the timed path broken underneath comes out not correct: each
fault a cell can have, planted in the program, on the CPU at a small size.
(The cells run on one card, so no exchange between cards can be left
out.)"""

import pytest
import torch

from perfbench_support import CELLS, cpu_run, result, tiny_cell

from repro_torch.core import fleetsim
from repro_torch.kernels import charge_replay as cr


def unchanged_scan_step(monkeypatch):
    """The closed form's row step returns the lanes' state unchanged."""
    monkeypatch.setattr(fleetsim, "_scan_step",
                        lambda *a, **k: a[9])


def unchanged_lane_kernel(monkeypatch):
    """The lane kernel's wrapper returns every lane as it started: nothing
    spent, no reboot, the initial charge left."""
    real = cr.charge_replay

    def replay(*a, **k):
        out = real(*a, **k)
        zero = {key: torch.zeros_like(v) for key, v in out.items()}
        zero["rem"] = a[2].clone()
        zero["belief"] = a[1].clone()
        return zero

    monkeypatch.setattr(cr, "charge_replay", replay)


def half_the_batch(monkeypatch):
    """The fold leaves out the second half of the lanes: the means are
    taken over the rest."""
    real = fleetsim.reduce_lane_outputs

    def fold(out, gid, valid, edges, n_groups):
        valid = valid.clone()
        valid[valid.shape[0] // 2:] = False
        return real(out, gid, valid, edges, n_groups)

    monkeypatch.setattr(fleetsim, "reduce_lane_outputs", fold)


def answer_altered(monkeypatch):
    """The fold's answer is altered where it is produced: one cycle more
    in the live-cycle sum."""
    real = fleetsim.reduce_lane_outputs

    def fold(*a):
        psums, pmins, pmaxs = real(*a)
        psums = dict(psums)
        psums["live_cycles:sum"] = psums["live_cycles:sum"] + 1.0
        return psums, pmins, pmaxs

    monkeypatch.setattr(fleetsim, "reduce_lane_outputs", fold)


def lanes_altered(monkeypatch):
    """Every lane's replay outputs are altered where they are produced:
    one live cycle more, before the fold reads them."""
    real = fleetsim._dispatch

    def dispatch(prep, t, rows, shared_rows, theta, batch_rows,
                 belief_alpha, backend, reduce="none", stats_in=None,
                 host_checked=False):
        out = real(prep, t, rows, shared_rows, theta, batch_rows,
                   belief_alpha, backend, "none", None, host_checked)
        out = dict(out, live=out["live"] + 1.0)
        if reduce == "stats":
            return fleetsim.reduce_lane_outputs(out, *stats_in)
        return out

    monkeypatch.setattr(fleetsim, "_dispatch", dispatch)


FAULTS = {
    "har.design-space": [unchanged_lane_kernel, half_the_batch,
                         answer_altered, lanes_altered],
    "mnist.stats-query": [unchanged_scan_step, half_the_batch,
                          answer_altered, lanes_altered],
    "har.capacitor-sweep": [unchanged_scan_step, half_the_batch,
                            answer_altered, lanes_altered],
}


@pytest.mark.parametrize("workload,fault", [
    (w, f) for w in CELLS for f in FAULTS[w]],
    ids=lambda v: getattr(v, "__name__", v))
def test_a_broken_path_is_not_correct(monkeypatch, workload, fault):
    fault(monkeypatch)
    rc, lines, err = cpu_run(tiny_cell(workload))
    assert rc == 0, err
    res = result(lines)
    assert res["correct"] is False
    assert res["failed"] >= 1
    assert any(c["value"] > c["limit"] for c in res["checks"].values())
