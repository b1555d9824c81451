"""The paper, end to end, on the PyTorch port: the twin of
``examples/intermittent_mnist.py`` at the same sizes, seeds and table
layouts.

GENESIS-compress an MNIST-shaped network and retrain it, then run it on
the simulated energy-harvesting device under all six implementations and
four power systems (Fig. 9's experiment), across a jittered 1000-device
fleet, under the three uplink send policies, over a 15-candidate
``PlanSet`` design space, through the adaptive-commit risk sweep, and
finally as one streamed million-device ``reduce="stats"`` query.  Every
replay runs on the port's fleet replay (``repro_torch.core.fleetsim``):
the closed-form row scan for deterministic replays, the lane kernel for
replays with charge jitter (in plan mode for the design space, one
launch for all 15 candidates), the statistics fold for the query.

  PYTHONPATH=src python examples/intermittent_mnist_torch.py \\
      [--device cpu] [--scale 0.01]

``--scale`` multiplies every device count (1,000, 256, 64 a candidate and
1,000,000); at 1.0 the script makes the JAX example's calls.  ``--smoke``
puts MNIST's layer stack at a few channels (:func:`smoke_net`) in place of
the published widths, whose plans (53,055 SONIC rows for the original
net, 63,489 Tile-8 rows for the compressed one) take the CPU's plain
replay many minutes at any device count.  Each section is a function,
called in turn by :func:`main`; a section that raises ends the script
with a non-zero exit code.
"""

import argparse
import dataclasses
import importlib
import sys
import time
from pathlib import Path

sys.path.insert(0, str(Path(__file__).resolve().parents[1] / "src"))

import numpy as np  # noqa: E402

from repro_torch.compress import (DEVICE_WEIGHT_BYTES,  # noqa: E402
                                  LayerChoice, apply_config)
from repro_torch.compress.train_small import train  # noqa: E402
from repro_torch.core import (POWER_SYSTEMS, STRATEGIES,  # noqa: E402
                              PlanSet, build_plan, custom_power_system,
                              fleet_evaluate, fleet_sweep)
from repro_torch.core.energy import (JOULES_PER_CYCLE,  # noqa: E402
                                     make_power_system)
from repro_torch.core.inference import (Conv2D, DenseFC,  # noqa: E402
                                        MaxPool2D, SimNet)
from repro_torch.data import make_task  # noqa: E402
from repro_torch.models.dnn import (INPUT_SHAPES, NETWORKS,  # noqa: E402
                                    mnist_net)
from repro_torch.runtime import (RadioModel, SEND_POLICIES,  # noqa: E402
                                 pack_radio)

#: The device counts at ``--scale 1.0``: the fleet and uplink sweeps, the
#: risk sweep, the design space's devices a candidate, the stats query.
FLEET_DEVICES, RISK_DEVICES, DESIGN_DEVICES, QUERY_DEVICES = \
    1000, 256, 64, 1_000_000
#: The stats query's lanes a chunk.
QUERY_CHUNK = 8192
#: The design space's capacitors.
DESIGN_POWERS = ("100uF", "1mF", "50mF")
#: One line of each section's output, in order.
HEADERS = ("GENESIS: ", "impl          continuous",
           "-device fleet on the 1 mF capacitor", "uplink co-simulation: ",
           "design-space sweep: ", "adaptive-commit risk on a ",
           "-device fleet-level query")


def compressed_net(name: str, net=None):
    """GENESIS's MNIST choice for ``NETWORKS[name]()``: the first conv
    separated (HOOI), the deep conv pruned to 90 %, the large dense layers
    pruned to 95 % and 90 %, the rest kept.  A copy of
    ``benchmarks/paper_figs.py:79-96`` that also takes the network
    itself (``net``, for :func:`smoke_net`)."""
    net = NETWORKS[name]() if net is None else net
    choices = []
    for layer in net.layers:
        if isinstance(layer, Conv2D):
            co, ci, kh, kw = layer.w.shape
            if ci == 1:                       # first conv: separate (HOOI)
                choices.append(LayerChoice("separate",
                                           max(2, min(ci * kh, co * kw) // 6)))
            else:                             # deep conv: prune
                choices.append(LayerChoice("prune", 0.9))
        elif isinstance(layer, DenseFC) and layer.w.size > 20_000:
            choices.append(LayerChoice("prune", 0.95))
        elif isinstance(layer, DenseFC) and layer.w.size > 4_000:
            choices.append(LayerChoice("prune", 0.9))
        else:
            choices.append(LayerChoice("keep"))
    return apply_config(net, tuple(choices))


def sonic_risk_plan(net, x, span: float = 8.0):
    """One SONIC plan restamped onto a capacitor the inference spans
    ``span`` times -- the risk regime where every run crosses several
    charge boundaries.  SONIC rows are capacity-independent, so the
    restamp avoids a second plan extraction.  A copy of
    ``benchmarks/paper_figs.py:274-289``."""
    plan = build_plan(net, x, "sonic", custom_power_system(1e5))
    ps = custom_power_system(max(1e5, plan.total_cycles / span))
    return dataclasses.replace(plan, power=ps.name,
                               capacity=ps.cycles_per_charge,
                               recharge_s=ps.recharge_s), ps


def smoke_net(seed: int = 0) -> SimNet:
    """MNIST's layer stack at a few channels: conv 2@5x5, pool, conv
    4@5x5, pool, FC 64->16->16->10, seeded as ``mnist_net`` is."""
    rng = np.random.default_rng(seed)

    def conv(co, ci):
        w = rng.normal(size=(co, ci, 5, 5)) / np.sqrt(ci * 25)
        return Conv2D(w.astype(np.float32), np.zeros(co, np.float32))

    def fc(m, n, relu=True):
        w = rng.normal(size=(m, n)) / np.sqrt(n)
        return DenseFC(w.astype(np.float32), np.zeros(m, np.float32),
                       relu=relu)

    return SimNet([conv(2, 1), MaxPool2D(2), conv(4, 2), MaxPool2D(2),
                   fc(16, 64), fc(16, 16), fc(10, 16, relu=False)],
                  input_shape=INPUT_SHAPES["mnist"], name="mnist-smoke")


def scaled(count: int, scale: float) -> int:
    """``count`` devices at ``scale``, at least one."""
    return max(1, int(round(count * scale)))


def genesis(smoke: bool = False, device="cuda"):
    """The original and GENESIS-compressed MNIST nets (:func:`smoke_net`'s
    with ``smoke``), the compressed one retrained on the synthetic
    stand-in task.  Returns (orig, net, task)."""
    orig = smoke_net() if smoke else mnist_net()
    net = compressed_net("mnist", smoke_net() if smoke else None)
    print(f"GENESIS: {orig.total_params()} params "
          f"({orig.params_bytes()//1024} KB, "
          f"fits={orig.params_bytes() <= DEVICE_WEIGHT_BYTES}) -> "
          f"{net.total_params()} params ({net.params_bytes()//1024} KB, "
          f"fits={net.params_bytes() <= DEVICE_WEIGHT_BYTES})")
    # quick accuracy check on the synthetic stand-in task
    task = make_task("mnist", n_train=512, n_test=256, noise=0.85)
    net, acc = train(net, task, epochs=2, device=device)
    print(f"retrained compressed net accuracy: {acc:.3f}\n")
    return orig, net, task


def matrix(net, x, device="cuda") -> dict:
    """Fig. 9: all 24 (strategy, power) cells in one replay.  Returns the
    ``RunResult`` a cell."""
    t0 = time.perf_counter()
    cells = {(r.strategy, r.power): r
             for r in fleet_evaluate(net, x, device=device)}
    matrix_s = time.perf_counter() - t0
    print(f"{'impl':10s}" + "".join(f"{p:>14s}" for p in POWER_SYSTEMS))
    for strat in STRATEGIES:
        row = [f"{cells[(strat, p)].total_time_s*1e3:10.1f} ms"
               if cells[(strat, p)].completed else f"{'DNF':>13s}"
               for p in POWER_SYSTEMS]
        print(f"{strat:10s}" + "".join(f"{c:>14s}" for c in row))
    print(f"\n(naive/large tiles DNF on small capacitors; SONIC & TAILS "
          f"always complete -- the paper's Fig. 9.  Entire matrix replayed "
          f"in {matrix_s:.2f}s.)\n")
    return cells


def fleet(net, x, n: int, device="cuda") -> dict:
    """The same plans across a jittered fleet: ``n`` devices, each waking
    at its own charge level and paying per-reboot recharge times drawn
    from its own harvest trace.  Returns each strategy's summary."""
    print(f"{n}-device fleet on the 1 mF capacitor "
          f"(per-device wake charge + recharge traces):")
    out = {}
    for strat in ("sonic", "tails"):
        r = fleet_sweep(net, x, strat, "1mF", n_devices=n, seed=42,
                        trace_reboots=64, device=device)
        s = out[strat] = r.summary()
        print(f"  {strat:6s} completed={s['completed']}/{n} "
              f"mean={s['mean_total_s']*1e3:8.1f} ms "
              f"p95={s['p95_total_s']*1e3:8.1f} ms "
              f"mean_reboots={s['mean_reboots']:.1f} "
              f"wall={s['wall_s']:.2f}s")
    print(f"\n(one replay per strategy -- the scalar simulator at "
          f"~tens of ms/device would need minutes for {2 * n} runs.)")
    return out


def uplink(net, x, n: int, device="cuda") -> dict:
    """Every device gets a radio and a duty-cycled basestation; each
    completed inference takes a send/defer/compress decision (decision 5)
    charged against the same capacitor as compute, under each of the
    three send policies.  Returns each policy's uplink summary and its
    bits a joule."""
    basestation = RadioModel(window_period_s=0.05, window_duty=0.3)
    print(f"\nuplink co-simulation: {n} sonic devices, basestation "
          f"listening {basestation.window_duty:.0%} of every "
          f"{basestation.window_period_s * 1e3:.0f} ms:")
    print(f"  {'policy':16s} {'sent':>5s} {'defer':>6s} {'bytes':>7s} "
          f"{'radio uJ':>9s} {'bits/J':>10s}")
    out = {}
    for pol in SEND_POLICIES:
        r = fleet_sweep(net, x, "sonic", "1mF", n_devices=n, seed=42,
                        trace_reboots=64,
                        radio=pack_radio(basestation, pol), device=device)
        u = r.summary()["uplink"]
        bits = 8.0 * (u["tx_bytes"]
                      - basestation.header_bytes * u["msgs_sent"])
        out[pol.name] = dict(u, bits_per_j=bits / r.energy_j.sum())
        print(f"  {pol.name:16s} {u['msgs_sent']:5d} "
              f"{u['msgs_deferred']:6d} {u['tx_bytes']:7.0f} "
              f"{u['tx_joules'] * 1e6:9.2f} "
              f"{out[pol.name]['bits_per_j']:10.0f}")
    print("(a send waking into a closed window defers -- dead time, no "
          "energy; a send torn by a power failure re-pays its preamble "
          "after the reboot, like any other atomic row.)")
    return out


def design_plans(orig, net, x) -> PlanSet:
    """The (networks x tile-k x capacitors) design space as one PlanSet:
    original and GENESIS nets under SONIC and TAILS, the GENESIS net under
    Tile-8, each at the three capacitors of :data:`DESIGN_POWERS`.  SONIC
    and Tile-8 rows don't depend on the capacitor, so those plans are built
    once and restamped a power system; TAILS bakes its tile choice from
    the capacitor at build time, so it builds a power.  Tile-8 on the
    476k-param original would alone be a ~500k-row plan, so the original
    network enters through SONIC and TAILS only."""
    def restamped(plan, power):
        p = make_power_system(power)
        return dataclasses.replace(plan, capacity=p.cycles_per_charge,
                                   recharge_s=p.recharge_s, power=p.name)

    plans, labels = [], []
    for nname, cnet in (("orig", orig), ("genesis", net)):
        sonic = build_plan(cnet, x, "sonic", "1mF")
        for p in DESIGN_POWERS:
            plans.append(restamped(sonic, p))
            labels.append(f"{nname}/sonic/{p}")
            plans.append(build_plan(cnet, x, "tails", p))
            labels.append(f"{nname}/tails/{p}")
    tile8 = build_plan(net, x, "tile-8", "1mF")
    for p in DESIGN_POWERS:
        plans.append(restamped(tile8, p))
        labels.append(f"genesis/tile-8/{p}")
    return PlanSet.from_plans(plans, labels=labels)


def design_sweep(design: PlanSet, n: int, device="cuda"):
    """The design space's one replay: ``n`` devices a candidate with
    per-charge capacity jitter (cv 0.2, 32 charges)."""
    return fleet_sweep(plan=design, n_devices=n, seed=42, charge_cv=0.2,
                       charge_reboots=32, device=device)


def pareto(rows) -> set:
    """The candidates on the (completion up, energy down) frontier."""
    frontier = set()
    best = -1.0
    for i in sorted(range(len(rows)),
                    key=lambda i: rows[i]["mean_energy_j"]):
        if rows[i]["completion"] > best:
            frontier.add(i)
            best = rows[i]["completion"]
    return frontier


def design_space(orig, net, x, n: int, device="cuda") -> dict:
    """The whole design space as ONE PlanSet replay; the Pareto column
    marks the frontier.  Returns the summary rows, the frontier and the
    lane kernel's plan-mode launches the sweep made."""
    cr = importlib.import_module("repro_torch.kernels.charge_replay")
    design = design_plans(orig, net, x)
    before = cr.charge_replay.launches_by_mode["plan"]
    res = design_sweep(design, n, device)
    launches = cr.charge_replay.launches_by_mode["plan"] - before
    rows = res.summary()
    frontier = pareto(rows)
    print(f"\ndesign-space sweep: {len(design)} candidates x "
          f"{res.n_devices} devices in ONE replay "
          f"(plan-mode launches={launches}, wall={res.wall_s:.2f}s):")
    print(f"  {'candidate':22s} {'done':>5s} {'mean uJ':>9s} "
          f"{'p95 ms':>8s} {'pareto':>6s}")
    for i, row in enumerate(rows):
        uj = (f"{row['mean_energy_j'] * 1e6:9.2f}"
              if np.isfinite(row["mean_energy_j"]) else f"{'DNF':>9s}")
        ms = (f"{row['p95_total_s'] * 1e3:8.1f}"
              if np.isfinite(row["p95_total_s"]) else f"{'-':>8s}")
        print(f"  {row['label']:22s} {row['completion']:5.2f} {uj} {ms} "
              f"{'  *' if i in frontier else '':>6s}")
    print("(every row above replayed in the same launch -- the stacked "
          "candidate axis is how GENESIS prices its whole accuracy-energy "
          "frontier in one fleet_sweep call.)")
    return {"rows": rows, "frontier": frontier, "plan_launches": launches}


#: The risk sweep's adaptive variants: single-row chunks, the
#: cross-charge window, and that window with EWMA belief recalibration.
RISK_VARIANTS = (dict(batch_rows=1, belief_alpha=0.0),
                 dict(batch_rows=10**6, belief_alpha=0.0),
                 dict(batch_rows=10**6, belief_alpha=0.25))
RISK_CVS = (0.0, 0.2, 0.4, 0.8)


def risk(net, x, nd: int, device="cuda") -> dict:
    """The energy-adaptive commit policy under stochastic charges: a
    mis-predicted chunk dies before its commit, rolls back and
    re-executes (the wasted_cycles channel).  Returns, a charge cv, the
    fixed and adaptive mean energies and the two cross-charge variants'
    mean waste."""
    plan, ps = sonic_risk_plan(net, x)
    print(f"\nadaptive-commit risk on a {ps.cycles_per_charge:.0f}-cycle "
          f"capacitor ({plan.total_cycles / ps.cycles_per_charge:.1f} "
          f"charges/inference, {nd} devices, theta=0.5; jitter = "
          f"per-charge cv + equal persistent per-device bias):")
    print(f"  {'charge cv':>9s} {'fixed uJ':>9s} {'adapt uJ':>9s} "
          f"{'xchg uJ':>9s} {'+ewma uJ':>9s} {'xchg waste':>10s} "
          f"{'ewma waste':>10s}")
    out = {}
    for cv in RISK_CVS:
        jitter = dict(charge_cv=cv, charge_bias_cv=cv, charge_reboots=160)
        fx = fleet_sweep(net, x, "sonic", ps, n_devices=nd, seed=42,
                         plan=plan, device=device, **jitter)
        ads = [fleet_sweep(net, x, "sonic", ps, n_devices=nd, seed=42,
                           plan=plan, policy="adaptive", theta=0.5,
                           device=device, **kn, **jitter)
               for kn in RISK_VARIANTS]
        uj = [a.energy_j.mean() * 1e6 for a in ads]
        out[cv] = {"fixed_uj": fx.energy_j.mean() * 1e6, "adaptive_uj": uj,
                   "xchg_waste": float(ads[1].wasted_cycles.mean()),
                   "ewma_waste": float(ads[2].wasted_cycles.mean())}
        print(f"  {cv:9.1f} {out[cv]['fixed_uj']:9.3f} "
              f"{uj[0]:9.3f} {uj[1]:9.3f} {uj[2]:9.3f} "
              f"{out[cv]['xchg_waste']:10.0f} "
              f"{out[cv]['ewma_waste']:10.0f}")
    print("(single-row chunks bound each rollback to one row; the "
          "cross-charge window wins big on calm charges and bleeds on "
          "jittery ones; EWMA recalibration claws most of that back -- "
          "1 cycle = {:.1e} J.)".format(JOULES_PER_CYCLE))
    return out


def stats_query(net, x, big: int, device="cuda"):
    """Ask the fleet-level question instead of materializing the fleet:
    ``reduce="stats"`` folds every lane into fixed-size statistics and
    ``lane_chunk=`` streams the device axis through one constant-size
    buffer, so peak lane memory is set by the chunk, not the fleet.
    Returns the ``FleetStats``."""
    st = fleet_sweep(net, x, "sonic", "1mF", n_devices=big, seed=42,
                     reduce="stats", lane_chunk=QUERY_CHUNK, device=device)
    s = st.summary()
    print(f"\n{big}-device fleet-level query (streamed, reduce='stats'):")
    print(f"  completion rate : {st.completion_rate[0]:.4f} "
          f"({s['completed']}/{s['devices']})")
    exact_max = st.maxs["live_cycles"][0] * JOULES_PER_CYCLE
    print(f"  energy/inference: p50={st.energy_percentile(50.0)[0]*1e6:.2f}"
          f" uJ  p95={st.energy_percentile(95.0)[0]*1e6:.2f} uJ "
          f"(exact max {exact_max*1e6:.2f} uJ)")
    print(f"  p95 wall/device : {s['p95_total_s']*1e3:.1f} ms "
          f"(histogram-resolution percentile)")
    print(f"  peak lane buffer: {st.peak_lane_bytes/1e6:.1f} MB for "
          f"{big} lanes -- identical at 1e4 or 1e7 (wall "
          f"{s['wall_s']:.1f}s)")
    return st


def main(argv=None) -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("--device", default="cuda")
    ap.add_argument("--scale", type=float, default=1.0,
                    help="multiplies every device count")
    ap.add_argument("--smoke", action="store_true",
                    help="MNIST's layers at a few channels (CPU scale)")
    args = ap.parse_args(argv)
    dev, scale = args.device, args.scale
    walls = {}
    cr = importlib.import_module("repro_torch.kernels.charge_replay")
    fold = importlib.import_module("repro_torch.kernels.stats_fold")
    cf = importlib.import_module("repro_torch.kernels.closed_form")
    by_mode = dict(cr.charge_replay.launches_by_mode)
    folds = fold.stats_fold.launches
    closed = cf.closed_form.launches

    def timed(name, fn, *a):
        t0 = time.perf_counter()
        out = fn(*a, device=dev)
        walls[name] = time.perf_counter() - t0
        return out

    orig, net, task = timed("genesis", genesis, args.smoke)
    x = task.x_test[0]
    timed("matrix", matrix, net, x)
    n = scaled(FLEET_DEVICES, scale)
    timed("fleet", fleet, net, x, n)
    timed("uplink", uplink, net, x, n)
    timed("design_space", design_space, orig, net, x,
          scaled(DESIGN_DEVICES, scale))
    timed("risk", risk, net, x, scaled(RISK_DEVICES, scale))
    timed("stats_query", stats_query, net, x, scaled(QUERY_DEVICES, scale))
    print("\nsection walls: " + ", ".join(f"{k}={v:.2f}s"
                                          for k, v in walls.items()))
    print("kernel launches: " + ", ".join(
        f"charge_replay/{m}={n - by_mode[m]}"
        for m, n in cr.charge_replay.launches_by_mode.items())
        + f", stats_fold={fold.stats_fold.launches - folds}"
        + f", closed_form={cf.closed_form.launches - closed}")
    return 0


if __name__ == "__main__":
    sys.exit(main())
