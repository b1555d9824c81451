"""GENESIS: automatic network compression optimizing end-to-end IMpJ.

For each layer GENESIS sweeps separation (spatial SVD / Tucker-2 for convs,
rank SVD for FCs) and magnitude pruning, retrains each configuration, and
places it on the {accuracy, params, energy} Pareto frontier.  The chosen
configuration maximizes the application's IMpJ (Sec. 3 model) among those
that fit the device's memory (Sec. 5.3).

The paper uses Ray Tune's black-box search over this space; offline we
sweep a deterministic grid (the search spaces match; the optimizer is
swappable).

The counterpart of the JAX package's ``compress/genesis.py``: the grid,
the choices and the selection are its numpy code, copied; the retraining
runs ``repro_torch.compress.train_small`` and the pricing the port's fleet
replay (one ``fleet_sweep`` of a ``PlanSet``, its statistics folded on the
card), on ``device`` (``"cuda"`` by default; ``"cpu"`` runs the plain
PyTorch path).
"""

from __future__ import annotations

import itertools
from dataclasses import dataclass, field

import numpy as np

from ..core.energy import JOULES_PER_CYCLE
from ..core.imp import AppModel
from ..core.inference import Conv2D, DenseFC, MaxPool2D, SimNet, SparseFC
from ..data.synthetic import Dataset
from ..device import resolve_device
from .prune import prune_by_sparsity
from .svd import svd_factor, svd_params
from .tucker import separate_conv_spatial, separation_params

#: device memory available for weights (256 KB FRAM minus code/buffers)
DEVICE_WEIGHT_BYTES = 200 * 1024

#: calibrated cycles per MAC including loads/stores/cursors (SONIC inner
#: loops, Sec. 6.2) -- used for fast energy estimates during the sweep; the
#: chosen configuration is re-measured exactly by the device simulator.
CYCLES_PER_MAC = {"sonic": 27.0, "tails": 9.0, "naive": 19.0}


@dataclass(frozen=True)
class LayerChoice:
    kind: str              # keep | prune | svd | separate
    arg: float = 0.0       # sparsity or rank


@dataclass
class ConfigResult:
    choices: tuple
    params: int
    params_bytes: int
    macs: int
    accuracy: float
    tp: float
    tn: float
    e_infer_j: float
    feasible: bool
    impj: float = 0.0
    completion: float = 1.0      # fleet completion rate under the sweep's
    latency_s: float = 0.0       # intermittent power; mean wall-clock
    net: SimNet = field(default=None, repr=False)


def apply_choice(layer, choice: LayerChoice):
    """Returns a list of replacement layers."""
    if choice.kind == "keep" or isinstance(layer, MaxPool2D):
        return [layer]
    if isinstance(layer, Conv2D):
        if choice.kind == "prune":
            w = prune_by_sparsity(layer.w, choice.arg)
            return [Conv2D(w, layer.b, layer.stride, layer.relu,
                           layer.name + f"_p{choice.arg:.2f}")]
        if choice.kind == "separate":
            v, h = separate_conv_spatial(layer.w, int(choice.arg))
            return [
                Conv2D(v, np.zeros(v.shape[0], np.float32), layer.stride,
                       relu=False, name=layer.name + "_sepv"),
                Conv2D(h, layer.b, 1, relu=layer.relu,
                       name=layer.name + "_seph"),
            ]
    if isinstance(layer, (DenseFC, SparseFC)):
        if choice.kind == "prune":
            w = prune_by_sparsity(layer.w, choice.arg)
            return [SparseFC(w, layer.b, layer.relu,
                             layer.name + f"_p{choice.arg:.2f}")]
        if choice.kind == "svd":
            a, b = svd_factor(layer.w, int(choice.arg))
            return [
                DenseFC(b, np.zeros(b.shape[0], np.float32), relu=False,
                        name=layer.name + "_svd1"),
                DenseFC(a, layer.b, relu=layer.relu,
                        name=layer.name + "_svd2"),
            ]
    raise ValueError(f"{choice} not applicable to {layer}")


def layer_choices(layer, budget: str = "normal") -> list[LayerChoice]:
    if isinstance(layer, MaxPool2D):
        return [LayerChoice("keep")]
    if isinstance(layer, Conv2D):
        co, ci, kh, kw = layer.w.shape
        max_r = min(ci * kh, co * kw)
        ranks = sorted({max(1, max_r // 8), max(1, max_r // 4),
                        max(2, max_r // 2)})
        out = [LayerChoice("keep")]
        out += [LayerChoice("separate", r) for r in ranks
                if separation_params(layer.w.shape, r) < layer.w.size]
        out += [LayerChoice("prune", s) for s in (0.5, 0.8, 0.9)]
        return out
    if isinstance(layer, (DenseFC, SparseFC)):
        m, n = layer.w.shape
        max_r = min(m, n)
        ranks = sorted({max(1, max_r // 8), max(1, max_r // 4)})
        out = [LayerChoice("keep")]
        out += [LayerChoice("svd", r) for r in ranks
                if svd_params(m, n, r) < m * n]
        out += [LayerChoice("prune", s) for s in (0.8, 0.9, 0.95, 0.98)]
        return out
    return [LayerChoice("keep")]


def apply_config(net: SimNet, choices) -> SimNet:
    layers = []
    for layer, ch in zip(net.layers, choices):
        layers.extend(apply_choice(layer, ch))
    return SimNet(layers, net.input_shape, net.name)


def estimate_energy(net: SimNet, runtime: str = "tails", *,
                    stats=None, group: int | None = None,
                    power: str = "continuous", device="cuda") -> float:
    """Energy per inference in joules, measured by replay.

    With ``stats``/``group`` this is a thin query over an already-replayed
    design sweep (``fleet_sweep(plan=PlanSet, reduce="stats")``): the mean
    live cycles of that candidate's statistics group.  Without them it
    builds the network's plan and replays one lane under ``power`` -- with
    no charge jitter, on the closed-form scan (a ``PlanSet`` sweep replays
    charge-wise, over nominal charges) -- replacing the old closed-form
    MACs x cycles-per-MAC estimate (``CYCLES_PER_MAC`` remains exported
    for coarse pre-sweep screens).  The replay runs on ``device``."""
    resolve_device(device)
    if stats is not None:
        if group is None:
            raise ValueError("estimate_energy(stats=...) needs group=")
        live = float(np.asarray(stats.mean("live_cycles"))[group])
        return live * JOULES_PER_CYCLE
    from ..core.fleetsim import build_plan, replay_plans
    x = np.zeros(net.input_shape, np.float32)
    plan = build_plan(net, x, runtime, power)
    return replay_plans([plan], device=device)[0].live_cycles \
        * JOULES_PER_CYCLE


def sweep(net: SimNet, data: Dataset, app: AppModel, positive: int = 0,
          runtime: str = "tails", epochs: int = 4, max_configs: int = 36,
          seed: int = 0, power: str = "1mF", n_devices: int = 32, *,
          device="cuda") -> list[ConfigResult]:
    """Evaluate a grid of per-layer compression configs (with retraining).

    Every candidate's plan is built once into a :class:`PlanSet` and the
    whole grid is priced by ONE ``fleet_sweep`` replay (Plan IR v2): each
    candidate gets ``n_devices`` jittered lanes on ``power``, and its
    energy/completion/latency come from its per-plan statistics group --
    no per-candidate re-extraction or recompile.  Training and pricing
    run on ``device``."""
    resolve_device(device)
    from ..core.fleetsim import PlanSet, build_plan, fleet_sweep
    from .train_small import class_rates, train

    grids = [layer_choices(l) for l in net.layers]
    combos = list(itertools.product(*grids))
    # Deterministic subsample: always keep the uncompressed config plus an
    # even spread of the rest.
    rng = np.random.default_rng(seed)
    base = tuple(LayerChoice("keep") for _ in net.layers)
    combos = [c for c in combos if c != base]
    rng.shuffle(combos)
    combos = [base] + combos[:max_configs - 1]

    x = np.asarray(data.x_test[0], np.float32)
    results, plans = [], []
    for choices in combos:
        cnet = apply_config(net, choices)
        trained, acc = train(cnet, data, epochs=epochs, seed=seed,
                             device=device)
        tp, tn = class_rates(trained, data, positive, device=device)
        pb = trained.params_bytes()
        feasible = pb <= DEVICE_WEIGHT_BYTES
        results.append(ConfigResult(
            choices, trained.total_params(), pb, trained.total_macs(),
            acc, tp, tn, 0.0, feasible, net=trained))
        plans.append(build_plan(trained, x, runtime, power))

    ps = PlanSet.from_plans(
        plans, labels=tuple(f"cfg{i}" for i in range(len(plans))))
    stats = fleet_sweep(plan=ps, n_devices=n_devices, seed=seed,
                        reduce="stats", device=device)
    completion = np.asarray(stats.completion_rate)
    live = np.asarray(stats.mean("live_cycles"))
    total_s = np.asarray(stats.mean("total_s"))
    for g, r in enumerate(results):
        r.completion = float(completion[g])
        r.latency_s = float(total_s[g])
        r.e_infer_j = (float(live[g]) * JOULES_PER_CYCLE
                       if r.completion > 0 else float("inf"))
        m = AppModel(app.p, app.e_sense, app.e_comm, r.e_infer_j)
        r.impj = (m.inference(r.tp, r.tn)
                  if r.feasible and r.completion > 0 else 0.0)
    return results


def pareto_frontier(results) -> list[ConfigResult]:
    """Non-dominated set over (accuracy up, energy down); candidates that
    never complete under intermittent power (completion 0) are off the
    frontier by definition."""
    pts = sorted((r for r in results
                  if getattr(r, "completion", 1.0) > 0),
                 key=lambda r: r.e_infer_j)
    out = []
    best = -1.0
    for r in pts:
        if r.accuracy > best:
            out.append(r)
            best = r.accuracy
    return out


def select(results) -> ConfigResult:
    """The feasible configuration maximizing modeled IMpJ (Fig. 5)."""
    feas = [r for r in results if r.feasible]
    if not feas:
        raise RuntimeError("no feasible configuration fits device memory")
    return max(feas, key=lambda r: r.impj)
