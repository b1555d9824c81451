"""End-to-end application performance model (Sec. 3, Eqs. 1-4).

IMpJ = "interesting messages per Joule" of harvested energy.  Communication
dominates the energy budget of an energy-harvesting sensor, so local
inference that filters uninteresting readings improves end-to-end performance
by up to 1/p; the realized gain collapses as inference accuracy drops.
GENESIS maximizes this quantity when choosing a compressed network.

A copy of the JAX package's ``repro/core/imp.py`` (plain Python): the
port imports nothing of that package.
"""

from __future__ import annotations

from dataclasses import dataclass, replace


@dataclass(frozen=True)
class AppModel:
    """Parameters of Table 1."""

    p: float            # base rate of interesting events
    e_sense: float      # J per sensor reading
    e_comm: float       # J per communicated reading
    e_infer: float = 0  # J per inference

    # -- Eq. 1: communicate everything ----------------------------------
    def baseline(self) -> float:
        return self.p / (self.e_sense + self.e_comm)

    # -- Eq. 2: free, perfect filtering ----------------------------------
    def ideal(self) -> float:
        return self.p / (self.e_sense + self.p * self.e_comm)

    # -- Eq. 3: perfect filtering at cost e_infer -------------------------
    def oracle(self) -> float:
        return self.p / (self.e_sense + self.e_infer + self.p * self.e_comm)

    # -- Eq. 4: realistic inference with (tp, tn) -------------------------
    def inference(self, tp: float, tn: float) -> float:
        sent = self.p * tp + (1.0 - self.p) * (1.0 - tn)
        return (self.p * tp) / (self.e_sense + self.e_infer + sent * self.e_comm)

    def with_result_only_comm(self, shrink: float = 98.0) -> "AppModel":
        """Send only the inference *result* (Fig. 2): e_comm /= shrink."""
        return replace(self, e_comm=self.e_comm / shrink)


#: Sec. 3.2 case study: wildlife monitoring over OpenChirp.
WILDLIFE = AppModel(p=0.05, e_sense=10e-3, e_comm=23_000e-3, e_infer=40e-3)


def accuracy_sweep(model: AppModel, accuracies) -> dict[str, list[float]]:
    """Fig. 1 / Fig. 2 curves: tp == tn == accuracy."""
    return {
        "accuracy": list(accuracies),
        "baseline": [model.baseline() for _ in accuracies],
        "ideal": [model.ideal() for _ in accuracies],
        "oracle": [model.oracle() for _ in accuracies],
        "inference": [model.inference(a, a) for a in accuracies],
    }
