"""Time the lane kernel on the fleet replay's headline run from a tree.

    python3 tools/time_main_replay.py [TREE]

TREE (default: this checkout) is the root of a checkout of the repo, for
example another commit unpacked with ``git archive`` into a directory that
``.gitignore`` lists; its ``src/repro_torch`` is imported and its kernel
built.  The run is ``chip_smoke.py``'s first full-width one (``mnist_net()``
under tails/1mF adaptive, 16,384 lanes, seed 42, charge cv 0.25, 64
recharges): the lane kernel's launch is captured and relaunched 7 times
between CUDA events after a warm-up, and one JSON line gives the median
and every time in ms.  Two trees compare only within one run on one card,
in turns (parent, change, change, parent).
"""

import json
import sys
from pathlib import Path


def main() -> int:
    root = Path(sys.argv[1] if len(sys.argv) > 1
                else Path(__file__).resolve().parents[1]).resolve()
    sys.path.insert(0, str(root / "src"))
    import numpy as np
    import torch

    from repro_torch.core import fleetsim
    from repro_torch.kernels import charge_replay as cr
    from repro_torch.models.dnn import mnist_net

    if not torch.cuda.is_available():
        print("time_main_replay: no CUDA card is visible", file=sys.stderr)
        return 2
    x = np.random.default_rng(42).normal(size=(1, 28, 28)).astype(
        np.float32)
    plan = fleetsim.build_plan(mnist_net(), x, "tails", "1mF")
    calls = []
    wrapper = cr.charge_replay

    def record(*a, **k):
        calls.append((a, k))
        return wrapper(*a, **k)

    cr.charge_replay = record
    fleetsim.fleet_sweep(plan=plan, n_devices=16384, seed=42, charge_cv=0.25,
                         trace_reboots=64, policy="adaptive", theta=0.5,
                         batch_rows=4, belief_alpha=0.2, device="cuda")
    cr.charge_replay = wrapper
    torch.cuda.synchronize()
    a, k = calls[0]
    wrapper(*a, **k)
    torch.cuda.synchronize()
    times = []
    for _ in range(7):
        ev0 = torch.cuda.Event(enable_timing=True)
        ev1 = torch.cuda.Event(enable_timing=True)
        ev0.record()
        wrapper(*a, **k)
        ev1.record()
        torch.cuda.synchronize()
        times.append(ev0.elapsed_time(ev1))
    print(json.dumps({"tree": str(root), "ms_median": sorted(times)[3],
                      "ms": times}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
