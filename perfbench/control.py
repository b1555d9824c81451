"""Read the correctness check's control for one cell on some seeds.

    python3 perfbench/control.py --workload <cell> --seed <n> [<n> ...]

Prints one JSON line a seed: for a fleet cell the ``lanes`` gap of the
reference computed in float32 in the program's place, beside the cell's
limit (``fleetbench/control.py``); for a language-model cell the program's
numbers and those of the reference with every layer's output in float8
(``lmbench/control.py``).  Exits 1 if a seed's control would pass the
check.
"""

import sys
from pathlib import Path

sys.path.insert(0, str(Path(__file__).resolve().parent))

from benchcore.core import control_main as main  # noqa: E402

if __name__ == "__main__":
    sys.exit(main())
