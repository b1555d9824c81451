"""Read the correctness check's control for one cell on some seeds.

    python3 perfbench/control.py --workload <cell> --seed <n> [<n> ...]

Prints one JSON line a seed: the ``lanes`` gap of the reference computed
in float32 in the program's place, beside the cell's limit; exits 1 if a
seed's control would pass the check.  See ``fleetbench/control.py``.
"""

import sys
from pathlib import Path

sys.path.insert(0, str(Path(__file__).resolve().parent))

from fleetbench.control import main  # noqa: E402

if __name__ == "__main__":
    sys.exit(main())
