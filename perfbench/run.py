"""Run one cell of the port's benchmark once.

    python3 perfbench/run.py --workload <cell> --seed <n> --seconds <s> \
        --trace <0|1>

From the root of a checkout that holds ``BENCHMARK.json``, ``perfbench/``
and ``src/repro_torch``, on a machine with the CUDA cards the cell asks
for.  The last line of standard output is the result (one JSON object);
the numbers the correctness check compared, each beside its limit, are the
last lines of standard error.
"""

import time

T_START = time.perf_counter()          # set-up is timed from here

import sys                              # noqa: E402
from pathlib import Path                # noqa: E402

sys.path.insert(0, str(Path(__file__).resolve().parent))

from benchcore.core import main        # noqa: E402

if __name__ == "__main__":
    sys.exit(main(sys.argv[1:], T_START))
